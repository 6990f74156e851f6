"""tpu3drec_torch — the PyTorch/CUDA port of tpu3drec for NVIDIA Hopper.

A second package beside the JAX reference `tpu3drec`: the same
mask-padded data model and config presets, the SIFT pair step (detect ->
int8 2-NN ratio match -> homography RANSAC), ORB, the folder matching
pipeline (`create_pipeline`, `quick_process_folder`) and the folder chain
from images to a mesh (`reconstruct_folder`), the SfM geometry and bundle adjustment
(5-point / 8-point essential RANSAC -> pose -> triangulation -> PnP ->
Schur LM, `iterative_refinement`), the incremental SfM pipeline
(`SfMPipeline`, `reconstruct_scene`: matches -> `Reconstruction` and its
exports) and the dense stage (rectify -> SGM
stereo -> depth fusion -> point cloud -> TSDF mesh,
`run_dense_reconstruction`) and the multi-card paths on
`torch.distributed` (`tpu3drec_torch.parallel`: one process a card), with the reference's Pallas TPU kernels rewritten as hand-written CUDA
C++ kernels for sm_90a (`csrc/`). Every kernel has a plain PyTorch version of the same function
beside it; a wrapper runs the plain version only for CPU tensors and
launches the kernel (or raises) for CUDA tensors.

Device policy: entry points that take numpy images take `device=None`,
which means "cuda"; without CUDA they raise unless the caller passes
`device="cpu"`. Functions that take tensors run on the tensors' device.

Precision policy: float32 matrix products run at full float32. TF32 is
switched off on import — the counterpart of the reference's
`jax_default_matmul_precision=highest` — because the DoG contrast gate
(~0.013) and the homography solvers need every f32 bit.

This package imports torch, numpy and the standard library only; it never
imports jax or the JAX package.
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from tpu3drec_torch.core.device import resolve_device  # noqa: E402
from tpu3drec_torch.core.config import (  # noqa: E402
    DEFAULT_CONFIG,
    PRESET_CONFIGS,
    create_config_from_preset,
    load_config,
    merge_configs,
    save_config,
    validate_config,
)
from tpu3drec_torch.core.types import (  # noqa: E402
    DescriptorKind,
    Features,
    Matches,
    MatchingResult,
    MethodResult,
    ScoreType,
)
from tpu3drec_torch.api import (  # noqa: E402
    create_pipeline,
    detect_features,
    match_images,
    prepare_image,
    quick_match,
    quick_process_folder,
    reconstruct_folder,
)
from tpu3drec_torch.ops.ba import BAConfig, BAProblem, bundle_adjust  # noqa: E402
from tpu3drec_torch.ops.epipolar import find_essential, recover_pose  # noqa: E402
from tpu3drec_torch.ops.pnp import solve_pnp_ransac  # noqa: E402
from tpu3drec_torch.ops.triangulate import triangulate_two_view  # noqa: E402
from tpu3drec_torch.pair_step import make_pair_fn  # noqa: E402
from tpu3drec_torch.pipelines.dense import (  # noqa: E402
    DenseReconstructionPipeline,
    run_dense_reconstruction,
)
from tpu3drec_torch.pipelines.matching import (  # noqa: E402
    FeatureProcessingPipeline,
)
from tpu3drec_torch.sfm import (  # noqa: E402
    Camera,
    Reconstruction,
    SfMConfig,
    SfMPipeline,
    assess_reconstruction_quality,
    reconstruct_scene,
)
from tpu3drec_torch.sfm.refinement import iterative_refinement  # noqa: E402

__all__ = [
    "BAConfig",
    "BAProblem",
    "Camera",
    "DEFAULT_CONFIG",
    "DenseReconstructionPipeline",
    "DescriptorKind",
    "FeatureProcessingPipeline",
    "Features",
    "Matches",
    "MatchingResult",
    "MethodResult",
    "PRESET_CONFIGS",
    "Reconstruction",
    "ScoreType",
    "SfMConfig",
    "SfMPipeline",
    "assess_reconstruction_quality",
    "bundle_adjust",
    "create_config_from_preset",
    "create_pipeline",
    "detect_features",
    "find_essential",
    "iterative_refinement",
    "load_config",
    "make_pair_fn",
    "match_images",
    "merge_configs",
    "prepare_image",
    "quick_match",
    "quick_process_folder",
    "reconstruct_folder",
    "reconstruct_scene",
    "recover_pose",
    "resolve_device",
    "run_dense_reconstruction",
    "save_config",
    "solve_pnp_ransac",
    "triangulate_two_view",
    "validate_config",
]
