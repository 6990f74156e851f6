"""tpu3drec_torch — the PyTorch/CUDA port of tpu3drec for NVIDIA Hopper.

A second package beside the JAX reference `tpu3drec`: the same
mask-padded data model, the SIFT pair step (detect -> int8 2-NN ratio
match -> homography RANSAC), the SfM geometry and bundle adjustment
(5-point / 8-point essential RANSAC -> pose -> triangulation -> PnP ->
Schur LM, `iterative_refinement`) and the dense stage (rectify -> SGM
stereo -> depth fusion -> point cloud -> TSDF mesh,
`run_dense_reconstruction`), with the reference's Pallas TPU kernels rewritten as hand-written CUDA
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
from tpu3drec_torch.core.types import (  # noqa: E402
    DescriptorKind,
    Features,
    Matches,
    MethodResult,
    ScoreType,
)
from tpu3drec_torch.api import (  # noqa: E402
    detect_features,
    match_images,
    prepare_image,
    quick_match,
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
from tpu3drec_torch.sfm.refinement import iterative_refinement  # noqa: E402

__all__ = [
    "BAConfig",
    "BAProblem",
    "DenseReconstructionPipeline",
    "DescriptorKind",
    "Features",
    "Matches",
    "MethodResult",
    "ScoreType",
    "bundle_adjust",
    "detect_features",
    "find_essential",
    "iterative_refinement",
    "make_pair_fn",
    "match_images",
    "prepare_image",
    "quick_match",
    "recover_pose",
    "resolve_device",
    "run_dense_reconstruction",
    "solve_pnp_ransac",
    "triangulate_two_view",
]
