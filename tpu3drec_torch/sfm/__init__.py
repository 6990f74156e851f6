"""Ported structure-from-motion modules: the incremental pipeline
(`pipeline`), its data layer (`reconstruction`, `correspondence`,
`pair_selector`, `intrinsics`, `quality`) and two-view iterative
refinement (`refinement`)."""

from tpu3drec_torch.sfm.reconstruction import Camera, Reconstruction
from tpu3drec_torch.sfm.pipeline import SfMConfig, SfMPipeline, reconstruct_scene
from tpu3drec_torch.sfm.quality import assess_reconstruction_quality

__all__ = ["Camera", "Reconstruction", "SfMConfig", "SfMPipeline",
           "assess_reconstruction_quality", "reconstruct_scene"]
