"""Multi-method detector facade.

Port of `tpu3drec/multi_method.py`: runs N configured detectors over one
image -> {method: Features}, with per-method params. As the reference, a
method the registry does not hold (a deep detector without weights) is
skipped and listed in `skipped`; a deep detector whose weights are on
disk raises `NotImplementedError` until the deep models are ported (see
`api.check_detector`). A method that fails on an image yields empty
Features, except on `RuntimeError`, a kernel or CUDA fault, which
propagates.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from tpu3drec_torch.core.device import resolve_device
from tpu3drec_torch.core.types import Features


class MultiMethodFeatureDetector:
    """Several detectors over one image, on `device` (None means CUDA)."""

    def __init__(self, methods: Sequence[str] = ("SIFT",),
                 max_features: int = 2048,
                 detector_params: Optional[Dict[str, Dict]] = None,
                 device=None):
        from tpu3drec_torch.api import _get_detector_registry, check_detector
        registry = _get_detector_registry()
        self.methods: List[str] = []
        self.skipped: List[str] = []
        for m in methods:
            check_detector(m)
            (self.methods if m in registry else self.skipped).append(m)
        self.max_features = max_features
        self.detector_params = detector_params or {}
        self.device = resolve_device(device)

    def detect_all(self, image) -> Dict[str, Features]:
        """Every method's Features; a method that fails yields empty
        Features."""
        from tpu3drec_torch.api import detect_features
        out: Dict[str, Features] = {}
        for m in self.methods:
            try:
                out[m] = detect_features(
                    image, m, max_features=self.max_features,
                    device=self.device, **self.detector_params.get(m, {}))
            except RuntimeError:
                raise          # a kernel or CUDA fault surfaces
            except Exception:  # noqa: BLE001 - per-detector fault tolerance
                out[m] = Features.empty(1, 1, method=m, device=self.device)
        return out

    def detect(self, image, method: Optional[str] = None) -> Features:
        from tpu3drec_torch.api import detect_features
        m = method or self.methods[0]
        return detect_features(image, m, max_features=self.max_features,
                               device=self.device,
                               **self.detector_params.get(m, {}))


def create_multi_detector(methods: Sequence[str] = ("SIFT", "ORB"),
                          max_features: int = 2048, device=None,
                          **params) -> MultiMethodFeatureDetector:
    """A MultiMethodFeatureDetector; `params` maps a method to its
    detector parameters."""
    return MultiMethodFeatureDetector(methods, max_features, params or None,
                                      device=device)
