"""Progressive-learning intrinsics estimation.

Port of `tpu3drec/sfm/intrinsics.py` (numpy only, copied so that the
port never imports the JAX package): with no calibrated cameras the focal
comes from a resolution/aspect FOV heuristic; as cameras are
reconstructed their learned focal *ratios* (f / max_dim) feed back into
estimates for new views, keeping a bounded pattern database.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class CameraPattern:
    width: int
    height: int
    focal_ratio: float       # focal / max(width, height)
    source: str = "learned"


def heuristic_K(width: int, height: int,
                focal_factor: float = 1.2) -> np.ndarray:
    """f = 1.2 * width, principal point at the centre."""
    f = focal_factor * width
    return np.array([[f, 0, width / 2.0],
                     [0, f, height / 2.0],
                     [0, 0, 1.0]], np.float64)


def fov_heuristic_ratio(width: int, height: int) -> float:
    """Camera-type FOV heuristic: phone-ish wide FOV for small/landscape
    images, DSLR-ish for large, panoramic for extreme aspect ratios.
    Returns focal / max_dim."""
    aspect = width / max(height, 1)
    if aspect > 2.5 or aspect < 0.4:
        return 0.7          # panoramic
    mp = width * height / 1e6
    if mp < 1.5:
        return 0.85         # phone/compact, wide FOV
    if mp < 8:
        return 1.0
    return 1.2              # DSLR-ish, narrower FOV


class ProgressiveIntrinsicsEstimator:
    """Blends the FOV heuristic with the focal ratios of reconstructed
    cameras."""

    MAX_PATTERNS = 50

    def __init__(self):
        self.patterns: List[CameraPattern] = []

    def learn(self, K: np.ndarray, width: int, height: int,
              source: str = "learned") -> None:
        """Record a reconstructed camera's focal ratio."""
        f = 0.5 * (K[0, 0] + K[1, 1])
        ratio = f / max(width, height, 1)
        if not (0.2 < ratio < 5.0):
            return
        self.patterns.append(CameraPattern(width, height, ratio, source))
        if len(self.patterns) > self.MAX_PATTERNS:
            self.patterns.pop(0)

    def estimate(self, width: int, height: int) -> np.ndarray:
        """Blend the heuristic with learned ratios, weighting
        same-resolution patterns highest."""
        base_ratio = fov_heuristic_ratio(width, height)
        if not self.patterns:
            ratio = base_ratio
        else:
            weights, ratios = [], []
            for p in self.patterns:
                res_sim = np.exp(-abs(np.log((p.width * p.height)
                                             / max(width * height, 1))))
                asp_sim = np.exp(-abs(np.log((p.width / max(p.height, 1))
                                             / (width / max(height, 1)))))
                weights.append(res_sim * asp_sim)
                ratios.append(p.focal_ratio)
            w = np.asarray(weights)
            learned = float(np.sum(w * np.asarray(ratios)) / max(w.sum(), 1e-9))
            # few cameras -> trust the heuristic more
            alpha = min(len(self.patterns) / 5.0, 1.0) * 0.8
            ratio = (1 - alpha) * base_ratio + alpha * learned
        f = ratio * max(width, height)
        return np.array([[f, 0, width / 2.0],
                         [0, f, height / 2.0],
                         [0, 0, 1.0]], np.float64)

    @property
    def num_learned(self) -> int:
        return len(self.patterns)
