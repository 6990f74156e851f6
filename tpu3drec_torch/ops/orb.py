"""ORB: FAST pyramid + Harris ranking + intensity-centroid orientation +
steered BRIEF binary descriptors, batched over `(B, H, W)` images.

Port of `tpu3drec/ops/orb.py`. Two sampling patterns (`pattern=`):
- "brief" (default): 256 pairs from the isotropic Gaussian sampling of
  the original BRIEF paper, drawn from the reference's fixed seed, so
  both packages describe with the same table;
- "opencv": OpenCV's learned bit pattern (`_orb_pattern_cv.py`) with its
  sigma-2 smoothing, so descriptors interoperate with cv2 ORB
  (`unpack_cv2_orb` converts cv2's packed rows to the +-1 layout).
Descriptors are stored as +-1 floats, so Hamming distance is a dot
product (`ops/match.py`, metric `hamming_pm1`).

Per level: JAX's antialiased linear resize of the level-0 image (never
`F.interpolate`, which weighs differently), FAST-9 -> 3x3 NMS -> Harris
re-ranking of the survivors -> per-level top-K -> orientation from the
31x31 intensity-centroid moments -> rotated pair sampling. Every top-K
orders ties by index, as `lax.top_k` does. A bit is a comparison of two
samples, so a last-ulp difference in the moments, `atan2` or a sample
can flip it: parity with the reference is an agreement share.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu3drec_torch.core.types import DescriptorKind, Features
from tpu3drec_torch.ops.fast import fast_score_map
from tpu3drec_torch.ops.harris import (
    harris_response, merge_top_k, nms_2d, select_top_k,
)
from tpu3drec_torch.ops.image import gaussian_blur, resize
from tpu3drec_torch.ops.sift import _bilinear_many

DESC_BITS = 256
PATCH_R = 15  # orientation / descriptor patch radius (cv2: 31x31 patch)

# Fixed BRIEF sampling pattern: pairs ~ N(0, (PATCH_R/2)^2), seeded as the
# reference seeds it (the pattern is part of the descriptor format)
_rng = np.random.default_rng(20120916)
BRIEF_PAIRS = np.clip(_rng.normal(0.0, PATCH_R / 2.0, size=(DESC_BITS, 4)),
                      -PATCH_R, PATCH_R).astype(np.float32)
del _rng


def _pattern_table(pattern: str) -> np.ndarray:
    if pattern == "opencv":
        from tpu3drec_torch.ops._orb_pattern_cv import BIT_PATTERN_31
        return BIT_PATTERN_31
    return BRIEF_PAIRS


def unpack_cv2_orb(desc_u8: np.ndarray) -> np.ndarray:
    """cv2 ORB descriptors (N, 32) uint8 -> (N, 256) +-1 float32 (bit k =
    byte k//8, bit k%8; a set bit is +1, the `I(p1) < I(p2)` convention
    both sides share)."""
    d = np.asarray(desc_u8, np.uint8)
    bits = np.unpackbits(d, axis=1, bitorder="little")
    return bits.astype(np.float32) * 2.0 - 1.0


def _centroid_kernels() -> np.ndarray:
    """(2, 1, 31, 31) circular-masked x- and y-moment kernels."""
    r = PATCH_R
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    mask = (xs ** 2 + ys ** 2) <= r * r
    return np.stack([xs * mask, ys * mask]).astype(np.float32)[:, None]


_MOMENT_KERNELS = _centroid_kernels()


def _moment_maps(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """m10, m01 maps of `(B, H, W)` by one 2-channel 31x31 correlation,
    zero-padded to the input size."""
    w = torch.from_numpy(_MOMENT_KERNELS).to(img.device)
    y = F.conv2d(img[:, None], w, padding=PATCH_R)
    return y[:, 0], y[:, 1]


def _describe(img: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor,
              pairs: np.ndarray) -> torch.Tensor:
    """Steered BRIEF of `(B, K)` keypoints: (B, K, 256) +-1 floats."""
    p = torch.from_numpy(pairs).to(img.device)
    ca, sa = torch.cos(angle)[..., None], torch.sin(angle)[..., None]

    def sample(px, py):
        rx = ca * px - sa * py
        ry = sa * px + ca * py
        return _bilinear_many(img, xy[..., 0:1] + rx, xy[..., 1:2] + ry)

    va = sample(p[:, 0], p[:, 1])
    vb = sample(p[:, 2], p[:, 3])
    return torch.where(va < vb, 1.0, -1.0)


def level_shapes(h0: int, w0: int, n_levels: int, scale_factor: float):
    """(h, w) of each pyramid level, as the reference sizes them."""
    out = []
    for level in range(n_levels):
        s = scale_factor ** level
        out.append((max(int(round(h0 / s)), 16), max(int(round(w0 / s)), 16)))
    return out


def detect_and_compute(imgs: torch.Tensor, max_features: int = 2048,
                       n_levels: int = 8, scale_factor: float = 1.2,
                       fast_threshold: float = 20.0 / 255.0,
                       harris_k: float = 0.04, pattern: str = "brief"):
    """ORB of `(B, H, W)` (or one `(H, W)`) float32 images in [0, 1]:
    (xy, response, scale, angle, desc, mask) with capacity `max_features`
    per image."""
    single = imgs.ndim == 2
    if single:
        imgs = imgs[None]
    pairs = _pattern_table(pattern)
    # cv2 smooths with a 7x7 sigma-2 Gaussian before sampling; the interop
    # pattern does the same
    desc_sigma = 2.0 if pattern == "opencv" else 1.0
    # the reference passes the factor as an integer of thousandths
    scale_factor = int(round(scale_factor * 1000)) / 1000.0
    B, h0, w0 = imgs.shape
    parts = []
    # per-level budget ~ proportional to area (cv2's allocation)
    areas = [1.0 / (scale_factor ** (2 * l)) for l in range(n_levels)]
    total_area = sum(areas)
    shapes = level_shapes(h0, w0, n_levels, scale_factor)
    for level, (h, w) in enumerate(shapes):
        s = scale_factor ** level
        im = imgs if level == 0 else resize(imgs, (h, w))
        blur = gaussian_blur(im, desc_sigma)
        score = fast_score_map(im, fast_threshold)
        peaks = nms_2d(score, 1) & (score > 0)
        # Harris re-ranking of the FAST survivors (cv2 HARRIS_SCORE)
        harris = harris_response(im, block_size=7, k=harris_k)
        rank = torch.where(peaks, harris, torch.full_like(harris, -math.inf))
        k_level = max(int(max_features * areas[level] / total_area), 32)
        k_level = min(k_level, h * w)
        xy, resp, mask = select_top_k(rank, peaks, k_level)
        # orientation by intensity centroid
        m10, m01 = _moment_maps(blur)
        xi = torch.clamp(xy[..., 0].to(torch.int64), 0, w - 1)
        yi = torch.clamp(xy[..., 1].to(torch.int64), 0, h - 1)
        at = yi * w + xi
        angle = torch.atan2(m01.reshape(B, -1).gather(1, at),
                            m10.reshape(B, -1).gather(1, at))
        desc = _describe(blur, xy, angle, pairs)
        parts.append(dict(
            xy=xy * s,
            response=torch.where(mask, resp, torch.full_like(resp, -math.inf)),
            scale=torch.full((B, k_level), 31.0 * s, dtype=torch.float32,
                             device=imgs.device),
            angle=angle,
            desc=desc,
            mask=mask,
        ))
    # per-level budgets can sum below max_features (int truncation, tiny
    # images): the merge pads back to the capacity
    return merge_top_k(parts, max_features, single)


def detect_orb_features(img: torch.Tensor, max_features: int = 2048,
                        n_levels: int = 8, scale_factor: float = 1.2,
                        fast_threshold: float = 20.0 / 255.0,
                        harris_k: float = 0.04,
                        pattern: str = "brief",
                        method: str = "ORB", **_unused) -> Features:
    """Detector contract on one `(H, W)` image or a `(B, H, W)` batch:
    cv2.ORB defaults (n_levels=8, scale=1.2, fast_threshold=20 -> 0.078
    in [0,1] units)."""
    if fast_threshold > 1.0:  # accept cv2-style 0-255 thresholds
        fast_threshold = fast_threshold / 255.0
    xy, resp, scale, angle, desc, mask = detect_and_compute(
        img, max_features, n_levels, scale_factor, fast_threshold, harris_k,
        pattern)
    return Features(xy=xy, response=resp, scale=scale, angle=angle,
                    desc=desc, mask=mask, method=method,
                    desc_kind=DescriptorKind.BINARY.value,
                    image_shape=tuple(img.shape[-2:]))
