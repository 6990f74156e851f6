"""BRISK: multi-scale FAST + concentric-ring binary descriptor, batched
over `(B, H, W)` images.

Port of `tpu3drec/ops/brisk.py`. Per octave: JAX's linear resize of the
input (never `F.interpolate`), FAST-9 -> 3x3 NMS -> per-octave top-K;
orientation from the long pairs' gradient sum (BRISK paper eq. 3) on the
sigma-1.2 blur; 512 short-pair comparisons on the rotated pattern. The
pattern and its pair tables are frozen data (`_brisk_pattern.py`), so the
descriptor format does not depend on the host's sort. Descriptors are
stored +-1, so Hamming distance is a dot product (`hamming_pm1`). Every
top-K orders ties by index, as `lax.top_k` does. A bit compares two
samples, so a last-ulp difference can flip it: parity with the
reference is an agreement share.
"""

from __future__ import annotations

import math

import torch

from tpu3drec_torch.core.types import DescriptorKind, Features
from tpu3drec_torch.ops._brisk_pattern import LONG_PAIRS, PATTERN, SHORT_PAIRS
from tpu3drec_torch.ops.fast import fast_score_map
from tpu3drec_torch.ops.harris import merge_top_k, nms_2d, select_top_k
from tpu3drec_torch.ops.image import gaussian_blur, resize
from tpu3drec_torch.ops.sift import _bilinear_many

_LONG_DXY = PATTERN[LONG_PAIRS[:, 0]] - PATTERN[LONG_PAIRS[:, 1]]   # (256, 2)


def _sample_pattern(img: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """(B, K, 60) intensities of `(B, H, W)` at the rotated, scaled
    pattern points around `(B, K)` keypoints."""
    pat = torch.tensor(PATTERN, device=img.device)
    ca, sa = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    px = pat[:, 0] * scale[..., None]
    py = pat[:, 1] * scale[..., None]
    rx = ca * px - sa * py + xy[..., 0:1]
    ry = sa * px + ca * py + xy[..., 1:2]
    return _bilinear_many(img, rx, ry)


def level_shapes(h0: int, w0: int, octaves: int):
    """(h, w) of each octave, as the reference sizes them."""
    return [(max(int(h0 / 2.0 ** o), 16), max(int(w0 / 2.0 ** o), 16))
            for o in range(octaves)]


def detect_and_compute(imgs: torch.Tensor, max_features: int = 2048,
                       octaves: int = 3, threshold: float = 30.0 / 255.0):
    """BRISK of `(B, H, W)` (or one `(H, W)`) float32 images in [0, 1],
    FAST threshold in [0, 1] units: (xy, response, scale, angle, desc,
    mask) with capacity `max_features` per image."""
    single = imgs.ndim == 2
    if single:
        imgs = imgs[None]
    B, h0, w0 = imgs.shape
    dev = imgs.device
    dxy = torch.tensor(_LONG_DXY, device=dev)
    norm2 = torch.clamp((dxy * dxy).sum(1), min=1e-9)
    la, lb = (torch.tensor(LONG_PAIRS[:, i], device=dev).long() for i in (0, 1))
    sa, sb = (torch.tensor(SHORT_PAIRS[:, i], device=dev).long() for i in (0, 1))
    parts = []
    for o, (h, w) in enumerate(level_shapes(h0, w0, octaves)):
        s = 2.0 ** o
        im = imgs if o == 0 else resize(imgs, (h, w))
        blur = gaussian_blur(im, 1.2)
        score = fast_score_map(im, threshold)
        peaks = nms_2d(score, 1) & (score > 0)
        k_level = min(max(max_features // (2 ** o), 64), h * w)
        xy, resp, mask = select_top_k(score, peaks, k_level)

        # orientation from the long pairs: g = sum (I(a) - I(b)) (a - b)
        # / |a - b|^2 over the unrotated pattern. Row sums, not a matrix
        # product: their order does not change with the batch's size, so
        # a batch gives each image the angles (and bits) it gets alone
        zeros = torch.zeros(B, k_level, device=dev)
        vals0 = _sample_pattern(blur, xy, zeros, torch.ones_like(zeros))
        gw = (vals0[..., la] - vals0[..., lb]) / norm2
        angle = torch.atan2((gw * dxy[:, 1]).sum(-1), (gw * dxy[:, 0]).sum(-1))

        vals = _sample_pattern(blur, xy, angle, torch.ones_like(zeros))
        bits = torch.where(vals[..., sa] < vals[..., sb], 1.0, -1.0)
        parts.append(dict(
            xy=xy * s,
            response=torch.where(mask, resp, torch.full_like(resp, -math.inf)),
            scale=torch.full((B, k_level), 12.0 * s, dtype=torch.float32,
                             device=dev),
            angle=angle, desc=bits, mask=mask))
    return merge_top_k(parts, max_features, single)


def detect_brisk_features(img: torch.Tensor, max_features: int = 2048,
                          threshold: float = 30.0, octaves: int = 3,
                          pattern_scale: float = 1.0,
                          method: str = "BRISK", **_unused) -> Features:
    """Detector contract on one `(H, W)` image or a `(B, H, W)` batch:
    cv2.BRISK defaults (threshold 30 in 0-255 units, 3 octaves); a
    threshold above 1 is read in 0-255 units."""
    thr = threshold / 255.0 if threshold > 1.0 else threshold
    xy, resp, scale, angle, desc, mask = detect_and_compute(
        img, max_features, octaves, thr)
    return Features(xy=xy, response=resp, scale=scale * pattern_scale,
                    angle=angle, desc=desc, mask=mask, method=method,
                    desc_kind=DescriptorKind.BINARY.value,
                    image_shape=tuple(img.shape[-2:]))
