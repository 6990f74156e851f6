"""FAST-9/16 corner detection, vectorised over every pixel.

Port of `tpu3drec/ops/fast.py`. The segment test — at least 9 contiguous
pixels of the 16-pixel Bresenham circle all brighter or all darker than
the center by a threshold — is evaluated for every pixel at once from 16
shifted views of the image. The reference shifts with wrap-around
(`jnp.roll`) and then zeroes a 3 px border; the port does both, so no
border pixel gets a corner from the opposite edge. The contiguity test
packs the 16 flags of a pixel into the bits of an integer, doubles it to
32 bits for the wrap of the circle, and ANDs 9 shifts of it: the same
predicate as the reference's 16 x 9 boolean ANDs, in 10 passes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu3drec_torch.ops.harris import nms_2d, select_top_k

# Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx)
FAST_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _circle_stack(img: torch.Tensor) -> torch.Tensor:
    """(16, ..., H, W): the circle pixel values around every center,
    wrapping at the borders."""
    return torch.stack([torch.roll(img, (-dy, -dx), dims=(-2, -1))
                        for dy, dx in FAST_CIRCLE])


def _has_arc(flags: torch.Tensor, arc: int) -> torch.Tensor:
    """(16, ...) bool -> (...) bool: some `arc` circularly consecutive
    flags are all set."""
    weights = (1 << torch.arange(16, dtype=torch.int32,
                                 device=flags.device))
    weights = weights.reshape((16,) + (1,) * (flags.ndim - 1))
    bits = (flags.to(torch.int32) * weights).sum(0, dtype=torch.int32)
    ring = bits | (bits << 16)       # bit s + 16 repeats bit s
    run = ring
    for k in range(1, arc):
        run = run & (ring >> k)      # bit s: flags s .. s+k all set
    return (run & 0xFFFF) != 0


def fast_score_map(img: torch.Tensor, threshold: float = 0.08,
                   arc: int = 9) -> torch.Tensor:
    """`(..., H, W)` FAST corner response; 0 where the segment test fails.

    threshold is in [0,1] intensity units (cv2's 20/255 ~ 0.078).
    Score = sum of |circle - center| - t over the qualifying circle
    pixels (brighter or darker), cv2's score adapted to float images.
    """
    c = _circle_stack(img)                               # (16, ..., H, W)
    brighter = c > img[None] + threshold
    darker = c < img[None] - threshold
    is_corner = _has_arc(brighter, arc) | _has_arc(darker, arc)
    diff = torch.abs(c - img[None]) - threshold
    score = (torch.clamp(diff, min=0.0) * (brighter | darker)).sum(0)
    # invalidate the 3 px border where the circle wraps around
    h, w = img.shape[-2:]
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return torch.where(is_corner & interior, score, torch.zeros_like(score))


def detect_fast(img: torch.Tensor, max_features: int,
                threshold: float = 0.08, nms_radius: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FAST + NMS + top-K: returns xy (..., K, 2), score (..., K), mask
    (..., K)."""
    score = fast_score_map(img, threshold)
    peaks = nms_2d(score, nms_radius) & (score > 0)
    return select_top_k(score, peaks, max_features)
