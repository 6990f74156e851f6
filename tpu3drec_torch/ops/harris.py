"""Harris corner response, 2-D non-maximum suppression and top-K peak
selection: the helpers ORB ranks its FAST corners with.

Port of `tpu3drec/ops/harris.py:28-80`. Every function takes `(..., H, W)`
maps with any number of leading batch dimensions. The Harris and GFTT
detectors themselves are not ported yet (ROADMAP Queue 1 #4).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from tpu3drec_torch.ops.image import box_filter, sobel_gradients


def structure_tensor(img: torch.Tensor, block_size: int = 3
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dx, dy = sobel_gradients(img)
    sxx = box_filter(dx * dx, block_size)
    syy = box_filter(dy * dy, block_size)
    sxy = box_filter(dx * dy, block_size)
    return sxx, syy, sxy


def harris_response(img: torch.Tensor, block_size: int = 3,
                    k: float = 0.04) -> torch.Tensor:
    sxx, syy, sxy = structure_tensor(img, block_size)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def nms_2d(response: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """True where response is the max of its (2r+1)^2 neighbourhood (the
    reference's `reduce_window` max, padded with -inf, `SAME`)."""
    win = 2 * radius + 1
    lead = response.shape[:-2]
    x = response.reshape(-1, 1, *response.shape[-2:])
    pooled = F.max_pool2d(x, win, stride=1, padding=radius)
    return response >= pooled.reshape(*lead, *pooled.shape[-2:])


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` along the last axis: the k largest values, ties in
    index order (a stable descending sort; `torch.topk` promises no tie
    order). Like `lax.top_k`, it refuses a k above the axis's size."""
    if k > x.shape[-1]:
        raise ValueError(f"top_k: k={k} exceeds the axis size {x.shape[-1]}")
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_top_k(response: torch.Tensor, valid: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k peak locations of `(..., H, W)`: xy (..., k, 2) float32,
    response (..., k) (0 where invalid), mask (..., k)."""
    w = response.shape[-1]
    flat = torch.where(valid, response,
                       torch.full_like(response, -float("inf")))
    vals, idx = topk_stable(flat.flatten(-2), k)
    ys = (idx // w).to(torch.float32)
    xs = (idx % w).to(torch.float32)
    mask = vals > -float("inf")
    return (torch.stack([xs, ys], dim=-1),
            torch.where(mask, vals, torch.zeros_like(vals)), mask)
