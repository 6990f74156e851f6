"""Harris / Shi-Tomasi corner detection: structure tensor, response,
non-maximum suppression, a quality gate and top-K, with SIFT descriptors
at the corners.

Port of `tpu3drec/ops/harris.py` (cv2.goodFeaturesToTrack / cornerHarris).
Every function takes `(..., H, W)` maps with any number of leading batch
dimensions; the quality gate is taken per image. `nms_2d` and
`select_top_k` are also the peak pickers of ORB, BRISK and AKAZE. Every
top-K orders ties by index, as `lax.top_k` does (flat Shi-Tomasi regions
meet at exactly 0, so ties are common).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from tpu3drec_torch.core.types import DescriptorKind, Features
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


def shi_tomasi_response(img: torch.Tensor, block_size: int = 3) -> torch.Tensor:
    """Min eigenvalue of the 2x2 structure tensor (cv2 goodFeaturesToTrack)."""
    sxx, syy, sxy = structure_tensor(img, block_size)
    half_tr = 0.5 * (sxx + syy)
    disc = torch.sqrt(torch.clamp(0.25 * (sxx - syy) ** 2 + sxy * sxy,
                                  min=0.0))
    return half_tr - disc


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


def merge_top_k(parts, max_features: int, single: bool = False):
    """Per-level slot dicts (xy, response, scale, angle, desc, mask, each
    with a leading B) merged and cut to the global top `max_features` by
    response, ties by index; masked rows keep their gathered values with
    mask False and response 0. Levels that hold fewer slots than
    `max_features` are padded to it with empty rows. Returns the
    detector bundle (xy, response, scale, angle, desc, mask), without
    the B axis when `single`."""
    merged = {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}
    sc = torch.where(merged["mask"], merged["response"],
                     torch.full_like(merged["response"], -math.inf))
    top, order = topk_stable(sc, min(max_features, sc.shape[1]))
    out = {}
    for key, v in merged.items():
        ix = order.reshape(order.shape + (1,) * (v.ndim - 2))
        out[key] = v.gather(1, ix.expand(order.shape + v.shape[2:]))
    out["mask"] = out["mask"] & (top > -math.inf)
    pad = max_features - order.shape[1]
    if pad:
        out = {k: torch.cat([v, v.new_zeros((v.shape[0], pad) + v.shape[2:])],
                            dim=1) for k, v in out.items()}
    out["response"] = torch.where(out["mask"], out["response"],
                                  torch.zeros_like(out["response"]))
    res = (out["xy"], out["response"], out["scale"], out["angle"],
           out["desc"], out["mask"])
    return tuple(t[0] for t in res) if single else res


def detect_corners(img: torch.Tensor, max_features: int = 1000,
                   quality_level: float = 0.01, block_size: int = 3,
                   min_distance: int = 10, use_harris: bool = False,
                   k: float = 0.04):
    """goodFeaturesToTrack on `(..., H, W)`: returns (xy, response, mask).

    Peaks of the Harris or Shi-Tomasi response under a (2r+1)^2 NMS with
    r = max(1, min_distance // 2), at least quality_level times the
    image's largest response, and at least block_size px inside the
    border."""
    resp = harris_response(img, block_size, k) if use_harris \
        else shi_tomasi_response(img, block_size)
    radius = max(1, int(min_distance) // 2)
    peaks = nms_2d(resp, radius)
    gate = resp >= quality_level * resp.amax(dim=(-2, -1), keepdim=True)
    h, w = resp.shape[-2:]
    b = block_size
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    interior = (yy >= b) & (yy < h - b) & (xx >= b) & (xx < w - b)
    return select_top_k(resp, peaks & gate & interior, max_features)


def detect_harris_features(img: torch.Tensor, max_features: int = 1000,
                           quality_level: float = 0.01, block_size: int = 3,
                           min_distance: int = 10, use_harris: bool = True,
                           k: float = 0.04, desc_dim: int = 128,
                           method: str = "Harris") -> Features:
    """Corners of one `(H, W)` image or a `(B, H, W)` batch with SIFT
    descriptors at a fixed scale (`sift.describe_at_points`), as the
    reference pairs Harris / GFTT corners with SIFT descriptors."""
    from tpu3drec_torch.ops.sift import describe_at_points
    xy, resp, mask = detect_corners(img, max_features, quality_level,
                                    block_size, min_distance, use_harris, k)
    desc, angle = describe_at_points(img, xy, mask)
    return Features(
        xy=xy, response=resp,
        scale=torch.full(mask.shape, float(block_size * 2),
                         dtype=torch.float32, device=img.device),
        angle=angle, desc=desc, mask=mask,
        method=method, desc_kind=DescriptorKind.FLOAT.value,
        image_shape=tuple(img.shape[-2:]))
