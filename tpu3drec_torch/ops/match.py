"""Descriptor matching: exact 2-NN through the `knn2` kernel, Lowe's ratio
test and the mutual cross-check.

Port of `tpu3drec/ops/match.py`. Every function takes one descriptor set
`(N, D)` or a batch `(B, N, D)`. The metrics are the reference's:

- `l2_int8`: descriptors rounded to cv2's 0..255 scale and shifted by
  -128 to int8; squared distances are exact integers.
- `hamming_pm1`: +-1 bit encodings as int8; bit-flip counts are exact.
- `l2`: float32 Euclidean.

The kernel returns the raw top-2 (`pallas_match.knn2_raw`); the |a|^2
add-back and the square root run here, on the two winners only.
`distance_matrix` builds the whole (N, M) matrix in plain torch, as the
reference's does; no kernel path uses it.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu3drec_torch.core.types import (
    DescriptorKind, Features, Matches, ScoreType,
)
from tpu3drec_torch.ops.pallas_match import F32_BIG, INT_BIG, knn2_raw

_INF = F32_BIG

# detectors whose descriptors live on the SIFT 0..255 8-bit scale
_SIFT_SCALE_METHODS = frozenset(
    {"SIFT", "Harris", "GFTT", "HarrisSIFT", "GoodFeaturesToTrack"})


def quantize_u8(desc: torch.Tensor) -> torch.Tensor:
    """float descriptors on the 0..255 scale -> int8 (round half to even,
    shifted by -128, distance-invariant)."""
    return (torch.round(torch.clamp(desc, 0.0, 255.0)) - 128.0).to(torch.int8)


def distance_matrix(desc1: torch.Tensor, desc2: torch.Tensor,
                    metric: str = "l2") -> torch.Tensor:
    """(..., N, D), (..., M, D) -> (..., N, M) distances (the reference's
    `distance_matrix`): Euclidean for `l2` (full float32) and `l2_int8`
    (exact integer squares), bit-flip counts for `hamming_pm1`. The
    integer metrics multiply int8 values in float32, exact for D <= 1024
    (every partial sum stays below 2**24)."""
    if metric not in ("l2", "l2_int8", "hamming_pm1"):
        raise ValueError(f"unknown metric {metric!r}")
    if metric == "l2":
        a, b = desc1.to(torch.float32), desc2.to(torch.float32)
        d2 = ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
              - 2.0 * torch.matmul(a, b.transpose(-1, -2)))
        return torch.sqrt(torch.clamp(d2, min=0.0))
    if metric == "l2_int8":
        q1, q2 = quantize_u8(desc1), quantize_u8(desc2)
    else:
        q1, q2 = desc1.to(torch.int8), desc2.to(torch.int8)
    dot = torch.matmul(q1.to(torch.float32),
                       q2.to(torch.float32).transpose(-1, -2)).to(torch.int32)
    if metric == "hamming_pm1":
        return (desc1.shape[-1] - dot).to(torch.float32) * 0.5
    n1 = q1.to(torch.int32).square().sum(-1, dtype=torch.int32)
    n2 = q2.to(torch.int32).square().sum(-1, dtype=torch.int32)
    d2 = n1[..., :, None] + n2[..., None, :] - 2 * dot
    return torch.sqrt(torch.clamp(d2, min=0).to(torch.float32))


def _operands(desc1, desc2, metric: str):
    """(a, b, bnorm, post): kernel operands and post(raw top-2 of rows of
    a) -> true distances, matching the reference's `_raw_comparable`."""
    if metric == "l2_int8":
        q1, q2 = quantize_u8(desc1), quantize_u8(desc2)
        n1 = q1.to(torch.int32).square().sum(-1, dtype=torch.int32)
        n2 = q2.to(torch.int32).square().sum(-1, dtype=torch.int32)

        def post(v):
            v = torch.where(v == INT_BIG, v, v + n1[..., None])
            return torch.sqrt(torch.clamp(v, min=0).to(torch.float32))
        return q1, q2, n2, post
    if metric == "hamming_pm1":
        d = desc1.shape[-1]
        q1, q2 = desc1.to(torch.int8), desc2.to(torch.int8)
        zero = torch.zeros(q2.shape[:-1], dtype=torch.int32, device=q2.device)

        def post(v):
            # raw = -2 dot, exactly even: halve back to -dot (the
            # reference's raw value) before converting
            v = torch.where(v == INT_BIG, v, torch.div(v, 2, rounding_mode="floor"))
            return (v.to(torch.float32) + d) * 0.5
        return q1, q2, zero, post
    if metric == "l2":
        a = desc1.to(torch.float32)
        b = desc2.to(torch.float32)
        sq1 = (a * a).sum(-1)
        sq2 = (b * b).sum(-1)

        def post(v):
            v = torch.where(v == F32_BIG, v, v + sq1[..., None])
            return torch.sqrt(torch.clamp(torch.clamp(v, max=_INF), min=0.0))
        return a, b, sq2, post
    raise ValueError(f"unknown metric {metric!r}")


def knn2(desc1: torch.Tensor, desc2: torch.Tensor,
         mask1: torch.Tensor, mask2: torch.Tensor, metric: str = "l2",
         masked_inf: bool = False):
    """Masked 2-NN: (..., N, 2) int32 neighbour indices into desc2 and
    (..., N, 2) float32 distances. Masked rows of desc2 never win; rows of
    desc1 with mask1 False get values the caller must mask. A slot that
    found no valid column reads the post-processed sentinel, or with
    `masked_inf` 3.4e38 whatever the metric (the reference's `tp_knn2`
    masks its distance matrix so before its top-2)."""
    del mask1  # rows of desc1 are scored regardless, as in the reference
    single = desc1.ndim == 2
    if single:
        desc1, desc2, mask2 = desc1[None], desc2[None], mask2[None]
    a, b, bnorm, post = _operands(desc1, desc2, metric)
    idx, raw = knn2_raw(a.contiguous(), b.contiguous(), bnorm.contiguous(),
                        mask2.contiguous())
    dist = post(raw)
    if masked_inf:
        big = INT_BIG if a.dtype == torch.int8 else F32_BIG
        dist = torch.where(raw == big, torch.full_like(dist, _INF), dist)
    if single:
        return idx[0], dist[0]
    return idx, dist


def _match_impl(desc1, desc2, mask1, mask2, ratio: float,
                cross_check: bool, metric: str):
    nn_idx, nn_dist = knn2(desc1, desc2, mask1, mask2, metric)
    best = nn_idx[..., 0]
    d1, d2 = nn_dist[..., 0], nn_dist[..., 1]
    # Lowe ratio test; guard the d2 == 0 case
    ok = d1 < ratio * torch.clamp(d2, min=1e-12)
    ok = ok & mask1 & (d1 < _INF)
    if cross_check:
        rev_idx, _ = knn2(desc2, desc1, mask2, mask1, metric)
        back = rev_idx[..., 0].gather(-1, best.long())
        rows = torch.arange(desc1.shape[-2], device=desc1.device)
        ok = ok & (back == rows)
    return best, d1, ok


def _metric_for(feats: Features) -> str:
    if feats.desc_kind == DescriptorKind.BINARY.value:
        return "hamming_pm1"
    if (feats.method or "").split("(")[0] in _SIFT_SCALE_METHODS:
        return "l2_int8"
    return "l2"


def match_features(feats1: Features, feats2: Features,
                   ratio: float = 0.75, cross_check: bool = False,
                   method: Optional[str] = None) -> Matches:
    """kNN(k=2) + Lowe ratio [+ mutual check]; capacity = feats1.capacity,
    DISTANCE scores."""
    metric = _metric_for(feats1)
    best, d1, ok = _match_impl(feats1.desc, feats2.desc, feats1.mask,
                               feats2.mask, float(ratio), bool(cross_check),
                               metric)
    n = feats1.capacity
    return Matches(
        idx1=torch.arange(n, dtype=torch.int32, device=best.device),
        idx2=best.to(torch.int32),
        score=torch.where(ok, d1, torch.zeros_like(d1)),
        mask=ok,
        score_type=ScoreType.DISTANCE.value,
        method=method or feats1.method,
    )


def match_descriptors(desc1, desc2, mask1=None, mask2=None,
                      ratio: float = 0.75, cross_check: bool = False,
                      metric: str = "l2") -> Matches:
    """Raw-tensor entry point for one descriptor pair."""
    n, m = desc1.shape[0], desc2.shape[0]
    dev = desc1.device
    mask1 = torch.ones(n, dtype=torch.bool, device=dev) if mask1 is None else mask1
    mask2 = torch.ones(m, dtype=torch.bool, device=dev) if mask2 is None else mask2
    best, d1, ok = _match_impl(desc1, desc2, mask1, mask2, float(ratio),
                               bool(cross_check), metric)
    return Matches(
        idx1=torch.arange(n, dtype=torch.int32, device=dev),
        idx2=best.to(torch.int32),
        score=torch.where(ok, d1, torch.zeros_like(d1)),
        mask=ok,
        score_type=ScoreType.DISTANCE.value,
    )


def auto_select_matcher(feats: Features) -> str:
    """Matcher choice from the descriptor kind."""
    if feats.desc_kind == DescriptorKind.BINARY.value:
        return "bf"
    return "flann"
