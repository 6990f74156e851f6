"""Batched-hypothesis RANSAC engine.

Port of `tpu3drec/ops/ransac.py`. A fixed batch of K minimal samples is
drawn per problem, every model is solved and scored at once (MSAC
truncated-quadratic score) and the best is taken by argmax (first
maximum). Problems carry a leading batch dimension: points (B, N, 2),
mask (B, N).

The draw is split in two so that a test can replay the reference's exact
samples: `draw_uniform` gives the (K, s) int32 uniforms in [0, 2**31-1)
from a `torch.Generator` (torch cannot reproduce JAX's threefry bits),
and `ranks_to_indices` turns any such uniforms into point indices with
the reference's Floyd sampling over valid ranks and its searchsorted.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

_U_HIGH = 2 ** 31 - 1


class RansacResult(NamedTuple):
    model: torch.Tensor         # (B, ...) best model parameters
    inliers: torch.Tensor       # (B, N) bool inlier mask (includes input mask)
    num_inliers: torch.Tensor   # (B,) int32
    inlier_ratio: torch.Tensor  # (B,) float32 — inliers / valid points
    success: torch.Tensor       # (B,) bool — found any valid model
    residuals: torch.Tensor     # (B, N) squared residuals of the best model


def draw_uniform(num_hypotheses: int, sample_size: int,
                 generator: torch.Generator, device=None) -> torch.Tensor:
    """(K, s) int32 uniforms in [0, 2**31 - 1), the reference's range."""
    return torch.randint(0, _U_HIGH, (num_hypotheses, sample_size),
                         generator=generator, device=device,
                         dtype=torch.int64).to(torch.int32)


def ranks_to_indices(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, K, s) distinct indices of valid points from uniforms `u`
    ((K, s), shared by every problem, or (B, K, s)).

    Floyd's algorithm draws s distinct ranks in [0, n_valid) (a collision
    at step j is replaced by the rank n_valid - s + j); ranks map to
    point indices through the mask cumsum. With fewer than s valid points
    the out-of-range ranks land on masked points, and the degenerate
    models are rejected by the scoring."""
    B, n = mask.shape
    s = u.shape[-1]
    if u.ndim == 2:
        u = u.expand(B, *u.shape)
    u = u.to(torch.int64)
    m = mask.to(torch.int64)
    nv = torch.clamp(m.sum(-1), min=s)[:, None]            # (B, 1)
    csum = torch.cumsum(m, dim=-1)
    ranks = []
    for j in range(s):
        t = u[..., j] % (nv - s + 1 + j)
        for r in ranks:
            t = torch.where(t == r, nv - s + j, t)
        ranks.append(t)
    ranks = torch.stack(ranks, dim=-1)                      # (B, K, s)
    idx = torch.searchsorted(csum, ranks.reshape(B, -1) + 1, side="left")
    return torch.clamp(idx, max=n - 1).reshape(ranks.shape)


def ransac(pts1: torch.Tensor, pts2: torch.Tensor, mask: torch.Tensor, *,
           solver: Callable, residual_fn: Callable, sample_size: int,
           num_hypotheses: int = 512, threshold: float = 4.0,
           min_inliers: int = 0,
           generator: Optional[torch.Generator] = None,
           u: Optional[torch.Tensor] = None) -> RansacResult:
    """Masked RANSAC over (B, N, 2) correspondences.

    solver(p1 (..., s, 2), p2 (..., s, 2)) -> (model (..., P), valid (...)).
    residual_fn(model (B, K, P), pts1 (B, N, 2), pts2) -> (B, K, N)
    squared residuals (px^2). threshold: inlier gate in pixels. The
    samples come from `u` when given, else from `generator` (seed 0 when
    both are None)."""
    B, n = mask.shape
    if u is None:
        if generator is None:
            generator = torch.Generator(device=pts1.device).manual_seed(0)
        u = draw_uniform(num_hypotheses, sample_size, generator, pts1.device)
    idx = ranks_to_indices(u.to(pts1.device), mask)          # (B, K, s)
    K = idx.shape[1]
    flat = idx.reshape(B, -1, 1).expand(-1, -1, 2)
    s1 = pts1.gather(1, flat).reshape(B, K, sample_size, 2)
    s2 = pts2.gather(1, flat).reshape(B, K, sample_size, 2)

    models, valid = solver(s1, s2)
    res = residual_fn(models, pts1, pts2)                     # (B, K, N)
    thr2 = torch.tensor(threshold, dtype=torch.float32) ** 2
    thr2 = thr2.to(res.device)
    inl = (res <= thr2) & mask[:, None, :]
    score = torch.where(inl, thr2 - res, torch.zeros_like(res)).sum(-1)
    score = torch.where(valid, score, torch.full_like(score, -1.0))

    best = torch.argmax(score, dim=1)                          # (B,)
    rows = torch.arange(B, device=best.device)
    best_model = models[rows, best]
    best_res = res[rows, best]
    best_inl = inl[rows, best]
    num_inl = best_inl.sum(-1, dtype=torch.int32)
    n_valid = torch.clamp(mask.sum(-1, dtype=torch.int32), min=1)
    success = (score[rows, best] > 0) & (num_inl >= min_inliers)
    zero = torch.zeros_like(num_inl)
    return RansacResult(
        model=best_model,
        inliers=best_inl & success[:, None],
        num_inliers=torch.where(success, num_inl, zero),
        inlier_ratio=torch.where(success, num_inl / n_valid,
                                 torch.zeros_like(num_inl, dtype=torch.float32)),
        success=success,
        residuals=best_res,
    )
