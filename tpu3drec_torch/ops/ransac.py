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

import math
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
    """(K, s) int32 uniforms in [0, 2**31 - 1), the reference's range,
    drawn on the generator's device and moved to `device`."""
    return torch.randint(0, _U_HIGH, (num_hypotheses, sample_size),
                         generator=generator, device=generator.device,
                         dtype=torch.int64).to(device=device, dtype=torch.int32)


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
           num_hypotheses: int = 512, models_per_sample: int = 1,
           threshold=4.0, min_inliers: int = 0,
           generator: Optional[torch.Generator] = None,
           u: Optional[torch.Tensor] = None) -> RansacResult:
    """Masked RANSAC over (B, N, D1) / (B, N, D2) correspondences.

    solver(p1 (..., s, D1), p2 (..., s, D2)) -> (model (..., P...), valid
    (...)); with models_per_sample R > 1 the solver returns (..., R, P...)
    models and (..., R) flags (the 5-point solver's up to 10 roots), which
    are flattened to (B, K*R, ...). residual_fn(models (B, K*R, P...),
    pts1, pts2) -> (B, K*R, N) squared residuals (px^2). threshold: inlier
    gate in pixels, a float or a (B,) tensor. The samples come from `u`
    when given, else from `generator` (seed 0 when both are None)."""
    B, n = mask.shape
    if u is None:
        if generator is None:
            generator = torch.Generator(device=pts1.device).manual_seed(0)
        u = draw_uniform(num_hypotheses, sample_size, generator, pts1.device)
    idx = ranks_to_indices(u.to(pts1.device), mask)          # (B, K, s)
    K = idx.shape[1]
    flat = idx.reshape(B, -1, 1)
    s1 = pts1.gather(1, flat.expand(-1, -1, pts1.shape[-1])).reshape(
        B, K, sample_size, pts1.shape[-1])
    s2 = pts2.gather(1, flat.expand(-1, -1, pts2.shape[-1])).reshape(
        B, K, sample_size, pts2.shape[-1])

    models, valid = solver(s1, s2)
    if models_per_sample > 1:
        models = models.reshape((B, K * models_per_sample) + models.shape[3:])
        valid = valid.reshape(B, K * models_per_sample)
    res = residual_fn(models, pts1, pts2)                     # (B, K*R, N)
    thr2 = torch.as_tensor(threshold, dtype=torch.float32).to(res.device) ** 2
    if thr2.ndim:
        thr2 = thr2[:, None, None]
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


def num_hypotheses_for(conf: float, inlier_ratio: float, sample_size: int,
                       cap: int = 8192) -> int:
    """Classical RANSAC iteration count N = log(1-p)/log(1-w^s), capped."""
    w = max(min(inlier_ratio, 0.999), 1e-3)
    denom = math.log(max(1.0 - w ** sample_size, 1e-12))
    if denom >= 0:
        return cap
    n = math.log(max(1.0 - conf, 1e-12)) / denom
    return int(min(max(math.ceil(n), 32), cap))
