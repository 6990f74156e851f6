"""Data/tensor-parallel pair processing over a process mesh.

Port of `tpu3drec/parallel/pairs.py`. A batch of image pairs is split
along the mesh's data axis (`dp`); inside each data row the columns of
image 2's descriptors are split along the model axis (`tp`): each tp rank
takes the top-2 of its slice of the columns through the `knn2` kernel and
the exact global top-2 is reduced from an `all_gather` of every rank's
candidates, so the (N, M) work is split instead of repeated.

`ring_knn2` splits both descriptor sets: image 2's blocks rotate around
the tp ring one hop a step (`batch_isend_irecv`) while image 1's rows stay
put, and each block's top-2 folds into a running top-2.

These are per-rank functions, called by every rank of the group with its
own shard (the reference calls them inside `shard_map`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu3drec_torch.ops.geometry import find_homography
from tpu3drec_torch.ops.match import knn2
from tpu3drec_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, all_gather_cat, all_sum, ring_shift,
)

_INF = 3.4e38


def _top2_of(val: torch.Tensor, idx: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two smallest of `val` (..., K) with their `idx`, ties to the
    lower slot (the reference's iota compare-mask reduction)."""
    j1 = torch.argmin(val, dim=-1, keepdim=True)
    g1 = val.gather(-1, j1)
    cols = torch.arange(val.shape[-1], device=val.device)
    masked = torch.where(cols == j1, torch.full_like(val, _INF), val)
    j2 = torch.argmin(masked, dim=-1, keepdim=True)
    g2 = masked.gather(-1, j2)
    return (torch.cat([idx.gather(-1, j1), idx.gather(-1, j2)], -1),
            torch.cat([g1, g2], -1))


def tp_knn2(desc1: torch.Tensor, desc2_shard: torch.Tensor,
            mask1: torch.Tensor, mask2_shard: torch.Tensor,
            axis_name=None, metric: str = "l2"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-NN where the columns of desc2 are split over the ranks of the
    process group `axis_name` (None: the default group), rank r holding
    columns [r * m_local, (r + 1) * m_local).

    (..., N, D) rows against this rank's (..., m_local, D) columns:
    the local top-2 through `knn2` (a slot with no valid column reads
    3.4e38), its column ids made global, then an `all_gather` of every
    rank's two candidates and the global top-2 of the (..., N, 2 x tp)
    candidates. Returns (idx (..., N, 2) int32 global desc2 ids, dist
    (..., N, 2)), the same on every rank."""
    m_local = desc2_shard.shape[-2]
    rank = dist.get_rank(axis_name)
    idx, val = knn2(desc1, desc2_shard, mask1, mask2_shard, metric,
                    masked_inf=True)
    idx = idx + rank * m_local
    all_val = all_gather_cat(val, axis_name, dim=-1)
    all_idx = all_gather_cat(idx, axis_name, dim=-1)
    return _top2_of(all_val, all_idx)


def ring_knn2(desc1_shard: torch.Tensor, desc2_shard: torch.Tensor,
              mask1_shard: torch.Tensor, mask2_shard: torch.Tensor,
              axis_name=None, metric: str = "l2"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 2-NN with BOTH sets split over the group `axis_name`: rank r
    holds rows and columns block r. desc2's blocks and their masks rotate
    one hop a step for tp steps (block b reaches rank r at step (r - b)
    mod tp); each block's top-2 through `knn2` folds into the running
    top-2, whose earlier candidates win ties. Rows with mask1 False read
    3.4e38. Returns (idx (N/tp, 2) global desc2 ids, dist (N/tp, 2))."""
    tp = dist.get_world_size(axis_name)
    rank = dist.get_rank(axis_name)
    m_local = desc2_shard.shape[-2]
    n_local = desc1_shard.shape[-2]
    dev = desc1_shard.device
    best_val = torch.full((n_local, 2), _INF, dtype=torch.float32, device=dev)
    best_idx = torch.zeros((n_local, 2), dtype=torch.int32, device=dev)
    block, bmask = desc2_shard, mask2_shard
    for step in range(tp):
        owner = (rank - step) % tp
        i, v = knn2(desc1_shard, block, mask1_shard, bmask, metric,
                    masked_inf=True)
        best_idx, best_val = _top2_of(
            torch.cat([best_val, v], -1),
            torch.cat([best_idx, i + owner * m_local], -1))
        if step + 1 < tp:
            block, bmask = ring_shift([block, bmask], axis_name)
    best_val = torch.where(mask1_shard[:, None], best_val,
                           torch.full_like(best_val, _INF))
    return best_idx, best_val


def make_batched_pair_step(mesh: DeviceMesh, detect_fn: Callable,
                           ratio: float = 0.75,
                           ransac_threshold: float = 4.0,
                           num_hypotheses: int = 256) -> Callable:
    """The multi-card pair step over `mesh` (every rank calls it).

    detect_fn(imgs (n, H, W)) -> (xy (n, N, 2), response (n, N),
    desc (n, N, D), mask (n, N)): a raw-tuple detector over a batch.

    Returns step(imgs1 (B, H, W), imgs2 (B, H, W), u (B, K, 4)) -> dict of
    per-pair stats (num_matches, num_inliers, inlier_ratio, success), each
    (B,) on every rank, plus 'total_matches' (B,): the all_sum of
    num_matches over dp. Rank (d, t) of the mesh takes rows
    [d * B / dp, (d + 1) * B / dp), detects both images of its pairs in one
    call, matches them with `tp_knn2` (`metric="l2"`) over its tp group,
    ratio-tests and runs `find_homography(refit=False)` with the uniforms
    `u` of its rows (the reference's per-pair keys: one seeded draw for
    the batch gives a sharded run the draws of a single-rank one)."""
    dp_group = mesh.get_group(DATA_AXIS)
    tp_group = mesh.get_group(MODEL_AXIS)
    dp, tp = mesh.size(0), mesh.size(1)
    d, t = mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(MODEL_AXIS)

    def step(imgs1: torch.Tensor, imgs2: torch.Tensor,
             u: torch.Tensor) -> Dict[str, torch.Tensor]:
        B = imgs1.shape[0]
        if B % dp or imgs2.shape != imgs1.shape or u.shape[0] != B:
            raise ValueError(f"pair step: need two (B, H, W) batches with "
                             f"B a multiple of dp={dp} and (B, K, 4) "
                             f"uniforms, got {tuple(imgs1.shape)}, "
                             f"{tuple(imgs2.shape)}, {tuple(u.shape)}")
        b = B // dp
        rows = slice(d * b, (d + 1) * b)
        xy, _, desc, mask = detect_fn(torch.cat([imgs1[rows], imgs2[rows]]))
        xy1, xy2, d1, d2 = xy[:b], xy[b:], desc[:b], desc[b:]
        m1, m2 = mask[:b], mask[b:]
        shard = d2.shape[1] // tp
        cols = slice(t * shard, (t + 1) * shard)
        nn_idx, nn_dist = tp_knn2(d1, d2[:, cols].contiguous(), m1,
                                  m2[:, cols].contiguous(), tp_group)
        ok = (nn_dist[..., 0] < ratio * torch.clamp(nn_dist[..., 1], min=1e-12)) \
            & m1 & (nn_dist[..., 0] < _INF)
        p2 = xy2.gather(1, nn_idx[..., :1].long().expand(-1, -1, 2))
        rr = find_homography(xy1, p2, mask=ok, threshold=ransac_threshold,
                             num_hypotheses=num_hypotheses, refit=False,
                             u=u[rows])
        local = {"num_matches": ok.sum(-1, dtype=torch.int32),
                 "num_inliers": rr.num_inliers.to(torch.int32),
                 "inlier_ratio": rr.inlier_ratio.to(torch.float32),
                 "success": rr.success}
        stats = {k: all_gather_cat(v, dp_group) for k, v in local.items()}
        total = all_sum(local["num_matches"].sum(dtype=torch.int32), dp_group)
        stats["total_matches"] = total.expand(B)
        return stats

    return step


def sharded_pair_stats(mesh: Optional[DeviceMesh],
                       stats: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Host-side summary of a sharded step's output."""
    return {k: float(v.sum()) for k, v in stats.items()}
