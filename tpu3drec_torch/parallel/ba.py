"""Sharded bundle adjustment over a process mesh.

Port of `tpu3drec/parallel/ba.py`. Cameras are few and replicated;
points and their observations are many and split over the mesh's data
axis. Each rank owns a contiguous block of points and exactly the
observations of those points, so every point-indexed quantity (V blocks,
gp, the CG matvec's z = W^T x, the back-substitution) is local. The only
cross-rank reductions are the camera-indexed sums of
`ops/ba.py:bundle_adjust(axis_name=...)`, one `all_reduce` of a
(C, 10)-ish tensor each, so every rank runs one replicated LM/CG state
while the observation work is split. This module partitions the global
problem, runs the solve on each rank and reassembles the points.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from tpu3drec_torch.ops.ba import BAConfig, BAProblem, BAResult, bundle_adjust
from tpu3drec_torch.parallel.mesh import (
    DATA_AXIS, all_gather_cat, broadcast_tensors,
)


def _shard_arrays(prob: Dict[str, np.ndarray], n_shards: int
                  ) -> Tuple[Dict[str, np.ndarray], int, int]:
    """The reference's padded layout on host arrays (see
    `shard_ba_problem`)."""
    pts, pt_mask = prob["points"], prob["point_mask"]
    obs_cam, obs_pt = prob["obs_cam"], prob["obs_pt"]
    obs_uv, obs_mask = prob["obs_uv"], prob["obs_mask"]
    n_pts = pts.shape[0]
    pl = -(-n_pts // n_shards)           # points per shard
    p_pad = pl * n_shards
    if p_pad != n_pts:
        pts = np.concatenate([pts, np.zeros((p_pad - n_pts, 3), pts.dtype)])
        pt_mask = np.concatenate([pt_mask, np.zeros(p_pad - n_pts, bool)])

    shard_of = obs_pt // pl              # routing by point block
    # dead observations (mask False) keep their shard: the solver masks them
    counts = np.bincount(shard_of, minlength=n_shards)
    ms = max(int(counts.max()), 1)

    s_cam = np.zeros((n_shards, ms), np.int32)
    s_pt = np.zeros((n_shards, ms), np.int32)
    s_uv = np.zeros((n_shards, ms, 2), obs_uv.dtype)
    s_mask = np.zeros((n_shards, ms), bool)
    for s in range(n_shards):
        sel = np.nonzero(shard_of == s)[0]
        k = sel.size
        s_cam[s, :k] = obs_cam[sel]
        s_pt[s, :k] = obs_pt[sel] - s * pl   # LOCAL point ids
        s_uv[s, :k] = obs_uv[sel]
        s_mask[s, :k] = obs_mask[sel]
    return ({"cam_params": prob["cam_params"], "points": pts,
             "obs_cam": s_cam.reshape(-1), "obs_pt": s_pt.reshape(-1),
             "obs_uv": s_uv.reshape(-1, 2), "obs_mask": s_mask.reshape(-1),
             "param_mask": prob["param_mask"], "point_mask": pt_mask},
            pl, ms)


def shard_ba_problem(prob: BAProblem, n_shards: int
                     ) -> Tuple[BAProblem, int, int]:
    """Partition a global BAProblem into per-shard blocks (host-side).

    Points are padded to a multiple of n_shards and split into contiguous
    blocks; each observation is routed to the shard owning its point and
    the per-shard observation lists are padded to the largest count.
    Returns (stacked_prob, pts_per_shard, obs_per_shard), on the
    problem's device, every array's leading dimension a multiple of
    n_shards; obs_pt holds LOCAL point ids."""
    arrays, pl, ms = _shard_arrays(prob.to_numpy(), n_shards)
    return (BAProblem.from_numpy(**arrays, device=prob.cam_params.device),
            pl, ms)


def sharded_bundle_adjust(prob: BAProblem, mesh: DeviceMesh,
                          config: BAConfig = BAConfig(schur_solver="cg"),
                          axis: str = DATA_AXIS) -> BAResult:
    """`bundle_adjust` with points and observations split over the mesh
    axis `axis`; every rank of the mesh calls it.

    Rank 0's problem is broadcast first, so every rank splits one problem
    even where the ranks' own problems differ. Each rank solves its block
    (`bundle_adjust(axis_name=<the axis's group>)`, Schur-CG only) and
    the blocks' points are gathered back into the original order. Returns
    the same BAResult on every rank, as `bundle_adjust` would."""
    if config.schur_solver == "auto":
        config = config._replace(schur_solver="cg")
    group = mesh.get_group(axis)
    n_shards = mesh.size(mesh.mesh_dim_names.index(axis))
    r = mesh.get_local_rank(axis)
    dev = prob.cam_params.device
    prob = BAProblem(*broadcast_tensors(list(prob), src=0))
    n_pts = prob.points.shape[0]
    arrays, pl, ms = _shard_arrays(prob.to_numpy(), n_shards)
    pts_rows, obs_rows = slice(r * pl, (r + 1) * pl), slice(r * ms, (r + 1) * ms)
    local = dict(arrays)
    for k in ("points", "point_mask"):
        local[k] = arrays[k][pts_rows]
    for k in ("obs_cam", "obs_pt", "obs_uv", "obs_mask"):
        local[k] = arrays[k][obs_rows]
    res = bundle_adjust(BAProblem.from_numpy(**local, device=dev), config,
                        axis_name=group)
    pts = all_gather_cat(res.points, group)[:n_pts]
    return res._replace(points=pts, packed=torch.cat(
        [res.cam_params.reshape(-1), pts.reshape(-1), res.stats]))
