"""Data-parallel dense stereo over a process mesh.

Port of `tpu3drec/parallel/dense.py`. The (reference, neighbour) stereo
pairs of a multi-view scene are split one pair a rank along the mesh's
data axis, and each rank runs the UNBATCHED pair program (rectify -> SGM
-> depth, `ops/stereo.py:stereo_depth_pair`, so the `sgm` kernel runs on
every rank). Pairs go in chunks of dp; a short chunk is padded with its
last pair, because every rank joins the gather; the padding is dropped
after it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from tpu3drec_torch.core.device import resolve_device
from tpu3drec_torch.ops.stereo import stereo_depth_pair
from tpu3drec_torch.parallel.mesh import DATA_AXIS, all_gather_cat

_KEEP = ("depth", "disparity", "valid", "baseline")


def make_sharded_stereo_step(mesh: DeviceMesh, num_disparities: int = 64):
    """Build step(imgs1 (B, H, W), imgs2, K1 (B, 3, 3), K2, R (B, 3, 3),
    t (B, 3)) -> dict of per-pair (B, ...) outputs ("depth", "disparity",
    "valid", "baseline") on every rank, with B the mesh's data-axis size:
    rank d of dp runs pair d (tp ranks repeat the pair of their dp slot;
    the geometry programs are not split)."""
    dp = mesh.size(0)
    group = mesh.get_group(DATA_AXIS)
    d = mesh.get_local_rank(DATA_AXIS)

    def run(imgs1, imgs2, K1, K2, R, t) -> Dict[str, torch.Tensor]:
        B = imgs1.shape[0]
        if B != dp:
            raise ValueError(f"batch {B} != mesh dp size {dp}; pad the "
                             "pair list to a full mesh row")
        out = stereo_depth_pair(imgs1[d], imgs2[d], K1[d], K2[d], R[d], t[d],
                                num_disparities=num_disparities)
        dev = out["depth"].device
        return {k: all_gather_cat(torch.as_tensor(out[k]).to(dev)[None], group)
                for k in _KEEP}

    return run


def sharded_pairwise_stereo(mesh: DeviceMesh, img_ref,
                            neighbours: Sequence[Tuple],
                            K_ref, num_disparities: int = 64,
                            device=None) -> List[Dict[str, torch.Tensor]]:
    """All (reference, neighbour) pairs of one scene in ceil(n / dp)
    sharded steps. neighbours: (img, K2, R_rel, t_rel, _unused) tuples of
    host arrays; images go to `device` (None means CUDA). Returns one
    dict of tensors a REAL pair, in order, on every rank."""
    dev = resolve_device(device)
    dp = mesh.size(0)
    step = make_sharded_stereo_step(mesh, num_disparities)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    ref = f32(img_ref).to(dev)
    n = len(neighbours)
    outs: List[Dict[str, torch.Tensor]] = []
    for s in range(0, n, dp):
        real = list(neighbours[s:s + dp])
        chunk = real + [real[-1]] * (dp - len(real))
        i1 = ref.expand(dp, *ref.shape)
        i2 = torch.stack([f32(c[0]) for c in chunk]).to(dev)
        k1 = f32(K_ref).expand(dp, 3, 3)
        k2, r, t = (torch.stack([f32(c[j]) for c in chunk]) for j in (1, 2, 3))
        res = step(i1, i2, k1, k2, r, t)
        outs.extend({k: v[j] for k, v in res.items()} for j in range(len(real)))
    return outs
