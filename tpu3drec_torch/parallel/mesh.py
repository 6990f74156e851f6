"""Process meshes and the collectives the parallel paths use.

Port of `tpu3drec/parallel/mesh.py`. The reference drives every device
from one process (`shard_map` over a `jax.sharding.Mesh`); here each card
has its own process (`torchrun --nproc-per-node N`, or `init_multihost`),
and a (dp, tp) `DeviceMesh` over the default process group takes the
place of the JAX mesh: `mesh.get_group("dp")` is the data axis (image
pairs, point blocks, stereo pairs), `mesh.get_group("tp")` the model axis
(the columns of a descriptor set). The reference's collectives map to
`torch.distributed` as

    psum -> all_sum (all_reduce)     all_gather(tiled) -> all_gather_cat
    ppermute (ring) -> ring_shift (batch_isend_irecv)

Gloo is a host transport: on a gloo group a helper takes a CUDA tensor
through host memory and back (a fixed rule of the backend). NCCL takes
the tensor as it is.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "dp"
MODEL_AXIS = "tp"


def default_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """(dp, tp) factorization: favour data parallelism, keep tp a small
    power of two (the reference's rule, tp = 2 at 8 devices too)."""
    if n_devices % 2 != 0 or n_devices < 4:
        return (n_devices, 1)
    tp = 2
    if n_devices % 4 == 0 and n_devices >= 8:
        tp = 2
    return (n_devices // tp, tp)


def rank_device() -> torch.device:
    """This process's card: `cuda:{LOCAL_RANK % device_count}`, so ranks
    that outnumber the cards of a host share them in turn."""
    if not torch.cuda.is_available():
        raise RuntimeError("tpu3drec_torch.parallel: CUDA is not available; "
                           "pass device='cpu' to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def world_size() -> int:
    """Ranks of the default process group; 1 outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(devices: Optional[Sequence[int]] = None,
              shape: Optional[Tuple[int, int]] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A (dp, tp) mesh over the ranks of the default process group.

    `devices` lists the ranks in mesh order (default: every rank, in
    order); a mesh holds every rank of the group, one process a device.
    `device_type` defaults to "cuda" on an NCCL group and "cpu" on a gloo
    one (a host transport: its mesh is a host mesh even where the ranks'
    tensors live on a card)."""
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    n = len(ranks)
    dp, tp = shape if shape is not None else default_mesh_shape(n)
    if dp * tp != n:
        raise ValueError(f"mesh shape {dp}x{tp} != {n} devices")
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"a mesh holds every rank of the default group "
                         f"(world size {world}), got ranks {ranks}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(dp, tp),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: DeviceMesh):
    """Placements of a (B, ...) pair batch: B split along the data axis,
    replicated along the model axis."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0), Replicate()]


def replicated(mesh: DeviceMesh):
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def _via_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """`lax.psum`: the sum of `x` over the ranks of `group`, on every rank
    (a new tensor; `x` is left as it is)."""
    if _via_host(x, group):
        y = x.cpu()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y.to(x.device)
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def all_gather_cat(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """`lax.all_gather(..., tiled=True)`: every rank's `x` concatenated
    along `dim` in rank order."""
    src = x.cpu() if _via_host(x, group) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(x.device)


def ring_shift(tensors: Sequence[torch.Tensor], group=None
               ) -> List[torch.Tensor]:
    """`lax.ppermute` with perm i -> i + 1: each rank sends `tensors` to
    the next rank of `group` and returns what the previous one sent. A
    ring of one rank returns them as they are."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    host = [_via_host(t, group) for t in tensors]
    send = [t.cpu() if h else t.contiguous() for t, h in zip(tensors, host)]
    recv = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in send] \
        + [dist.P2POp(dist.irecv, t, prv, group) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recv, tensors)]


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0,
                      group=None) -> List[torch.Tensor]:
    """Rank `src`'s tensors on every rank of `group`, on each rank's own
    device: shapes and dtypes first (they may differ between ranks), then
    the data."""
    meta = [[(tuple(t.shape), t.dtype) for t in tensors]]
    dist.broadcast_object_list(meta, src=src, group=group)
    out = []
    for t, (shape, dtype) in zip(tensors, meta[0]):
        buf = t if dist.get_rank() == src else torch.empty(
            shape, dtype=dtype, device=t.device)
        host = _via_host(buf, group)
        b = buf.cpu() if host else buf.contiguous()
        dist.broadcast(b, src=src, group=group)
        out.append(b.to(t.device) if host else b)
    return out
