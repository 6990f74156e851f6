"""4-direction semi-global aggregation of cost volumes: the `sgm` kernel.

Port of `tpu3drec/ops/pallas_sgm.py:sgm_aggregate_batch_pallas`. For
(B, D, H, W) float32 cost volumes it returns

    (fwd_h + bwd_h) + (fwd_v + bwd_v)

where each term is the P1/P2 dynamic programme of `_dp_step` run along
image rows (h) or columns (v) in one direction; P1 = p1x100 / 100 and
P2 = p2x100 / 100 as float32.

`sgm_aggregate_batch` is the wrapper: CPU tensors go to
`sgm_aggregate_batch_plain` (the reference's `_sgm_scan` as a Python
loop), CUDA tensors to `sgm_aggregate_batch_kernel` and the hand-written
kernel `csrc/sgm.cu` (or raise). On the card the route reads the
volumes as they lie, with no layout copy: one output and one scratch
volume from `torch.empty`, then one call of the library, which enqueues
the vertical kernel and then the horizontal one. The function is bound
by bytes. The vertical phase scans 32-column groups (every access a
128-byte row segment) with a cp.async ring and writes fwd_v + bwd_v into
the output; the horizontal phase stages [D, 16-column] chunks of each
row through shared memory, keeps fwd_h in the scratch volume and adds
fwd_h + bwd_h into the output once. Kernel and plain version perform the
same float operations in the same order and grouping, so they agree bit
for bit.
"""

from __future__ import annotations

import ctypes

import torch

from tpu3drec_torch import _nvcc

MAX_DISPARITIES = 128   # csrc/sgm.cu: D <= 32 x MAX_NPL registers a lane
_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)


def _dp_step(prev: torch.Tensor, c: torch.Tensor, p1: float,
             p2: float) -> torch.Tensor:
    """One SGM DP step on (..., D): out = c + best(prev) - min(prev)."""
    m = prev.amin(-1, keepdim=True)
    up = torch.cat([prev[..., :1], prev[..., :-1]], -1)
    dn = torch.cat([prev[..., 1:], prev[..., -1:]], -1)
    best = torch.minimum(torch.minimum(prev, up + p1),
                         torch.minimum(dn + p1, m + p2))
    return c + best - m


def _bidir_plain(v: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """Forward + backward DP over axis 0 of (X, ..., D)."""
    both = torch.stack([v, v.flip(0)], 1)            # (X, 2, ..., D)
    agg = torch.empty_like(both)
    prev = agg[0] = both[0]
    for x in range(1, both.shape[0]):
        prev = agg[x] = _dp_step(prev, both[x], p1, p2)
    return agg[:, 0] + agg[:, 1].flip(0)


def _penalties(p1x100: int, p2x100: int):
    # float32 rounding of the double quotient, as the kernel computes it
    return (float(torch.tensor(p1x100 / 100.0, dtype=torch.float32)),
            float(torch.tensor(p2x100 / 100.0, dtype=torch.float32)))


def sgm_aggregate_batch_plain(volumes: torch.Tensor, p1x100: int = 15,
                              p2x100: int = 90) -> torch.Tensor:
    """Plain PyTorch version: the reference's XLA scan, one step at a time."""
    p1, p2 = _penalties(p1x100, p2x100)
    agg_h = _bidir_plain(volumes.permute(3, 0, 2, 1), p1, p2)  # (W, B, H, D)
    agg_v = _bidir_plain(volumes.permute(2, 0, 3, 1), p1, p2)  # (H, B, W, D)
    return agg_h.permute(1, 3, 2, 0) + agg_v.permute(1, 3, 0, 2)


def _check(volumes):
    if volumes.dtype != torch.float32 or volumes.ndim != 4:
        raise TypeError(f"sgm: need (B, D, H, W) float32 volumes, got "
                        f"{volumes.dtype} {tuple(volumes.shape)}")
    if not 1 <= volumes.shape[1] <= MAX_DISPARITIES:
        raise ValueError(f"sgm: D = {volumes.shape[1]} outside 1.."
                         f"{MAX_DISPARITIES}")


def sgm_aggregate_batch_kernel(volumes: torch.Tensor, p1x100: int = 15,
                               p2x100: int = 90) -> torch.Tensor:
    """The kernel's route for contiguous (B, D, H, W) float32 CUDA
    volumes: one call of the kernel library (the vertical, then the
    horizontal kernel), counted once on the counter `sgm.launches`."""
    if not volumes.is_contiguous():
        raise ValueError("sgm: the kernel takes a contiguous CUDA tensor")
    B, D, H, W = volumes.shape
    out = torch.empty_like(volumes)
    scratch = torch.empty_like(volumes)
    _nvcc.launch("sgm", "sgm_launch", _ARGTYPES, volumes.device,
                 volumes.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, D,
                 H, W, int(p1x100), int(p2x100))
    return out


def sgm_aggregate_batch(volumes: torch.Tensor, p1x100: int = 15,
                        p2x100: int = 90) -> torch.Tensor:
    """4-direction aggregation of (B, D, H, W) float32 cost volumes: the
    plain version for CPU tensors, the kernel for CUDA tensors."""
    _check(volumes)
    if _nvcc.route("sgm", volumes.device) == "plain":
        return sgm_aggregate_batch_plain(volumes, p1x100, p2x100)
    return sgm_aggregate_batch_kernel(volumes, p1x100, p2x100)
