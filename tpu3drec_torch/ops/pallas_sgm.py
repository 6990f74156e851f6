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
kernel `csrc/sgm.cu` (or raise). On the card each axis is laid out as
(X, streams, D) with `permute().contiguous()`, one kernel launch covers
both axes, and the two results are summed in the horizontal layout and
permuted back to (B, D, H, W). Kernel and plain version perform
the same float operations in the same order, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

MAX_DISPARITIES = 128   # csrc/sgm.cu: D <= 32 lanes x 4 registers


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


def sgm_layouts(volumes: torch.Tensor):
    """The kernel's inputs: rows (W, B*H, D) and columns (H, B*W, D)."""
    B, D, H, W = volumes.shape
    return (volumes.permute(3, 0, 2, 1).reshape(W, B * H, D).contiguous(),
            volumes.permute(2, 0, 3, 1).reshape(H, B * W, D).contiguous())


def _launch(v_h, v_v, p1x100, p2x100):
    from tpu3drec_torch._nvcc import load
    fn = load("sgm").sgm_axes_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int] * 2 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    a_h = torch.empty_like(v_h)
    a_v = torch.empty_like(v_v)
    D = v_h.shape[2]
    with torch.cuda.device(v_h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(v_h.data_ptr(), a_h.data_ptr(), v_h.shape[0], v_h.shape[1],
                 v_v.data_ptr(), a_v.data_ptr(), v_v.shape[0], v_v.shape[1],
                 D, int(p1x100), int(p2x100), stream)
    if err != 0:
        raise RuntimeError(f"sgm kernel launch failed: CUDA error {err}")
    return a_h, a_v


def sgm_axes(v_h: torch.Tensor, v_v: torch.Tensor, p1x100: int = 15,
             p2x100: int = 90):
    """The kernel alone on laid-out CUDA volumes (`sgm_layouts`): both
    axes' forward + backward aggregation, in the same layouts. One
    launch, counted on `sgm_aggregate_batch.launches`."""
    if v_h.device.type != "cuda" or v_v.device != v_h.device:
        raise ValueError("sgm: the kernel takes CUDA tensors on one device")
    if not (v_h.is_contiguous() and v_v.is_contiguous()) \
            or v_h.shape[2] != v_v.shape[2]:
        raise ValueError("sgm: need contiguous (X, S, D) volumes of one D")
    out = _launch(v_h, v_v, p1x100, p2x100)
    sgm_aggregate_batch.launches += 1
    return out


def sgm_aggregate_batch_kernel(volumes: torch.Tensor, p1x100: int = 15,
                               p2x100: int = 90) -> torch.Tensor:
    """The kernel's route for (B, D, H, W) CUDA volumes: lay both axes
    out, one launch, add the vertical result into the horizontal layout
    (D stays innermost on both sides) and permute once to (B, D, H, W)."""
    B, D, H, W = volumes.shape
    a_h, a_v = sgm_axes(*sgm_layouts(volumes), p1x100, p2x100)
    both = a_h.view(W, B, H, D) + a_v.view(H, B, W, D).permute(2, 1, 0, 3)
    return both.permute(1, 3, 2, 0).contiguous()


def sgm_aggregate_batch(volumes: torch.Tensor, p1x100: int = 15,
                        p2x100: int = 90) -> torch.Tensor:
    """4-direction aggregation of (B, D, H, W) float32 cost volumes: the
    plain version for CPU tensors, the kernel for CUDA tensors."""
    _check(volumes)
    if volumes.device.type == "cpu":
        return sgm_aggregate_batch_plain(volumes, p1x100, p2x100)
    if volumes.device.type != "cuda":
        raise ValueError(f"sgm: unsupported device {volumes.device}")
    return sgm_aggregate_batch_kernel(volumes, p1x100, p2x100)


sgm_aggregate_batch.launches = 0
