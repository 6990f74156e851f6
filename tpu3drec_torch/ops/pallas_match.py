"""Fused descriptor distance + running top-2: the `knn2` kernel.

Port of `tpu3drec/ops/pallas_match.py:fused_knn2`, extended with an int8
element type for the main path's `l2_int8` metric. For every row of `a`
and every pair in the batch it computes

    raw[n, m] = bnorm[m] - 2 * <a[n], b[m]>     (masked columns: BIG)

and returns the two smallest `raw` values per row with their column
indices, smallest first, ties to the lowest index (the reference's
`_top2_min`). The N x M matrix never reaches device memory. `bnorm` is
|b|^2 for the L2 metrics (the row constant |a|^2 is added back by the
caller, as in the reference) and zero for the +-1 Hamming metric.

Element types: int8 with exact int32 accumulation (BIG = int32 max), or
float32 (BIG = 3.4e38).

`knn2_raw` is the wrapper: CPU tensors go to `knn2_plain`, CUDA tensors
to the hand-written kernel `csrc/knn2.cu` (or raise). Its int8 path runs
on the tensor cores, a 128-byte row of depth at a time: `pad_depth` pads
D with zero columns to a multiple of 128, which changes no dot product.
"""

from __future__ import annotations

import ctypes
import functools

import torch

INT_BIG = 2 ** 31 - 1
F32_BIG = 3.4e38


def _big(dtype):
    return INT_BIG if dtype == torch.int8 else F32_BIG


# Columns at which the plain version stops building the whole (B, N, M)
# matrix and scans column tiles with a running top-2 instead (the
# reference's `ops/match.py:BLOCKWISE_THRESHOLD` and `knn2_blockwise`)
BLOCKWISE_THRESHOLD = 8192
BLOCK_COLUMNS = 4096


def _top2(raw, big):
    """(idx, val) of the two smallest values along the last axis, ties to
    the lowest index (the reference's `_top2_min`)."""
    i1 = torch.argmin(raw, dim=-1, keepdim=True)
    v1 = raw.gather(-1, i1)
    cols = torch.arange(raw.shape[-1], device=raw.device)
    masked = torch.where(cols == i1, big, raw)
    i2 = torch.argmin(masked, dim=-1, keepdim=True)
    v2 = masked.gather(-1, i2)
    return torch.cat([i1, i2], -1), torch.cat([v1, v2], -1)


def _raw_block(a, b, bnorm, mask2):
    """Masked `bnorm - 2 a.b` of every row of `a` against the rows of `b`."""
    if a.dtype == torch.int8:
        # int8 products summed over D <= 1024 stay below 2**24, so a
        # float32 product is exact whatever its summation order
        dot = torch.matmul(a.to(torch.float32),
                           b.to(torch.float32).transpose(1, 2)).to(torch.int32)
    else:
        dot = torch.matmul(a, b.transpose(1, 2))
    raw = bnorm[:, None, :] - 2 * dot
    big = torch.full((), _big(a.dtype), dtype=raw.dtype, device=raw.device)
    return torch.where(mask2[:, None, :], raw, big), big


def knn2_plain(a: torch.Tensor, b: torch.Tensor, bnorm: torch.Tensor,
               mask2: torch.Tensor):
    """Plain PyTorch version: (idx (B, N, 2) int32, val (B, N, 2)).

    Once N or M reaches `BLOCKWISE_THRESHOLD` the columns are scanned in
    tiles of `BLOCK_COLUMNS` with a running top-2, so the (B, N, M)
    matrix never exists; the merge keeps earlier (lower) columns first
    on ties, so both forms give the same result."""
    M = b.shape[1]
    if max(a.shape[1], M) < BLOCKWISE_THRESHOLD or M <= BLOCK_COLUMNS:
        raw, big = _raw_block(a, b, bnorm, mask2)
        idx, val = _top2(raw, big)
        return idx.to(torch.int32), val
    idx = val = None
    for off in range(0, M, BLOCK_COLUMNS):
        sl = slice(off, off + BLOCK_COLUMNS)
        raw, big = _raw_block(a, b[:, sl], bnorm[:, sl], mask2[:, sl])
        li, lv = _top2(raw, big)
        li = li + off
        if idx is None:
            idx, val = li, lv
            continue
        # four candidates, the running pair (lower columns) first
        j, v = _top2(torch.cat([val, lv], -1), big)
        idx, val = torch.cat([idx, li], -1).gather(-1, j), v
    # a slot with no valid column is column 0 in the untiled form
    idx = torch.where(val == big, torch.zeros_like(idx), idx)
    return idx.to(torch.int32), val


def _check(a, b, bnorm, mask2):
    if a.dtype not in (torch.int8, torch.float32) or b.dtype != a.dtype:
        raise TypeError(f"knn2: descriptors must both be int8 or float32, "
                        f"got {a.dtype} and {b.dtype}")
    want = torch.int32 if a.dtype == torch.int8 else torch.float32
    if bnorm.dtype != want or mask2.dtype != torch.bool:
        raise TypeError(f"knn2: bnorm must be {want} and mask2 bool")
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[2]:
        raise ValueError(f"knn2: need (B, N, D) and (B, M, D), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if bnorm.shape != b.shape[:2] or mask2.shape != b.shape[:2]:
        raise ValueError("knn2: bnorm and mask2 must be (B, M)")
    if a.dtype == torch.int8 and a.shape[2] > 1024:
        raise ValueError("knn2: int8 descriptors longer than 1024")
    if not all(t.device == a.device for t in (b, bnorm, mask2)):
        raise ValueError("knn2: tensors on different devices")
    if not all(t.is_contiguous() for t in (a, b, bnorm, mask2)):
        raise ValueError("knn2: tensors must be contiguous")


I8_DEPTH_STEP = 128


def pad_depth(a: torch.Tensor, b: torch.Tensor):
    """int8 operands as the kernel takes them: D padded with zero columns
    to a multiple of `I8_DEPTH_STEP` (no copy when it already is one), rows
    on 16-byte boundaries. float32 operands are returned as they are."""
    if a.dtype != torch.int8:
        return a, b
    pad = -a.shape[2] % I8_DEPTH_STEP
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, pad))
    # the kernel copies 16 bytes at a time; a view may start off a boundary
    a = a if a.data_ptr() % 16 == 0 else a.clone()
    b = b if b.data_ptr() % 16 == 0 else b.clone()
    return a, b


@functools.cache
def _library():
    """The kernel's library, its C signatures set once."""
    from tpu3drec_torch._nvcc import load
    lib = load("knn2")
    for fn in (lib.knn2_i8_launch, lib.knn2_f32_launch):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    lib.knn2_work_ints.restype = ctypes.c_longlong
    return lib


def _launch(a, b, bnorm, mask2):
    lib = _library()
    fn = lib.knn2_i8_launch if a.dtype == torch.int8 else lib.knn2_f32_launch
    a, b = pad_depth(a, b)
    B, N, D = a.shape
    M = b.shape[1]
    idx = torch.empty(B, N, 2, device=a.device, dtype=torch.int32)
    val = torch.empty(B, N, 2, device=a.device, dtype=bnorm.dtype)
    # each pair's list of valid columns, built by the C call
    work = torch.empty(lib.knn2_work_ints(B, M), device=a.device,
                       dtype=torch.int32)

    # the C call launches on the current device
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        # a bool tensor is one byte of 0 or 1 per element, as the kernel reads
        err = fn(a.data_ptr(), b.data_ptr(), bnorm.data_ptr(),
                 mask2.data_ptr(), B, N, M, D, work.data_ptr(),
                 idx.data_ptr(), val.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn2 kernel launch failed: CUDA error {err}")
    return idx, val


def knn2_raw(a: torch.Tensor, b: torch.Tensor, bnorm: torch.Tensor,
             mask2: torch.Tensor):
    """Top-2 of `bnorm - 2 a.b` per row: (idx (B, N, 2) int32, raw
    values (B, N, 2) int32 for int8 input, float32 for float32 input)."""
    _check(a, b, bnorm, mask2)
    if a.device.type == "cpu":
        return knn2_plain(a, b, bnorm, mask2)
    if a.device.type != "cuda":
        raise ValueError(f"knn2: unsupported device {a.device}")
    out = _launch(a, b, bnorm, mask2)
    knn2_raw.launches += 1
    return out


knn2_raw.launches = 0
