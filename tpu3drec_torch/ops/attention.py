"""Masked softmax attention, `softmax(where(mask_k, scale q.k^T, -1e9)) v`,
in two forms: the plain PyTorch composition and the one-pass kernel
`csrc/masked_attention.cu`.

`masked_attention(q, k, v, key_mask, scale)` takes q (B, Nq, h, dh), k and
v (B, Nk, h, dh) and a key mask (B, Nk) of bools, and returns (B, Nq, h,
dh). A masked key's score is replaced by -1e9, not left out, so a row whose
keys are all masked comes out as the mean of v over all Nk keys. The route
is `ops.tf32.route`'s table, on cuBLAS's TF32 flag
(`torch.backends.cuda.matmul.allow_tf32`): the plain form on the CPU, the
kernel in TF32 or, with the flag off, in 3xTF32 on the card. The kernel
also raises on dh not a multiple of 8 up to 128 and on no keys.

The kernel launches are counted on `masked_attention.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from tpu3drec_torch import _nvcc
from tpu3drec_torch.ops import tf32
from tpu3drec_torch.ops.tf32 import LIMIT_FACTOR, split_round, tf32_round

NEG = -1e9


def masked_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_mask: torch.Tensor, scale: float
                           ) -> torch.Tensor:
    """The plain form: the scores, their scale, the mask fill and the
    softmax as PyTorch operations, then the weighted sum of v."""
    att = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    att = att.masked_fill(~key_mask[:, None, None, :], NEG)
    att = torch.softmax(att, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", att, v)


def float64_answer_and_limit(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, key_mask: torch.Tensor,
                             scale: float, full_float32: bool = False,
                             chunk: int = 4):
    """The exact answer (the plain form in float64, `chunk` sequences at a
    time) and how far from it the kernel may be, largest over all
    elements: `LIMIT_FACTOR` times the largest of two errors measured on
    the same operands, the plain form's in the kernel's precision (TF32
    flag on, or off for `full_float32`) and the exact answer's on operands
    rounded as the kernel reads them (`tf32_round`, `split_round`): what
    the rounding of the operands alone costs, where cuBLAS computes a small
    product exactly; and 2^-23 of the largest sum of magnitudes the output
    is made of, sum_m p_m |v_m|, which a float32 sum in any order costs
    where the terms cancel and cuBLAS rounds a product almost correctly.
    The kernel rounds the same operands and P, and sums in another order:
    its error is of the same size, while a key mask ignored or a key tile
    lost moves the output by far more."""
    def exact(a, b, c):
        return torch.cat([masked_attention_plain(
            a[i:i + chunk].double(), b[i:i + chunk].double(),
            c[i:i + chunk].double(), key_mask[i:i + chunk], scale)
            for i in range(0, a.shape[0], chunk)])

    want = exact(q, k, v)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = not full_float32
    try:
        plain = masked_attention_plain(q, k, v, key_mask, scale)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    err_plain = float((plain.double() - want).abs().max())
    rnd = split_round if full_float32 else tf32_round
    rounded = exact(rnd(q), rnd(k), rnd(v))
    err_rounded = float((rounded.float().double() - want).abs().max())
    err_sum = 2.0 ** -23 * float(exact(q, k, v.abs()).max())
    return want, LIMIT_FACTOR * max(err_plain, err_rounded, err_sum)


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """`t` as the kernel reads it: dh contiguous, the other strides whole
    16-byte steps and the data on 16 bytes, else a contiguous copy (the
    self block's v is a view into the packed `Wqkv` output, and its rotary
    q and k keep that output's layout, dh 4 floats apart)."""
    if (t.stride(-1) == 1 and all(s % 4 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous()


_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_longlong,) * 12
             + (ctypes.c_int,) * 5 + (ctypes.c_float, ctypes.c_int,
                                      ctypes.c_void_p))


def masked_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, key_mask: torch.Tensor,
                            scale: float, full_float32: bool = False
                            ) -> torch.Tensor:
    """The kernel's route for CUDA float32 operands: one launch of
    `csrc/masked_attention.cu` on the current stream, in TF32 or, with
    `full_float32`, 3xTF32, counted on `masked_attention.launches`."""
    B, nq, h, dh = q.shape
    nk = k.shape[1]
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError("masked_attention: the kernel takes float32 "
                        f"operands, got {q.dtype}, {k.dtype}, {v.dtype}")
    if dh % 8 or not 8 <= dh <= 128:
        raise ValueError(f"masked_attention: the kernel takes dh a multiple "
                         f"of 8 up to 128, got {dh}")
    if nk < 1:
        raise ValueError("masked_attention: the kernel needs a key")
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    mask = key_mask.contiguous().view(torch.uint8)
    out = torch.empty((B, nq, h, dh), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    _nvcc.launch("masked_attention", "masked_attention_launch", _ARGTYPES,
                 q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask.data_ptr(), out.data_ptr(), *strides, B, h, nq, nk, dh,
                 scale, int(full_float32))
    return out


def _check(q, k, v, key_mask) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"masked_attention: need q (B, Nq, h, dh) and k, v "
                         f"(B, Nk, h, dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, nk, h, dh = k.shape
    if q.shape[0] != B or q.shape[2:] != (h, dh):
        raise ValueError(f"masked_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    if key_mask.dtype != torch.bool or tuple(key_mask.shape) != (B, nk):
        raise ValueError(f"masked_attention: need a (B, Nk) bool key mask, "
                         f"got {key_mask.dtype} {tuple(key_mask.shape)}")
    if len({t.device for t in (q, k, v, key_mask)}) != 1:
        raise ValueError("masked_attention: operands on several devices")


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_mask: torch.Tensor, scale: float) -> torch.Tensor:
    """`softmax(where(key_mask, scale q.k^T, -1e9)) v` by
    `ops.tf32.route`'s table."""
    _check(q, k, v, key_mask)
    cuda = q.device.type == "cuda"
    how = tf32.route("masked_attention", q.device.type,
                     (q.dtype, k.dtype, v.dtype),
                     cuda and torch.is_autocast_enabled("cuda"),
                     torch.backends.cuda.matmul.allow_tf32)
    if how == "plain":
        return masked_attention_plain(q, k, v, key_mask, scale)
    return masked_attention_kernel(q.float(), k.float(), v.float(), key_mask,
                                   scale, how == "kernel_float32")
