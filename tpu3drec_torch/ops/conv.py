"""Channels-last convolution with its bias, ReLU and 2x2 max pool, in two
forms: the plain PyTorch composition and the one-pass kernel
`csrc/conv_nhwc.cu`.

`conv2d_nhwc(x, weight, bias, relu, pool)` takes x (B, H, W, Cin), a
`nn.Conv2d` weight (Cout, Cin, k, k) with k 1 or 3 and "same" padding, and
a bias (Cout) or None, and returns (B, H, W, Cout), or (B, H / 2, W / 2,
Cout) after a 2x2 max pool (a last odd row or column left out). The route
is `ops.tf32.route`'s table, on cuDNN's TF32 flag
(`torch.backends.cudnn.allow_tf32`, the flag that governs the plain
form's convolutions): the plain form on the CPU, the kernel in TF32 or,
with the flag off, in 3xTF32 on the card. The kernel also raises on Cin
neither 1 nor a multiple of 4, and at Cin 1 on anything but a 3x3
convolution without the pool (SuperPoint's first layer) with Cout a
multiple of 4 up to 1024.

The kernel takes the weights K-major, (Cout, k, k, Cin); the wrapper
reorders them at each call (SuperPoint's 1.3 M parameters, a few
microseconds). Its launches are counted on `conv_nhwc.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from tpu3drec_torch import _nvcc
from tpu3drec_torch.ops import tf32
from tpu3drec_torch.ops.tf32 import LIMIT_FACTOR, split_round, tf32_round


def conv2d_nhwc_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor], relu: bool = False,
                      pool: bool = False) -> torch.Tensor:
    """The plain form: `F.conv2d` on the NCHW view of x (channels-last in
    memory, which PyTorch's convolutions keep), the ReLU and `max_pool2d`,
    returned as an NHWC view. No layout copy, so a chain of calls gives the
    bits of the same chain of `nn.Conv2d` modules on the NCHW view."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias,
                 padding=weight.shape[-1] // 2)
    if relu:
        y = F.relu(y, inplace=True)
    if pool:
        y = F.max_pool2d(y, 2, 2)
    return y.permute(0, 2, 3, 1)


def float64_answer_and_limit(x: torch.Tensor, weight: torch.Tensor,
                             bias: Optional[torch.Tensor], relu: bool,
                             pool: bool, full_float32: bool = False):
    """The exact answer (the plain form in float64) and how far from it the
    kernel may be, largest over all elements: `LIMIT_FACTOR` times the
    largest of three errors measured on the same operands, as
    `ops.attention.float64_answer_and_limit` has them: the plain form's in
    the kernel's precision (cuDNN's TF32 flag on, or off for
    `full_float32`); the exact answer's on x and the weights rounded as the
    kernel reads them (`tf32_round`, `split_round`); and 2^-23 of the
    largest sum of magnitudes an output is made of, which a float32 sum in
    any order costs. A dropped bias or ReLU, a pool window off by a pixel
    or a halo read as zero moves the output by far more."""
    def exact(a, w, b):
        return conv2d_nhwc_plain(a.double(), w.double(),
                                 None if b is None else b.double(), relu, pool)

    want = exact(x, weight, bias)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = not full_float32
    try:
        plain = conv2d_nhwc_plain(x, weight, bias, relu, pool)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    err_plain = float((plain.double() - want).abs().max())
    del plain
    rnd = split_round if full_float32 else tf32_round
    err_rounded = float((exact(rnd(x), rnd(weight), bias) - want).abs().max())
    mag = F.conv2d(x.permute(0, 3, 1, 2).double().abs(),
                   weight.double().abs(),
                   None if bias is None else bias.double().abs(),
                   padding=weight.shape[-1] // 2)
    err_sum = 2.0 ** -23 * float(mag.max())
    return want, LIMIT_FACTOR * max(err_plain, err_rounded, err_sum)


def kernel_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, k, k) -> the kernel's K-major (Cout, k, k, Cin),
    float32, contiguous."""
    return weight.detach().float().permute(0, 2, 3, 1).contiguous()


_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,)


def conv2d_nhwc_kernel(x: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor], relu: bool = False,
                       pool: bool = False, full_float32: bool = False
                       ) -> torch.Tensor:
    """The kernel's route for CUDA float32 operands: one launch of
    `csrc/conv_nhwc.cu` on the current stream, in TF32 or, with
    `full_float32`, 3xTF32, counted on `conv_nhwc.launches`."""
    B, H, W, cin = x.shape
    cout, k = weight.shape[0], weight.shape[-1]
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        raise TypeError(f"conv_nhwc: the kernel takes float32 operands, got "
                        f"{x.dtype}, {weight.dtype}")
    if cin != 1 and cin % 4:
        raise ValueError(f"conv_nhwc: the kernel takes Cin 1 or a multiple "
                         f"of 4, got {cin}")
    if cin == 1 and (k != 3 or pool or cout % 4 or cout > 1024):
        raise ValueError(f"conv_nhwc: at Cin 1 the kernel takes a 3x3 "
                         f"convolution without the pool and Cout a multiple "
                         f"of 4 up to 1024, got {k}x{k}, pool {pool}, Cout "
                         f"{cout}")
    x = _nvcc.aligned16(x.contiguous())
    w = kernel_weight(weight)
    b = (torch.zeros(cout, dtype=torch.float32, device=x.device)
         if bias is None else bias.detach().float().contiguous())
    b = _nvcc.aligned16(b)
    ho, wo = (H // 2, W // 2) if pool else (H, W)
    y = torch.empty((B, ho, wo, cout), dtype=torch.float32, device=x.device)
    _nvcc.launch("conv_nhwc", "conv_nhwc_launch", _ARGTYPES, x.device,
                 x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, H,
                 W, cin, cout, k, int(relu), int(pool), int(full_float32))
    return y


def _check(x, weight, bias) -> None:
    if x.ndim != 4 or weight.ndim != 4:
        raise ValueError(f"conv_nhwc: need x (B, H, W, Cin) and a weight "
                         f"(Cout, Cin, k, k), got {tuple(x.shape)}, "
                         f"{tuple(weight.shape)}")
    cout, cin, kh, kw = weight.shape
    if kh != kw or kh not in (1, 3) or cin != x.shape[3]:
        raise ValueError(f"conv_nhwc: need a 1x1 or 3x3 weight over the "
                         f"{x.shape[3]} input channels, got "
                         f"{tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"conv_nhwc: need a ({cout},) bias, got "
                         f"{tuple(bias.shape)}")
    tensors = (x, weight) if bias is None else (x, weight, bias)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("conv_nhwc: operands on several devices")


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, relu: bool = False,
                pool: bool = False) -> torch.Tensor:
    """The convolution, its bias, ReLU and pool, by `ops.tf32.route`'s
    table on cuDNN's TF32 flag."""
    _check(x, weight, bias)
    cuda = x.device.type == "cuda"
    how = tf32.route("conv_nhwc", x.device.type, (x.dtype, weight.dtype),
                     cuda and torch.is_autocast_enabled("cuda"),
                     torch.backends.cudnn.allow_tf32)
    if how == "plain":
        return conv2d_nhwc_plain(x, weight, bias, relu, pool)
    return conv2d_nhwc_kernel(x.float(), weight.float(), bias, relu, pool,
                              how == "kernel_float32")
