"""What the port's TF32 kernels (`masked_attention`, `conv_nhwc`) share:
their route table, how they round their operands, and the factor their
float64 limits take.

The route follows what a call can observe:

- CPU tensors: the plain form;
- CUDA float32 with the TF32 flag that governs the plain form on (cuBLAS's
  for the attention, cuDNN's for the convolution; both are on under the
  deep models' `matmul_precision="default"`): the kernel with TF32
  operands and float32 accumulators, as the library computes the plain
  form then;
- CUDA float32 with that flag off (`"highest"`): the kernel in full
  float32, each product split into three TF32 products (3xTF32);
- CUDA bfloat16 operands or calls under autocast (the deep models'
  `activation_dtype="bfloat16"`): the TF32 kernel on the operands read as
  float32; a bfloat16 value is exact in TF32, so this is at least as
  precise as bfloat16 arithmetic. The output is float32 on every kernel
  route;
- anything else raises: another dtype or device.
"""

from __future__ import annotations

import torch

from tpu3drec_torch import _nvcc

# a kernel's float64 limit is this many times the largest of the errors
# measured beside it (each wrapper's `float64_answer_and_limit`)
LIMIT_FACTOR = 4.0


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 `t` rounded to TF32 (10 stored mantissa bits; to nearest,
    ties away from zero, as `cvt.rna.tf32.f32` rounds), held in float32."""
    return t.contiguous().view(torch.int32).add(0x1000).bitwise_and(
        -0x2000).view(torch.float32)


def split_round(t: torch.Tensor) -> torch.Tensor:
    """float32 `t` as a full float32 kernel reads it: hi + lo with
    hi = tf32(t) and lo = tf32(t - hi), 22 significant bits."""
    hi = tf32_round(t)
    return hi + tf32_round(t - hi)


def route(what: str, device_type: str, dtypes, autocast: bool,
          allow_tf32: bool) -> str:
    """"plain", "kernel" (TF32) or "kernel_float32" (3xTF32) for a call of
    the kernel `what` on `device_type` with operands of `dtypes`, CUDA
    autocast on or off and the TF32 flag, by the table in the module
    docstring; raises on what neither form takes."""
    if _nvcc.route(what, device_type) == "plain":
        return "plain"
    if any(d not in (torch.float32, torch.bfloat16) for d in dtypes):
        raise TypeError(f"{what}: need float32 or bfloat16 operands, got "
                        f"{tuple(dtypes)}")
    if allow_tf32 or autocast or torch.bfloat16 in dtypes:
        return "kernel"
    return "kernel_float32"
