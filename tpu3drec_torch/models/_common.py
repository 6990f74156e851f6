"""What the deep models share: the reference wrappers' construction-time
knobs (`matmul_precision`, `activation_dtype`), window maxima, the top-k
of a score map and the Features of its peaks."""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F

from tpu3drec_torch.core.types import DescriptorKind, Features
from tpu3drec_torch.ops.harris import topk_stable

PRECISIONS = ("default", "highest")


@contextlib.contextmanager
def precision(matmul_precision: str):
    """The reference's `jax.default_matmul_precision` around a forward:
    "default" lets the card run float32 convolutions and matmuls in TF32
    (the reduced-precision deep path); "highest" turns both TF32 flags
    off, for full float32 whatever the caller set. The package-wide TF32
    flags are restored on exit, whatever happens inside. On the CPU both
    are float32."""
    if matmul_precision not in PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {PRECISIONS}, "
                         f"got {matmul_precision!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32 = matmul_precision == "default"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def activation_dtype(name: str) -> torch.dtype:
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"activation_dtype must be float32 or bfloat16, "
                         f"got {name!r}")
    return getattr(torch, name)


def activations(dtype: torch.dtype, device: torch.device):
    """bfloat16 activations for the convolutions and matmuls inside (the
    parameters stay float32), as flax's `dtype=bfloat16`."""
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=dtype == torch.bfloat16)


def local_peaks(x: torch.Tensor, radius: int, fill: float) -> torch.Tensor:
    """x (B, H, W) where it is the maximum of its (2r+1)^2 window
    (`lax.reduce_window(x, -inf, max, ..., "SAME")`), `fill` elsewhere."""
    pooled = F.max_pool2d(x[:, None], 2 * radius + 1, stride=1,
                          padding=radius)[:, 0]
    return torch.where(x >= pooled, x, torch.full_like(x, fill))


def top_k_pixels(score: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`lax.top_k` over each flattened `(H, W)` map of `(B, H, W)`, ties to
    the lower index: (values, x, y), each (B, k), x and y float32."""
    w = score.shape[-1]
    vals, idx = topk_stable(score.flatten(1), k)
    return (vals, (idx % w).to(torch.float32),
            torch.div(idx, w, rounding_mode="floor").to(torch.float32))


def l2_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x / max(|x|, 1e-12) along `dim`."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                           min=1e-12)


def unbatch(f: Features) -> Features:
    """The one image of a batch of one."""
    return f.replace(xy=f.xy[0], response=f.response[0], scale=f.scale[0],
                     angle=f.angle[0], desc=f.desc[0], mask=f.mask[0])


def integer_position_features(scores, xs, ys, desc, threshold, method,
                              shape, single, xy=None) -> Features:
    """Features of top-k peaks whose descriptors are read at the integer
    positions (DISK, ALIKED): `xy` defaults to (xs, ys)."""
    h, w = shape
    mask = scores > threshold
    xi = torch.clamp(xs.long(), 0, w - 1)
    yi = torch.clamp(ys.long(), 0, h - 1)
    b = torch.arange(desc.shape[0], device=desc.device)[:, None]
    v = desc[b, yi, xi]
    f = Features(
        xy=torch.stack([xs, ys], -1) if xy is None else xy,
        response=torch.where(mask, scores, torch.zeros_like(scores)),
        scale=torch.full_like(xs, 4.0), angle=torch.zeros_like(xs),
        desc=v * mask[..., None], mask=mask, method=method,
        desc_kind=DescriptorKind.FLOAT.value, image_shape=(h, w))
    return unbatch(f) if single else f
