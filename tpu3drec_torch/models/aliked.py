"""ALIKED, the reference's approximation of it, and the detector entry.

Port of `tpu3drec/models/aliked.py`: three 3x3 branches at dilations 1,
2 and 4 (SAME), concatenated, two 3x3 convolutions, a 1x1 heat head and
a 128-d 1x1 descriptor head (L2 normalised). Every activation is flax's
`nn.gelu`, which is the tanh approximation (torch's default GELU is the
exact one). `extract` takes the window maxima (radius 2, -inf elsewhere),
the top-k, a 3x3 parabolic sub-pixel offset (clipped to half a pixel) and
the descriptors at the integer positions; the image is not padded.

The convolutions are named as flax names them (`Conv_0` .. `Conv_6` in
call order), a `ModuleList` `Conv` here, so checkpoints carry across.

`detect_aliked_features` reads `WEIGHTS_DIR/aliked.npz`: a file whose
`format` is `aliked-n16` holds the published network
(`models.aliked_n16`), any other this approximation.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu3drec_torch.core.types import Features
from tpu3drec_torch.models import _params
from tpu3drec_torch.models._common import (
    integer_position_features, l2_normalize, local_peaks, top_k_pixels,
)


class ALIKEDNet(nn.Module):
    """`forward((B, H, W, 1))` -> (heat (B, H, W), desc (B, H, W, 128))."""

    def __init__(self, desc_dim: int = 128, base: int = 16):
        super().__init__()
        self.Conv = nn.ModuleList(
            [nn.Conv2d(1, base, 3, padding=d, dilation=d) for d in (1, 2, 4)]
            + [nn.Conv2d(3 * base, 4 * base, 3, padding=1),
               nn.Conv2d(4 * base, 4 * base, 3, padding=1),
               nn.Conv2d(4 * base, 1, 1),
               nn.Conv2d(4 * base, desc_dim, 1)])

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        c = self.Conv
        h = torch.cat([F.gelu(c[i](x), approximate="tanh") for i in range(3)],
                      dim=1)
        h = F.gelu(c[3](h), approximate="tanh")
        h = F.gelu(c[4](h), approximate="tanh")
        desc = l2_normalize(c[6](h), 1)
        return c[5](h)[:, 0], desc.permute(0, 2, 3, 1)


def _parabolic_offset(lo, mid, hi):
    """-0.5 (hi - lo) / (hi + lo - 2 mid) where the curvature is above
    1e-9 in magnitude, else 0; clipped to half a pixel."""
    num = hi - lo
    den = hi + lo - 2 * mid
    ok = torch.abs(den) > 1e-9
    off = torch.where(ok, -0.5 * num / torch.where(ok, den, torch.ones_like(den)),
                      torch.zeros_like(den))
    return torch.clamp(off, -0.5, 0.5)


class ALIKED:
    """Inference wrapper (float32; the reference has no precision knob)."""

    def __init__(self, net: Optional[ALIKEDNet] = None,
                 max_features: int = 2048, nms_radius: int = 2,
                 threshold: float = 0.0):
        self.net = net
        self.max_features = max_features
        self.nms_radius = nms_radius
        self.threshold = threshold

    def init_random(self, generator: torch.Generator) -> ALIKEDNet:
        self.net = _params.init_random(ALIKEDNet(), generator).eval()
        return self.net

    @torch.no_grad()
    def extract(self, image: torch.Tensor) -> Features:
        """(H, W) or (B, H, W) float in [0, 1] -> Features."""
        if self.net is None:
            raise RuntimeError("ALIKED weights not loaded")
        single = image.ndim == 2
        x = image[None] if single else image
        h, w = x.shape[-2:]
        heat, desc = self.net(x[..., None])
        scores, xs, ys = top_k_pixels(
            local_peaks(heat, self.nms_radius, -float("inf")),
            self.max_features)
        flat = heat.flatten(1)
        xi, yi = xs.long(), ys.long()

        def nb(dy, dx):
            yy = torch.clamp(yi + dy, 0, h - 1)
            xx = torch.clamp(xi + dx, 0, w - 1)
            return flat.gather(1, yy * w + xx)

        off_x = _parabolic_offset(nb(0, -1), nb(0, 0), nb(0, 1))
        off_y = _parabolic_offset(nb(-1, 0), nb(0, 0), nb(1, 0))
        return integer_position_features(
            scores, xs, ys, desc, self.threshold, "ALIKED", (h, w), single,
            xy=torch.stack([xs + off_x, ys + off_y], -1))


def save_weights(net: ALIKEDNet, path) -> None:
    """Write `net`'s parameters as aliked.npz (the reference's layout)."""
    _params.write_npz(path, _params.module_tree(net), wrap=True)


def _build(tree, extras) -> nn.Module:
    if "format" in extras and str(extras["format"][0]) == "aliked-n16":
        from tpu3drec_torch.models.aliked_n16 import ALIKEDN16Net
        return _params.load_tree(ALIKEDN16Net(), tree)
    return _params.load_tree(ALIKEDNet(), tree)


def detect_aliked_features(img: torch.Tensor, max_features: int = 2048,
                           **_unused) -> Features:
    """Detector contract; needs converted weights on disk."""
    from tpu3drec_torch import models
    if not models.weights_available("aliked"):
        raise ImportError(
            f"aliked weights not available ({models.WEIGHTS_DIR}/aliked.npz)")
    net = _params.cached_module(Path(models.WEIGHTS_DIR) / "aliked.npz",
                                _build, img.device)
    if isinstance(net, ALIKEDNet):
        return ALIKED(net, max_features=max_features).extract(img)
    from tpu3drec_torch.models.aliked_n16 import ALIKEDN16
    return ALIKEDN16(net, max_features=max_features).extract(img)
