"""DISK: a thin U-Net with a heat map and 128-d descriptors.

Port of `tpu3drec/models/disk.py`. Kernel size 5, RGB input; down
channels 16-32-64-64-64 (block 0 at full resolution, blocks 1-4 after a
2x2 average pool), up channels 64-64-64-129 (nearest 2x upsample, concat
the skip, convolve). Each block is PReLU -> InstanceNorm (no affine) ->
5x5 conv; the first block convolves the image directly. Channels 0-127
are the descriptors (L2 normalised), channel 128 the heat.

As in the reference: the instance norm's variance is the biased one
(`jnp.var`; torch's `var` would default to the unbiased one), and
`extract` pads the image to a multiple of 16, so every upsample is an
exact 2x; peaks are the window maxima (radius 2) with -inf elsewhere,
then the top-k, and descriptors are read at the integer positions.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu3drec_torch.core.types import Features
from tpu3drec_torch.models import _params
from tpu3drec_torch.models._common import (
    integer_position_features, l2_normalize, local_peaks, precision,
    top_k_pixels,
)

DOWN = (16, 32, 64, 64, 64)
UP = (64, 64, 64, 129)
KSIZE = 5


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel spatial standardisation, biased variance."""
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mu) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


class _ThinBlock(nn.Module):
    """PReLU -> InstanceNorm -> 5x5 conv; `plain` convolves directly."""

    def __init__(self, cin: int, cout: int, plain: bool = False):
        super().__init__()
        if not plain:
            self.prelu = nn.Parameter(torch.full((1,), 0.25))
        self.plain = plain
        self.conv = nn.Conv2d(cin, cout, KSIZE, padding=KSIZE // 2)

    def forward(self, x):
        if not self.plain:
            x = _instance_norm(torch.where(x >= 0, x, self.prelu * x))
        return self.conv(x)


class DISKNet(nn.Module):
    """`forward((B, H, W, 3))`, H and W multiples of 16 -> (heat (B, H, W),
    desc (B, H, W, 128) L2 normalised): the reference's layouts."""

    def __init__(self, desc_dim: int = 128, first_block_plain: bool = True):
        super().__init__()
        self.desc_dim = desc_dim
        cin, skips = 3, []
        self.down = nn.ModuleList()
        for i, ch in enumerate(DOWN):
            self.down.append(_ThinBlock(cin, ch, plain=(
                i == 0 and first_block_plain)))
            cin = ch
            skips.append(ch)
        self.up = nn.ModuleList()
        for i, ch in enumerate(UP):
            self.up.append(_ThinBlock(cin + skips[len(DOWN) - 2 - i], ch))
            cin = ch

    def forward(self, x):
        h = x.permute(0, 3, 1, 2)
        skips = []
        for i, block in enumerate(self.down):
            if i > 0:
                h = F.avg_pool2d(h, 2, 2)
            h = block(h)
            skips.append(h)
        for i, block in enumerate(self.up):
            skip = skips[len(DOWN) - 2 - i]
            h = F.interpolate(h, size=skip.shape[-2:], mode="nearest")
            h = block(torch.cat([h, skip], dim=1))
        desc = l2_normalize(h[:, :self.desc_dim], 1)
        return h[:, self.desc_dim], desc.permute(0, 2, 3, 1)


class DISK:
    """Inference wrapper: padded top-k keypoints with descriptors;
    `matmul_precision` as in `models.superpoint.SuperPoint`."""

    def __init__(self, net: Optional[DISKNet] = None,
                 max_features: int = 2048, nms_radius: int = 2,
                 threshold: float = 0.0,
                 matmul_precision: str = "default"):
        self.net = net
        self.max_features = max_features
        self.nms_radius = nms_radius
        self.threshold = threshold
        self.matmul_precision = matmul_precision

    def init_random(self, generator: torch.Generator) -> DISKNet:
        self.net = _params.init_random(DISKNet(), generator).eval()
        return self.net

    @torch.no_grad()
    def dense(self, images: torch.Tensor):
        """(B, H, W, 3), H and W multiples of 16 -> (heat, desc)."""
        with precision(self.matmul_precision):
            return self.net(images)

    @torch.no_grad()
    def extract(self, image: torch.Tensor) -> Features:
        """(H, W) or (B, H, W) float in [0, 1] -> Features."""
        if self.net is None:
            raise RuntimeError("DISK weights not loaded")
        single = image.ndim == 2
        x = image[None] if single else image
        h, w = x.shape[-2:]
        x = F.pad(x, (0, (-w) % 16, 0, (-h) % 16))[..., None].expand(
            -1, -1, -1, 3)                       # grayscale -> RGB
        heat, desc = self.dense(x)
        scores, xs, ys = top_k_pixels(
            local_peaks(heat[:, :h, :w], self.nms_radius, -float("inf")),
            self.max_features)
        return integer_position_features(scores, xs, ys, desc, self.threshold,
                                         "DISK", (h, w), single)


# -- checkpoints ----------------------------------------------------------

def load_torch_weights(state_dict: Dict[str, np.ndarray],
                       first_block_plain: bool = True) -> Dict:
    """A DISK state dict -> the reference's flax variables, order-based
    as `tpu3drec/models/disk.py:load_torch_weights`: per block (down 0-4,
    then up 0-3) a PReLU slope (none for a plain first block), the conv
    kernel and its bias; names are ignored beyond their order, and a wrong
    topology fails on a count or a shape."""
    it = iter([np.asarray(v) for v in state_dict.values()])
    params: Dict[str, Dict] = {}

    def take_block(ch_out: int, plain: bool) -> Dict:
        p: Dict[str, np.ndarray] = {}
        t = next(it)
        if not plain:
            if t.ndim != 1 or t.size != 1:
                raise ValueError(f"expected PReLU slope, got shape {t.shape}")
            p["prelu"] = t.reshape(1).astype(np.float32)
            t = next(it)
        if t.ndim != 4:
            raise ValueError(f"expected conv kernel, got shape {t.shape}")
        if t.shape[0] != ch_out:
            raise ValueError(f"conv out {t.shape[0]} != expected {ch_out}")
        bias = next(it)
        if bias.shape != (ch_out,):
            raise ValueError(f"bad bias shape {bias.shape}")
        p["conv"] = {"kernel": np.transpose(t, (2, 3, 1, 0)).astype(np.float32),
                     "bias": bias.astype(np.float32)}
        return p

    for i, ch in enumerate(DOWN):
        params[f"down_{i}"] = take_block(ch, i == 0 and first_block_plain)
    for i, ch in enumerate(UP):
        params[f"up_{i}"] = take_block(ch, False)
    leftover = sum(1 for _ in it)
    if leftover:
        raise ValueError(f"{leftover} unconsumed tensors — topology mismatch")
    return {"params": params}


def convert_torch_checkpoint(path_in, path_out=None) -> Dict:
    """DISK .pth -> disk.npz in the weights directory."""
    from tpu3drec_torch import models
    sd = torch.load(path_in, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "extractor" in sd:   # the official format
        sd = sd["extractor"]
    params = load_torch_weights({k: v.numpy() for k, v in sd.items()})
    _params.write_npz(path_out or Path(models.WEIGHTS_DIR) / "disk.npz",
                      params["params"])
    return params


def save_weights(net: DISKNet, path) -> None:
    """Write `net`'s parameters as disk.npz (the reference's layout)."""
    _params.write_npz(path, _params.module_tree(net))


def _build(tree, extras) -> DISKNet:
    return _params.load_tree(DISKNet(), tree)


def detect_disk_features(img: torch.Tensor, max_features: int = 2048,
                         **_unused) -> Features:
    """Detector contract; needs converted weights on disk."""
    from tpu3drec_torch import models
    if not models.weights_available("disk"):
        raise ImportError(
            f"disk weights not available ({models.WEIGHTS_DIR}/disk.npz)")
    net = _params.cached_module(Path(models.WEIGHTS_DIR) / "disk.npz", _build,
                                img.device)
    return DISK(net, max_features=max_features).extract(img)
