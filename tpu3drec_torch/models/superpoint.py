"""SuperPoint: VGG encoder with a detector and a descriptor head.

Port of `tpu3drec/models/superpoint.py`. The encoder is 64-64-64-64-128-
128-128-128 3x3 convolutions with three 2x2 max pools; the detector head
is a 65-channel cell softmax (8x8 cells and a dustbin) put back to full
resolution, the descriptor head a 256-d map at 1/8 resolution, L2
normalised. As in the reference:

- the non-maximum suppression is one max pool over (2r+1)^2 windows with
  -inf padding (`_simple_nms`), not the published iterative NMS;
- `extract` pads the image to a multiple of 8, takes the top-k of the
  flattened heat (ties to the lower index) and samples the descriptor map
  bilinearly at `x / 8 - 0.5`, clipped to `dw - 1.001`.

`detect_superpoint_features` is the registry entry: one `(H, W)` image or
a `(B, H, W)` batch, run on the tensor's device with the converted
weights in `WEIGHTS_DIR/superpoint.npz`.

While a profiler records, `extract` runs under the spans
`superpoint.encoder` (the VGG encoder), `superpoint.heads` (both
heads, the cell softmax, the NMS) and `superpoint.select` (top-k,
descriptor sampling), each opened by `utils/profiling.py:span`.

The network runs channels-last: every convolution goes through
`ops/conv.py:conv2d_nhwc` (on the card one launch of `csrc/conv_nhwc.cu`
with its bias, ReLU and pool, 12 a forward), the cell softmax runs over
the last axis and the pixel shuffle is a reshape of the (B, h, w, 64)
probabilities.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu3drec_torch.core.types import DescriptorKind, Features
from tpu3drec_torch.models import _params
from tpu3drec_torch.models._common import (
    activation_dtype as dtype_named, activations, l2_normalize, local_peaks,
    precision, top_k_pixels, unbatch,
)
from tpu3drec_torch.ops.conv import conv2d_nhwc
from tpu3drec_torch.utils.profiling import span

_CONVS = (("conv1a", 1, 64), ("conv1b", 64, 64), ("conv2a", 64, 64),
          ("conv2b", 64, 64), ("conv3a", 64, 128), ("conv3b", 128, 128),
          ("conv4a", 128, 128), ("conv4b", 128, 128))


class SuperPointNet(nn.Module):
    """Encoder and heads. `forward((B, H, W, 1))` with H, W multiples of 8
    -> (heat (B, H, W) float32, desc (B, H/8, W/8, 256) float32, L2
    normalised): the reference's layouts. Under bfloat16 activations the
    heads' softmax and normalisation still run in float32."""

    def __init__(self, desc_dim: int = 256):
        super().__init__()
        for name, cin, cout in _CONVS:
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))
        self.convPa = nn.Conv2d(128, 256, 3, padding=1)
        self.convPb = nn.Conv2d(256, 65, 1)
        self.convDa = nn.Conv2d(128, 256, 3, padding=1)
        self.convDb = nn.Conv2d(256, desc_dim, 1)

    def _conv(self, name: str, x: torch.Tensor, relu: bool = False,
              pool: bool = False) -> torch.Tensor:
        conv = getattr(self, name)
        return conv2d_nhwc(x, conv.weight, conv.bias, relu, pool)

    def forward(self, x: torch.Tensor):
        # channels-last from end to end: each convolution writes its
        # output once, with its bias, ReLU and pool (`ops/conv.py`)
        with span("superpoint.encoder"):
            for i, (name, _, _) in enumerate(_CONVS):
                x = self._conv(name, x, relu=True, pool=i in (1, 3, 5))
        with span("superpoint.heads"):
            semi = self._conv("convPb", self._conv("convPa", x, relu=True))
            prob = torch.softmax(semi.float(), dim=-1)[..., :64]
            B, h, w, _ = prob.shape                       # cell c = 8 r + s
            heat = prob.reshape(B, h, w, 8, 8).permute(0, 1, 3, 2, 4)
            desc = self._conv("convDb", self._conv("convDa", x, relu=True))
            return (heat.reshape(B, 8 * h, 8 * w),
                    l2_normalize(desc.float(), -1))


def _sample_descriptors(desc: torch.Tensor, xs: torch.Tensor,
                        ys: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of `desc` (B, dh, dw, D) at pixel keypoints (B, K),
    the reference's clipping, L2 normalised: (B, K, D)."""
    _, dh, dw, _ = desc.shape
    gx = torch.clamp(xs / 8.0 - 0.5, 0, dw - 1.001)
    gy = torch.clamp(ys / 8.0 - 0.5, 0, dh - 1.001)
    x0 = torch.floor(gx).long()
    y0 = torch.floor(gy).long()
    fx = (gx - x0)[..., None]
    fy = (gy - y0)[..., None]
    x1 = torch.clamp(x0 + 1, max=dw - 1)
    y1 = torch.clamp(y0 + 1, max=dh - 1)
    b = torch.arange(desc.shape[0], device=desc.device)[:, None]
    v = ((1 - fy) * (1 - fx) * desc[b, y0, x0]
         + (1 - fy) * fx * desc[b, y0, x1]
         + fy * (1 - fx) * desc[b, y1, x0]
         + fy * fx * desc[b, y1, x1])
    return l2_normalize(v, -1)


class SuperPoint:
    """Inference wrapper: padded top-k keypoints with descriptors.

    `matmul_precision` and `activation_dtype` are fixed at construction,
    as in the reference: "default" runs the network's convolutions in TF32
    on the card, "highest" in full float32; "bfloat16" activations keep
    the parameters in float32."""

    def __init__(self, net: Optional[SuperPointNet] = None,
                 max_features: int = 2048,
                 keypoint_threshold: float = 0.005,
                 nms_radius: int = 4,
                 matmul_precision: str = "default",
                 activation_dtype: str = "float32"):
        self.net = net
        self.max_features = max_features
        self.keypoint_threshold = keypoint_threshold
        self.nms_radius = nms_radius
        self.matmul_precision = matmul_precision
        self.dtype = dtype_named(activation_dtype)

    def init_random(self, generator: torch.Generator) -> SuperPointNet:
        self.net = _params.init_random(SuperPointNet(), generator).eval()
        return self.net

    @torch.no_grad()
    def dense(self, images: torch.Tensor):
        """(B, H, W, 1), H and W multiples of 8 -> (heat after NMS,
        desc): the reference's `_forward`."""
        with precision(self.matmul_precision), \
                activations(self.dtype, images.device):
            heat, desc = self.net(images)
        with span("superpoint.heads"):
            return local_peaks(heat, self.nms_radius, 0.0), desc

    @torch.no_grad()
    def extract(self, image: torch.Tensor) -> Features:
        """(H, W) or (B, H, W) float in [0, 1] -> Features padded to
        max_features (with a leading batch axis for a batch)."""
        if self.net is None:
            raise RuntimeError(
                "SuperPoint weights not loaded; call init_random() for "
                "testing or convert a checkpoint")
        single = image.ndim == 2
        x = image[None] if single else image
        h, w = x.shape[-2:]
        x = F.pad(x, (0, (-w) % 8, 0, (-h) % 8))[..., None]
        heat, desc = self.dense(x)
        with span("superpoint.select"):
            scores, xs, ys = top_k_pixels(heat[:, :h, :w], self.max_features)
            mask = scores > self.keypoint_threshold
            v = _sample_descriptors(desc, xs, ys)
            feats = Features(
                xy=torch.stack([xs, ys], -1),
                response=torch.where(mask, scores, torch.zeros_like(scores)),
                scale=torch.full_like(scores, 8.0),
                angle=torch.zeros_like(scores),
                desc=v * mask[..., None], mask=mask,
                method="SuperPoint", desc_kind=DescriptorKind.FLOAT.value,
                image_shape=(h, w))
        return unbatch(feats) if single else feats


# -- checkpoints ----------------------------------------------------------

def load_torch_weights(state_dict: Dict[str, Any]) -> Dict:
    """A published SuperPoint state dict (the names this module uses) ->
    the reference's flax variables {"params": tree}."""
    names = [n for n, _, _ in _CONVS] + ["convPa", "convPb", "convDa", "convDb"]
    sd = {}
    for n in names:
        if f"{n}.weight" not in state_dict:
            raise KeyError(f"missing {n}.weight in checkpoint")
        for leaf in ("weight", "bias"):
            sd[f"{n}.{leaf}"] = torch.as_tensor(
                np.asarray(state_dict[f"{n}.{leaf}"]))
    return {"params": _params.state_dict_to_tree(sd)}


def convert_torch_checkpoint(path_in, path_out=None) -> Dict:
    """superpoint_v1.pth -> superpoint.npz in the weights directory."""
    from tpu3drec_torch import models
    sd = torch.load(path_in, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    params = load_torch_weights(sd)
    _params.write_npz(path_out or Path(models.WEIGHTS_DIR) / "superpoint.npz",
                      params["params"], wrap=True)
    return params


def save_weights(net: SuperPointNet, path) -> None:
    """Write `net`'s parameters as superpoint.npz (the reference's layout)."""
    _params.write_npz(path, _params.module_tree(net), wrap=True)


def _build(tree, extras) -> SuperPointNet:
    return _params.load_tree(SuperPointNet(), tree)


def detect_superpoint_features(img: torch.Tensor, max_features: int = 2048,
                               keypoint_threshold: float = 0.005,
                               nms_radius: int = 4, **_unused) -> Features:
    """Detector contract; needs converted weights on disk."""
    from tpu3drec_torch import models
    if not models.weights_available("superpoint"):
        raise ImportError("superpoint weights not available "
                          f"(expected {models.WEIGHTS_DIR}/superpoint.npz)")
    net = _params.cached_module(Path(models.WEIGHTS_DIR) / "superpoint.npz",
                                _build, img.device)
    return SuperPoint(net, max_features=max_features,
                      keypoint_threshold=keypoint_threshold,
                      nms_radius=nms_radius).extract(img)
