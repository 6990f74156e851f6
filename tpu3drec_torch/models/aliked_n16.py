"""ALIKED-n16, the published network, weight-compatible with its
checkpoints.

Port of `tpu3drec/models/aliked_n16.py` (c1..c4 = 16/32/64/128, dim 128,
K 3, M 16), with the reference's documented assumptions A1-A5:

- block1 [3x3 conv -> BN -> SELU] x 2 at full resolution; block2 a
  ResBlock after a 2x2 average pool; block3 and block4 ResBlocks with
  deformable 3x3 convolutions after 4x4 pools (1/8, 1/32); a ResBlock's
  shortcut is a bare 1x1 conv;
- a deformable conv (A1) has its own 3x3 offset conv giving a (dy, dx)
  per tap; each tap is a zero-padded bilinear gather of the input, and
  the nine taps are contracted with the kernel in one product (the card
  has no torchvision here, and its `deform_conv2d` would be a finished
  kernel anyway);
- per level a 1x1 conv (no bias) -> SELU -> bilinear upsample with
  align-corners matrices (the reference's own, so the same weights)
  to full resolution, concatenated into `dim` channels; the score head
  1x1 -> 3x3 -> 3x3 -> 3x3 with SELUs and a sigmoid;
- `extract` pads to a multiple of 32, takes the window maxima (radius 2),
  the top-k and the DKD soft-argmax over radius 2 at temperature 0.1;
  the SDDH head predicts M (x, y) offsets from each keypoint's 3x3 patch,
  samples the feature map there, maps the samples with a 1x1 conv and
  sums W_m f_m with the learned `agg` (M, dim, dim).

The network holds one full-resolution map: the four levels are
written, a slice of images at a time, straight into one channels-last
(B, H, W, dim) buffer (no list of levels, no concatenation); the score
head reads each slice (its 1x1 layer as a product on the buffer, its
3x3 layers on a small NCHW copy) before the slice is L2 normalised in
place, and SDDH and DKD read the buffer as it is, padding included,
without a copy. At 768x1024 that is 0.40 GB an image, where the four
levels, their concatenation and its normalised copy were 1.33 GB. The
backbone stays NCHW, where cuDNN's float32 convolutions are faster.

Every product here runs in full float32, both TF32 flags off inside the
forward (`_common.precision("highest")`): the reference pins each of
them at `Precision.HIGHEST`, so its `matmul_precision` changes nothing,
and the port's knob is accepted for the same signature.

While a profiler records, the forward and `extract` open the spans
`aliked.backbone` (blocks 1-4, with `aliked.deform` around each
deformable conv inside it), `aliked.head` (the per-level convs, the
upsampling into the map, the score head, the normalisation),
`aliked.select` (NMS, top-k, DKD) and `aliked.sddh`
(`utils/profiling.py:span`), and count `aliked.deform.samples` (B h w 9
taps a deformable conv) and `aliked.sddh.samples` (B N M).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu3drec_torch.core.types import DescriptorKind, Features
from tpu3drec_torch.models import _params
from tpu3drec_torch.models._common import (
    l2_normalize, local_peaks, precision, top_k_pixels, unbatch,
)
from tpu3drec_torch.utils.profiling import count, span, upload

CFG_N16 = dict(c1=16, c2=32, c3=64, c4=128, dim=128, K=3, M=16)
_BN_EPS = 1e-5
_TAPS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
# the head writes the map this many pixels (images x H x W) at a time
_HEAD_PIXELS = 1 << 23


def _bilinear_map(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                  size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Zero-padded bilinear samples of img (B, H, W, C), contiguous, at
    float pixel coordinates px, py (B, ...) -> (B, ..., C). `size` (h, w)
    bounds the map at img[:, :h, :w] (default the whole map)."""
    B, hp, wp, c = img.shape
    h, w = size or (hp, wp)
    flat = img.reshape(B, hp * wp, c)
    rows = torch.arange(B, device=img.device)[:, None]
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = px - x0
    fy = py - y0
    out = 0.0
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            xi = x0.long() + dx
            yi = y0.long() + dy
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            lin = torch.clamp(yi, 0, h - 1) * wp + torch.clamp(xi, 0, w - 1)
            v = flat[rows, lin.reshape(B, -1)].reshape(lin.shape + (c,))
            out = out + v * (wy * wx * ok.to(img.dtype))[..., None]
    return out


class _DeformConv3x3(nn.Module):
    """Deformable 3x3 conv (A1): an offset conv, then the kernel applied
    to the nine taps sampled at their offsets. NCHW in and out (the
    output channels-last in memory)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.offset_conv = nn.Conv2d(cin, 18, 3, padding=1)
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        B, cin, h, w = x.shape
        with span("aliked.deform"):
            count("aliked.deform.samples", B * h * w * 9)
            offs = self.offset_conv(x)              # (B, 18, H, W): (dy, dx)
            xh = x.permute(0, 2, 3, 1).contiguous()
            yy = torch.arange(h, dtype=x.dtype, device=x.device)[:, None]
            xx = torch.arange(w, dtype=x.dtype, device=x.device)[None, :]
            taps = torch.stack([                    # (B, H, W, 9, Cin)
                _bilinear_map(xh, xx + dx + offs[:, 2 * k + 1],
                              yy + dy + offs[:, 2 * k])
                for k, (dy, dx) in enumerate(_TAPS)], dim=3)
            kern = self.weight.permute(2, 3, 1, 0).reshape(9 * cin, -1)
            out = taps.reshape(B, h, w, 9 * cin) @ kern + self.bias
            return out.permute(0, 3, 1, 2)


def _bn(ch):
    return nn.BatchNorm2d(ch, eps=_BN_EPS)


class _ConvBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.bn1 = _bn(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.bn2 = _bn(cout)

    def forward(self, x):
        x = F.selu(self.bn1(self.conv1(x)))
        return F.selu(self.bn2(self.conv2(x)))


class _ResBlock(nn.Module):
    def __init__(self, cin, cout, deform: bool):
        super().__init__()
        conv = _DeformConv3x3 if deform else (
            lambda a, b: nn.Conv2d(a, b, 3, padding=1))
        self.conv1 = conv(cin, cout)
        self.bn1 = _bn(cout)
        self.conv2 = conv(cout, cout)
        self.bn2 = _bn(cout)
        self.downsample = nn.Conv2d(cin, cout, 1)     # bare 1x1 (A2)

    def forward(self, x):
        y = F.selu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.selu(y + self.downsample(x))


def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Align-corners linear interpolation from n_in to n_out samples."""
    if n_in == 1:
        return np.ones((n_out, 1), np.float32)
    src = np.linspace(0.0, n_in - 1.0, n_out)
    i0 = np.clip(np.floor(src).astype(int), 0, n_in - 2)
    f = (src - i0).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), i0] = 1.0 - f
    m[np.arange(n_out), i0 + 1] += f
    return m


_INTERP: Dict[tuple, torch.Tensor] = {}


def _interp(n_in: int, n_out: int, device) -> torch.Tensor:
    """`_interp_matrix` on `device`, uploaded once a shape and device."""
    key = (n_in, n_out, str(device))
    if key not in _INTERP:
        _INTERP[key] = upload(_interp_matrix(n_in, n_out), device)
    return _INTERP[key]


def _upsample_ac(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear, align_corners=True, as two products, rows then columns:
    (B, h, w, C) -> (B, out_h, out_w, C), channels-last throughout."""
    B, h, w, c = x.shape
    mh = _interp(h, out_h, x.device)
    mw = _interp(w, out_w, x.device)
    rows = torch.matmul(mh, x.reshape(B, h, w * c))          # (B, H, w C)
    return torch.matmul(mw, rows.reshape(B * out_h, w, c)).reshape(
        B, out_h, out_w, c)


class _SDDH(nn.Module):
    """Sparse deformable descriptor head."""

    def __init__(self, dim: int, K: int, M: int):
        super().__init__()
        self.K, self.M = K, M
        self.agg = nn.Parameter(torch.zeros(M, dim, dim))
        self.off1 = nn.Conv2d(dim, 2 * M, K)
        self.off2 = nn.Conv2d(2 * M, 2 * M, 1)
        self.sf = nn.Linear(dim, dim, bias=False)

    def forward(self, feat: torch.Tensor, xy: torch.Tensor,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """feat (B, H, W, dim) L2 normalised and contiguous, xy (B, N, 2)
        pixel keypoints -> (B, N, dim) unit descriptors. `size` (h, w)
        bounds the map at feat[:, :h, :w] (default the whole map)."""
        B, hp, wp, dim = feat.shape
        h, w = size or (hp, wp)
        K, r = self.K, self.K // 2
        count("aliked.sddh.samples", B * xy.shape[1] * self.M)
        xi = torch.clamp(torch.round(xy[..., 0]).long(), r, w - 1 - r)
        yi = torch.clamp(torch.round(xy[..., 1]).long(), r, h - 1 - r)
        lin = torch.stack([(yi + dy) * wp + (xi + dx)
                           for dy in range(-r, r + 1)
                           for dx in range(-r, r + 1)], dim=-1)   # (B, N, K*K)
        rows = torch.arange(B, device=feat.device)[:, None]
        patches = feat.reshape(B, hp * wp, dim)[rows, lin.reshape(B, -1)]
        patches = patches.reshape(B, -1, K * K * dim)
        # the K x K valid offset conv on a patch is one dense layer
        k1 = self.off1.weight.permute(2, 3, 1, 0).reshape(K * K * dim, -1)
        o = F.selu(patches @ k1 + self.off1.bias)
        o = o @ self.off2.weight[:, :, 0, 0].T + self.off2.bias   # (B, N, 2M)
        off = o.reshape(B, -1, self.M, 2)                        # (x, y) (A4)
        samp = _bilinear_map(feat, xy[..., None, 0] + off[..., 0],
                             xy[..., None, 1] + off[..., 1],
                             (h, w))                    # (B, N, M, dim)
        samp = self.sf(samp)
        desc = samp.reshape(B, -1, self.M * dim) @ self.agg.reshape(
            self.M * dim, dim)
        return l2_normalize(desc, -1)


class ALIKEDN16Net(nn.Module):
    """`forward((B, H, W, 3))`, H and W multiples of 32 -> (score
    (B, H, W) in [0, 1], feature map (B, H, W, dim) L2 normalised,
    contiguous): the reference's `forward_dense` on a batch; `sddh` its
    `sddh_descriptors`."""

    def __init__(self):
        super().__init__()
        c = CFG_N16
        c1, c2, c3, c4, dim = c["c1"], c["c2"], c["c3"], c["c4"], c["dim"]
        self.block1 = _ConvBlock(3, c1)
        self.block2 = _ResBlock(c1, c2, False)
        self.block3 = _ResBlock(c2, c3, True)
        self.block4 = _ResBlock(c3, c4, True)
        q = dim // 4
        for i, ch in enumerate((c1, c2, c3, c4), 1):
            setattr(self, f"conv{i}", nn.Conv2d(ch, q, 1, bias=False))
        self.score1 = nn.Conv2d(dim, 8, 1, bias=False)
        self.score2 = nn.Conv2d(8, 4, 3, padding=1, bias=False)
        self.score3 = nn.Conv2d(4, 4, 3, padding=1, bias=False)
        self.score4 = nn.Conv2d(4, 1, 3, padding=1)
        self.sddh = _SDDH(dim, c["K"], c["M"])

    def backbone(self, image: torch.Tensor) -> List[torch.Tensor]:
        """(B, H, W, 3) -> the four levels, NCHW."""
        x = image.permute(0, 3, 1, 2).contiguous()
        x1 = self.block1(x)
        x2 = self.block2(F.avg_pool2d(x1, 2))
        x3 = self.block3(F.avg_pool2d(x2, 4))
        x4 = self.block4(F.avg_pool2d(x3, 4))
        return [x1, x2, x3, x4]

    def head(self, levels: List[torch.Tensor]):
        """The levels -> (score (B, H, W), the map (B, H, W, dim)), a
        slice of images at a time: each level's 1x1 conv and SELU
        upsampled into its quarter of the map's channels, the score head
        on the slice (its 1x1 layer a product on the slice), then the
        slice normalised in place."""
        B, _, h, w = levels[0].shape
        q = self.conv1.weight.shape[0]
        feat = levels[0].new_empty(B, h, w, 4 * q)
        score = levels[0].new_empty(B, h, w)
        step = max(1, _HEAD_PIXELS // (h * w))
        convs = (self.conv1, self.conv2, self.conv3, self.conv4)
        for i0 in range(0, B, step):
            sl = slice(i0, i0 + step)
            for i, (conv, x) in enumerate(zip(convs, levels)):
                a = F.selu(conv(x[sl])).permute(0, 2, 3, 1)
                if i:
                    a = _upsample_ac(a.contiguous(), h, w)
                feat[sl, ..., i * q:(i + 1) * q] = a
            f = feat[sl]
            s = torch.matmul(f, self.score1.weight[:, :, 0, 0].T)
            s = F.selu(s).permute(0, 3, 1, 2).contiguous()
            s = F.selu(self.score2(s))
            s = F.selu(self.score3(s))
            score[sl] = torch.sigmoid(self.score4(s)[:, 0])
            f.div_(torch.clamp(torch.linalg.vector_norm(f, dim=-1,
                                                         keepdim=True),
                               min=1e-12))
        return score, feat

    def forward(self, image: torch.Tensor):
        with precision("highest"):
            with span("aliked.backbone"):
                levels = self.backbone(image)
            with span("aliked.head"):
                return self.head(levels)


class ALIKEDN16:
    """Inference wrapper: top-k keypoints with DKD sub-pixel refinement and
    SDDH descriptors."""

    def __init__(self, net: Optional[ALIKEDN16Net] = None,
                 max_features: int = 2048, nms_radius: int = 2,
                 threshold: float = 0.0,
                 matmul_precision: str = "default"):
        self.net = net
        self.max_features = max_features
        self.nms_radius = nms_radius
        self.threshold = threshold
        self.matmul_precision = matmul_precision

    def init_random(self, generator: torch.Generator) -> ALIKEDN16Net:
        """flax-style random parameters; `agg` normal with variance
        1 / (M dim), its fan-in."""
        net = _params.init_random(ALIKEDN16Net(), generator)
        agg = net.sddh.agg
        with torch.no_grad():
            agg.copy_(torch.randn(agg.shape, generator=generator)
                      / (agg.shape[0] * agg.shape[1]) ** 0.5)
        self.net = net.eval()
        return self.net

    @torch.no_grad()
    def extract(self, image: torch.Tensor) -> Features:
        """(H, W) or (B, H, W) float in [0, 1] -> Features."""
        if self.net is None:
            raise RuntimeError("ALIKED-n16 weights not loaded")
        single = image.ndim == 2
        x = image[None] if single else image
        h, w = x.shape[-2:]
        x = F.pad(x, (0, (-w) % 32, 0, (-h) % 32))[..., None].expand(
            -1, -1, -1, 3)
        score, feat = self.net(x)
        with span("aliked.select"):
            score = score[:, :h, :w]
            vals, xs, ys = top_k_pixels(
                local_peaks(score, self.nms_radius, -float("inf")),
                self.max_features)
            mask = vals > self.threshold
            # DKD soft-argmax over the radius-2 window at temperature 0.1
            r = 2
            flat = score.flatten(1)
            xi, yi = xs.long(), ys.long()
            num_x = torch.zeros_like(xs)
            num_y = torch.zeros_like(ys)
            den = torch.zeros_like(xs)
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    yy = torch.clamp(yi + dy, 0, h - 1)
                    xx = torch.clamp(xi + dx, 0, w - 1)
                    sv = torch.exp(flat.gather(1, yy * w + xx) / 0.1)
                    num_x += sv * dx
                    num_y += sv * dy
                    den += sv
            sub_x = torch.clamp(num_x / torch.clamp(den, min=1e-12), -r, r)
            sub_y = torch.clamp(num_y / torch.clamp(den, min=1e-12), -r, r)
            xy = torch.stack([xs + sub_x, ys + sub_y], -1)
        with span("aliked.sddh"), precision("highest"):
            desc = self.net.sddh(feat, xy, (h, w))
            f = Features(
                xy=xy, response=torch.where(mask, vals,
                                            torch.zeros_like(vals)),
                scale=torch.full_like(xs, 4.0), angle=torch.zeros_like(xs),
                desc=desc * mask[..., None], mask=mask,
                method="ALIKED", desc_kind=DescriptorKind.FLOAT.value,
                image_shape=(h, w))
        return unbatch(f) if single else f


# -- checkpoints (order-based, loud failures) -------------------------------

class _Cursor:
    def __init__(self, tensors: List[np.ndarray]):
        self.t = tensors
        self.i = 0

    def take(self, ndim=None, shape=None) -> np.ndarray:
        while self.i < len(self.t) and self.t[self.i].ndim == 0:
            self.i += 1          # num_batches_tracked scalars
        if self.i >= len(self.t):
            raise ValueError("state dict exhausted — topology mismatch")
        v = self.t[self.i]
        self.i += 1
        if ndim is not None and v.ndim != ndim:
            raise ValueError(f"tensor {self.i - 1}: ndim {v.ndim} != "
                             f"{ndim} (shape {v.shape})")
        if shape is not None and tuple(v.shape) != tuple(shape):
            raise ValueError(f"tensor {self.i - 1}: shape {v.shape} != "
                             f"{shape}")
        return v.astype(np.float32)

    def done(self):
        while self.i < len(self.t) and self.t[self.i].ndim == 0:
            self.i += 1
        if self.i != len(self.t):
            raise ValueError(f"{len(self.t) - self.i} unconsumed tensors")


def _cv(c: _Cursor, cin: int, cout: int, k: int, bias: bool) -> Dict:
    p = {"kernel": np.transpose(c.take(4, (cout, cin, k, k)), (2, 3, 1, 0))}
    if bias:
        p["bias"] = c.take(1, (cout,))
    return p


def _bnp(c: _Cursor, ch: int) -> Dict:
    return {k: c.take(1, (ch,)) for k in ("scale", "bias", "mean", "var")}


def _dcv(c: _Cursor, cin: int, cout: int) -> Dict:
    return {"offset_conv": _cv(c, cin, 18, 3, True), **_cv(c, cin, cout, 3, True)}


def load_torch_weights(state_dict: Dict[str, np.ndarray]) -> Dict:
    """An ALIKED-n16 state dict -> the reference's parameter tree,
    order-based as `tpu3drec/models/aliked_n16.py:load_torch_weights`
    (names ignored beyond their order, step counters skipped; a wrong
    topology fails on a count, a rank or a shape)."""
    cfg = CFG_N16
    c1, c2, c3, c4 = cfg["c1"], cfg["c2"], cfg["c3"], cfg["c4"]
    dim, K, M = cfg["dim"], cfg["K"], cfg["M"]
    c = _Cursor([np.asarray(v) for v in state_dict.values()])
    p: Dict[str, Dict] = {}
    p["block1"] = {"conv1": _cv(c, 3, c1, 3, True), "bn1": _bnp(c, c1),
                   "conv2": _cv(c, c1, c1, 3, True), "bn2": _bnp(c, c1)}
    p["block2"] = {"conv1": _cv(c, c1, c2, 3, True), "bn1": _bnp(c, c2),
                   "conv2": _cv(c, c2, c2, 3, True), "bn2": _bnp(c, c2),
                   "downsample": _cv(c, c1, c2, 1, True)}
    p["block3"] = {"conv1": _dcv(c, c2, c3), "bn1": _bnp(c, c3),
                   "conv2": _dcv(c, c3, c3), "bn2": _bnp(c, c3),
                   "downsample": _cv(c, c2, c3, 1, True)}
    p["block4"] = {"conv1": _dcv(c, c3, c4), "bn1": _bnp(c, c4),
                   "conv2": _dcv(c, c4, c4), "bn2": _bnp(c, c4),
                   "downsample": _cv(c, c3, c4, 1, True)}
    q = dim // 4
    for i, ch in enumerate((c1, c2, c3, c4), 1):
        p[f"conv{i}"] = _cv(c, ch, q, 1, False)
    p["score1"] = _cv(c, dim, 8, 1, False)
    p["score2"] = _cv(c, 8, 4, 3, False)
    p["score3"] = _cv(c, 4, 4, 3, False)
    p["score4"] = _cv(c, 4, 1, 3, True)
    # a module's own parameters come before its submodules': agg first
    p["sddh"] = {"agg": c.take(3, (M, dim, dim))}
    p["sddh"]["off1"] = _cv(c, dim, 2 * M, K, True)
    p["sddh"]["off2"] = _cv(c, 2 * M, 2 * M, 1, True)
    p["sddh"]["sf"] = {"kernel": c.take(4, (dim, dim, 1, 1))[:, :, 0, 0].T}
    c.done()
    return p


def convert_torch_checkpoint(path_in, path_out=None) -> Dict:
    """ALIKED-n16 .pth -> aliked.npz (format aliked-n16)."""
    from tpu3drec_torch import models
    sd = torch.load(path_in, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    params = load_torch_weights({k: v.numpy() for k, v in sd.items()})
    _params.write_npz(path_out or Path(models.WEIGHTS_DIR) / "aliked.npz",
                      params, format=np.asarray(["aliked-n16"]))
    return params


def save_weights(net: ALIKEDN16Net, path) -> None:
    """Write `net`'s parameters as aliked.npz, format aliked-n16."""
    _params.write_npz(path, _params.module_tree(net),
                      format=np.asarray(["aliked-n16"]))
