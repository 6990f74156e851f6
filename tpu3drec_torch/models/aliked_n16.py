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

The network holds one full-resolution map, channels-last (B, H, W,
dim), which SDDH and DKD read as it is, padding included, without a
copy. The head (`ALIKEDN16Net.head`) has two forms. The plain form
(`head_plain`, on CPU tensors) writes the four levels, a slice of images
at a time, straight into the map (no list of levels, no concatenation);
score1 reads each slice (a product on the map) into a small NCHW output
before the slice is L2 normalised in place. The kernel (`head_kernel`,
on CUDA float32 tensors; `csrc/aliked_head.cu`) computes the four
levels' 1x1 convs and SELUs, the upsampling, score1 and its SELU and the
normalisation in one launch, writing the normalised map and score1's
output once. In both, the score head's 3x3 layers and the sigmoid then
run on score1's output a slice of images at a time. At 768x1024 the map
is 0.40 GB an image, where the four levels, their concatenation and its
normalised copy were 1.33 GB. The backbone stays NCHW, where cuDNN's
float32 convolutions are faster.

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
taps a deformable conv) and `aliked.sddh.samples` (B N M). The head's
kernel launches are counted on `aliked_head.launches`, always.
"""

from __future__ import annotations

import copy
import ctypes
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu3drec_torch import _nvcc
from tpu3drec_torch.core.types import DescriptorKind, Features
from tpu3drec_torch.models import _params
from tpu3drec_torch.models._common import (
    l2_normalize, local_peaks, precision, top_k_pixels, unbatch,
)
from tpu3drec_torch.ops.tf32 import LIMIT_FACTOR
from tpu3drec_torch.utils.profiling import count, span, upload

CFG_N16 = dict(c1=16, c2=32, c3=64, c4=128, dim=128, K=3, M=16)
_BN_EPS = 1e-5
_TAPS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
# the plain head writes the map, and both forms run the score head's 3x3
# layers, this many pixels (images x H x W) at a time
_HEAD_PIXELS = 1 << 23


def _slices(B: int, h: int, w: int):
    """Slices of B images of h x w, _HEAD_PIXELS pixels or one image
    each."""
    step = max(1, _HEAD_PIXELS // (h * w))
    return [slice(i0, i0 + step) for i0 in range(0, B, step)]


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


def _interp_taps(n_in: int, n_out: int):
    """Align-corners linear interpolation from n_in to n_out samples as
    each output's two taps: (i0, i1, w0, w1), indices int64 and weights
    float32 (n_out,); i1 = i0 + 1, or i0 with w1 = 0 where n_in is 1."""
    if n_in == 1:
        zero = np.zeros(n_out, np.int64)
        return (zero, zero, np.ones(n_out, np.float32),
                np.zeros(n_out, np.float32))
    src = np.linspace(0.0, n_in - 1.0, n_out)
    i0 = np.clip(np.floor(src).astype(int), 0, n_in - 2)
    f = (src - i0).astype(np.float32)
    return i0, i0 + 1, 1.0 - f, f


def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Align-corners linear interpolation from n_in to n_out samples."""
    i0, i1, w0, w1 = _interp_taps(n_in, n_out)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), i0] = w0
    m[np.arange(n_out), i1] += w1
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
    mh = _interp(h, out_h, x.device).to(x.dtype)
    mw = _interp(w, out_w, x.device).to(x.dtype)
    rows = torch.matmul(mh, x.reshape(B, h, w * c))          # (B, H, w C)
    return torch.matmul(mw, rows.reshape(B * out_h, w, c)).reshape(
        B, out_h, out_w, c)


def tap_table(n_ins, n_out: int) -> np.ndarray:
    """`_interp_taps` of each n_in in `n_ins` to n_out, stacked as the
    kernel reads them: int32 (len(n_ins) n_out, 4) rows (i0, i1, w0, w1),
    the weights as their float32 bits."""
    rows = []
    for n_in in n_ins:
        i0, i1, w0, w1 = _interp_taps(n_in, n_out)
        rows.append(np.stack([i0.astype(np.int32), i1.astype(np.int32),
                              w0.view(np.int32), w1.view(np.int32)], 1))
    return np.concatenate(rows)


_TAP_TABLES: Dict[tuple, torch.Tensor] = {}


def _taps(levels: List[torch.Tensor]) -> torch.Tensor:
    """The kernel's tap table for the levels' shapes, on their device,
    uploaded once a shape and device: levels 2-4's rows, then their
    columns."""
    h, w = levels[0].shape[2:]
    sizes = tuple(tuple(x.shape[2:]) for x in levels[1:])
    key = (h, w, sizes, str(levels[0].device))
    if key not in _TAP_TABLES:
        _TAP_TABLES[key] = upload(np.concatenate(
            [tap_table([s[0] for s in sizes], h),
             tap_table([s[1] for s in sizes], w)]), levels[0].device)
    return _TAP_TABLES[key]


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
        """The levels -> (score (B, H, W), the map (B, H, W, dim)): the
        plain form for CPU tensors, the kernel for CUDA ones. Raises on
        levels that are not float32 or not the backbone's shapes at H and
        W multiples of 32, on any device."""
        _check_levels(levels)
        if _nvcc.route("aliked_head", levels[0].device) == "plain":
            return self.head_plain(levels)[:2]
        return self.head_kernel(levels)[:2]

    def head_plain(self, levels: List[torch.Tensor]):
        """The plain form: (score, the map, score1's output after its
        SELU (B, 8, H, W)), a slice of images at a time: each level's 1x1
        conv and SELU upsampled into its quarter of the map's channels,
        score1 on the slice (a product on the slice), then the slice
        normalised in place; then the rest of the score head. Any float
        dtype."""
        B, _, h, w = levels[0].shape
        q = self.conv1.weight.shape[0]
        feat = levels[0].new_empty(B, h, w, 4 * q)
        s8 = levels[0].new_empty(B, self.score1.weight.shape[0], h, w)
        convs = (self.conv1, self.conv2, self.conv3, self.conv4)
        for sl in _slices(B, h, w):
            for i, (conv, x) in enumerate(zip(convs, levels)):
                a = F.selu(conv(x[sl])).permute(0, 2, 3, 1)
                if i:
                    a = _upsample_ac(a.contiguous(), h, w)
                feat[sl, ..., i * q:(i + 1) * q] = a
            f = feat[sl]
            s = torch.matmul(f, self.score1.weight[:, :, 0, 0].T)
            s8[sl] = F.selu(s).permute(0, 3, 1, 2)
            f.div_(torch.clamp(torch.linalg.vector_norm(f, dim=-1,
                                                         keepdim=True),
                               min=1e-12))
        return self._score_tail(s8), feat, s8

    def head_kernel(self, levels: List[torch.Tensor]):
        """The kernel form: `_launch_head`, then the score head's 3x3
        layers and the sigmoid on its score1 output; (score, the map,
        score1's output) as `head_plain`."""
        feat, s8 = self._launch_head(levels)
        return self._score_tail(s8), feat, s8

    def _launch_head(self, levels: List[torch.Tensor]):
        """One launch of `csrc/aliked_head.cu` on the current stream for
        the whole batch -> (the map, score1's output after its SELU).
        Counted on `aliked_head.launches`."""
        x1, x2, x3, x4 = (x.contiguous() for x in levels)
        B, _, h, w = x1.shape
        wts = kernel_weights(self)
        taps = _taps(levels)
        # the levels' 1x1 convs and SELUs, channels-last, 32 channels each
        scratch = x1.new_empty(B * 32 * sum(x.shape[2] * x.shape[3]
                                            for x in levels[1:]))
        feat = x1.new_empty(B, h, w, 4 * self.conv1.weight.shape[0])
        s8 = x1.new_empty(B, self.score1.weight.shape[0], h, w)
        _nvcc.launch("aliked_head", "aliked_head_launch", _HEAD_ARGTYPES,
                     x1.device, x1.data_ptr(), x2.data_ptr(), x3.data_ptr(),
                     x4.data_ptr(), wts.data_ptr(), taps.data_ptr(),
                     scratch.data_ptr(), feat.data_ptr(), s8.data_ptr(), B,
                     h, w)
        del scratch    # the stream reuses it only after the kernels
        return feat, s8

    def _score_tail(self, s8: torch.Tensor) -> torch.Tensor:
        """score1's output (B, 8, H, W) -> the score (B, H, W): score2-4,
        their SELUs and the sigmoid, a slice of images at a time."""
        B, _, h, w = s8.shape
        score = s8.new_empty(B, h, w)
        for sl in _slices(B, h, w):
            s = F.selu(self.score2(s8[sl]))
            s = F.selu(self.score3(s))
            score[sl] = torch.sigmoid(self.score4(s)[:, 0])
        return score

    def forward(self, image: torch.Tensor):
        with precision("highest"):
            with span("aliked.backbone"):
                levels = self.backbone(image)
            with span("aliked.head"):
                return self.head(levels)


_HEAD_ARGTYPES = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 3 + (
    ctypes.c_void_p,)
# SELU's steepest slope, scale * alpha (below 0; scale above)
_SELU_SLOPE = 1.0507009873554805 * 1.6732632423543772


def _check_levels(levels: List[torch.Tensor]) -> None:
    """The head's input: four float32 levels on one device, shaped as the
    backbone gives them for H and W multiples of 32."""
    if len(levels) != 4 or any(x.ndim != 4 for x in levels):
        raise ValueError(f"aliked_head: need four (B, C, h, w) levels, got "
                         f"{[tuple(x.shape) for x in levels]}")
    dtypes = {x.dtype for x in levels}
    if dtypes != {torch.float32}:
        raise TypeError(f"aliked_head: need float32 levels, got "
                        f"{sorted(map(str, dtypes))}")
    if len({x.device for x in levels}) != 1:
        raise ValueError("aliked_head: levels on several devices")
    B, _, h, w = levels[0].shape
    if h % 32 or w % 32:
        raise ValueError(f"aliked_head: need H and W multiples of 32, got "
                         f"{h}x{w}")
    c = CFG_N16
    want = [(B, c["c1"], h, w), (B, c["c2"], h // 2, w // 2),
            (B, c["c3"], h // 8, w // 8), (B, c["c4"], h // 32, w // 32)]
    got = [tuple(x.shape) for x in levels]
    if got != want:
        raise ValueError(f"aliked_head: need levels shaped {want}, got "
                         f"{got}")


def kernel_weights(net: ALIKEDN16Net) -> torch.Tensor:
    """The head's weights as the kernel reads them, float32, contiguous:
    conv1, score1, conv2, conv3, conv4, each (out, in) row-major."""
    return torch.cat([m.weight.detach().float().reshape(-1) for m in (
        net.conv1, net.score1, net.conv2, net.conv3, net.conv4)])


def head_float64_answer_and_limit(net: ALIKEDN16Net,
                                  levels: List[torch.Tensor]):
    """The exact head (the plain form in float64) and how far from it the
    kernel may be, as `ops.conv.float64_answer_and_limit` has it: for each
    of "score", "feat" (the normalised map) and "s8" (score1's output),
    `LIMIT_FACTOR` times the larger of the plain form's error in float32 on
    the same operands and 2^-23 of the largest sum of magnitudes an output
    is made of, which a float32 sum in any order costs: for the map, each
    channel's 1x1 sum of |weight x input| (interpolated, at SELU's steepest
    slope) over the pixel's norm; for s8, score1's sum of |weight x map
    channel| at that slope; for the score, its largest value. A level or
    tap off by one, a dropped SELU or a map left unnormalised moves the
    outputs by far more. -> (answers, limits), two dicts by those names;
    the answers float64."""
    net64 = copy.deepcopy(net).double()
    l64 = [x.double() for x in levels]
    want = dict(zip(("score", "feat", "s8"), net64.head_plain(l64)))
    with precision("highest"):
        plain = dict(zip(("score", "feat", "s8"), net.head_plain(levels)))
    err = {k: float((plain[k].double() - want[k]).abs().max()) for k in want}
    del plain
    h, w = levels[0].shape[2:]
    unit, mag = [], []
    for i, (conv, x) in enumerate(zip(
            (net64.conv1, net64.conv2, net64.conv3, net64.conv4), l64)):
        a = F.selu(conv(x)).permute(0, 2, 3, 1).contiguous()
        m = F.conv2d(x.abs(), conv.weight.abs()).permute(0, 2, 3, 1)
        unit.append(_upsample_ac(a, h, w) if i else a)
        mag.append(_upsample_ac(m.contiguous(), h, w) if i else m)
    f = torch.cat(unit, -1)                     # the unnormalised map
    norm = torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True),
                       min=1e-12)
    m = torch.cat(mag, -1)
    sums = {"feat": _SELU_SLOPE * float((m / norm).max()),
            "s8": _SELU_SLOPE * float((f.abs() @ net64.score1.weight[
                :, :, 0, 0].abs().T).max()),
            "score": float(want["score"].abs().max())}
    limits = {k: LIMIT_FACTOR * max(err[k], 2.0 ** -23 * sums[k])
              for k in want}
    return want, limits


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
