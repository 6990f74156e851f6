"""Plain reference of ALIKED-n16, written from the published description:
plain `torch`, float32 with both TF32 flags off, one image at a time, on
the valid keypoints only (no batch, no padded keypoint slots, no masks).
It imports nothing of the program. It draws its own parameters from a
seeded generator (`aliked_params`: every weight, bias and BatchNorm term
nonzero, running variances positive) under the names of the program's
module (`state_dict()` of `ALIKEDN16Net`, less the BatchNorms' step
counters), and the program loads the same set, so a term that the
program drops or misapplies shows as a gap. `recbench/reference/aliked.py`
holds a frozen copy of everything here but the imports. LightGlue's
plain reference is `tests/plain_superpoint_lightglue.py`'s, run at
`input_dim` 128.

ALIKED (Zhao, Wu, Liu et al., IEEE TIM 2023, arXiv:2304.03608; cvg/
LightGlue `lightglue/aliked.py`, `aliked-n16`: c1..c4 = 16/32/64/128,
dim 128, K 3, M 16), on a grayscale image repeated to three channels:

- block1: [3x3 conv -> BatchNorm -> SELU] x 2 at full resolution;
  block2: a ResBlock (conv -> BN -> SELU -> conv -> BN, plus a 1x1
  shortcut, then SELU) after a 2x2 average pool; block3 and block4 the
  same with deformable 3x3 convolutions, after 4x4 average pools (1/8,
  1/32). A deformable 3x3 convolution is `torchvision.ops.deform_conv2d`
  without a modulation mask: a regular 3x3 convolution predicts 18
  offsets a pixel, (dy, dx) for each tap in row-major order, and tap k
  of output pixel (i, j) reads the input bilinearly, zero outside, at
  (i + ky - 1 + dy_k, j + kx - 1 + dx_k); written here tap by tap with
  `grid_sample`;
- aggregation: per level a 1x1 convolution (no bias) to dim / 4
  channels and a SELU, upsampled bilinearly with aligned corners to full
  resolution (`F.interpolate`), concatenated into dim channels;
- the score head: 1x1 (dim -> 8), SELU, 3x3 (8 -> 4), SELU, 3x3
  (4 -> 4), SELU, 3x3 (4 -> 1) with a bias, sigmoid;
- the descriptor map: the aggregation, L2 normalised per pixel;
- DKD: the score map's local maxima over (2r+1)^2 windows (r = 2), the
  `max_keypoints` highest, those above the detection threshold kept;
  each refined by the soft-argmax of its window at temperature 0.1:
  xy = peak + sum_k e_k d_k / sum_k e_k, e_k = exp((s_k - max s) / 0.1)
  over the window's 25 offsets d_k;
- SDDH: from each keypoint's K x K patch of the map a K x K valid
  convolution (dim -> 2M), SELU, 1x1 (2M -> 2M) give M offsets (x, y);
  the map is sampled bilinearly (aligned corners, zero outside) at the
  keypoint plus each offset, each sample mapped by the 1x1 `sf`
  (no bias), and the descriptor is sum_m W_m f_m with the learned
  (M, dim, dim) `agg`, L2 normalised.

Where this reference follows the program (and the JAX package's
documented assumptions A1-A5) rather than cvg's code:

- A1 each deformable convolution owns a 3x3 offset convolution with a
  bias, and its regular kernel has a bias; A2 a ResBlock's shortcut is a
  bare 1x1 convolution with a bias and no norm; A3 the aggregation and
  score convolutions carry no bias but the last 3x3; A4 SDDH's offsets
  are (x, y) pairs in pixels; A5 BatchNorm in inference form with eps
  1e-5;
- NMS is one max pool over (2r+1)^2 windows (padding -inf), a pixel
  kept where it equals its window's maximum;
- no border is removed: a keypoint may sit on the image's edge, and its
  DKD window repeats the edge's scores (replicate padding);
- a keypoint's score is its peak's own score, not the score map sampled
  at the refined position;
- the grayscale image is repeated to three channels, zero-padded at the
  bottom and right to a multiple of 32 (768x1024 needs none);
- no offset is clamped: cvg clamps the deformable convolutions' and
  SDDH's offsets to max(H, W) / 4 of their map. `at_clamp` counts the
  offsets that reach that bound, so a reading shows whether the
  difference matters;
- SDDH's patch is centred at the rounded keypoint, clamped K // 2 px
  inside the map, and its samples get no SELU after `sf` (the program's
  form);
- the top-k keeps the 2,048-keypoint budget (cvg's default is every
  peak above the threshold).

`precision("float32")` is the reference proper. `precision("tf32")` is
the control one precision below a float32 configuration: TF32 in every
convolution and product.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

N16 = dict(c1=16, c2=32, c3=64, c4=128, dim=128, K=3, M=16)
BN_EPS = 1e-5
# the spread of the BatchNorm scales around 1, of their biases and
# running means, and of the log of their running variances
NORM_STD = 0.1
# layers whose input is the unit-norm map, of element mean square 1 / dim
# and not 1: their weights are drawn at variance dim / fan-in
UNIT_NORM_INPUTS = ("sddh.off1", "sddh.sf")
DKD_RADIUS = 2
DKD_TEMPERATURE = 0.1


@contextlib.contextmanager
def precision(mode: str, device_type: str = "cuda"):
    """"float32": both TF32 flags off; "tf32": both on. The flags are
    restored on exit. (`device_type` is taken for the same signature as
    LightGlue's reference.)"""
    if mode not in ("float32", "tf32"):
        raise ValueError(f"precision must be float32 or tf32, got {mode!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    low = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = low
    torch.backends.cudnn.allow_tf32 = low
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def aliked_shapes():
    """(name, shape) of every ALIKED-n16 parameter and BatchNorm
    statistic, in the order of the program's `state_dict()`."""
    c = N16
    dim, K, M = c["dim"], c["K"], c["M"]

    def conv(name, cin, cout, k, bias=True):
        return ([(name + ".weight", (cout, cin, k, k))]
                + ([(name + ".bias", (cout,))] if bias else []))

    def bn(name, ch):
        return [(f"{name}.{t}", (ch,))
                for t in ("weight", "bias", "running_mean", "running_var")]

    def deform(name, cin, cout):
        return ([(name + ".weight", (cout, cin, 3, 3)),
                 (name + ".bias", (cout,))]
                + conv(name + ".offset_conv", cin, 18, 3))

    def plain3(name, cin, cout):
        return conv(name, cin, cout, 3)

    shapes = (conv("block1.conv1", 3, c["c1"], 3) + bn("block1.bn1", c["c1"])
              + conv("block1.conv2", c["c1"], c["c1"], 3)
              + bn("block1.bn2", c["c1"]))
    for blk, cin, cout, cv in (("block2", c["c1"], c["c2"], plain3),
                               ("block3", c["c2"], c["c3"], deform),
                               ("block4", c["c3"], c["c4"], deform)):
        shapes += (cv(blk + ".conv1", cin, cout) + bn(blk + ".bn1", cout)
                   + cv(blk + ".conv2", cout, cout) + bn(blk + ".bn2", cout)
                   + conv(blk + ".downsample", cin, cout, 1))
    for i, ch in enumerate((c["c1"], c["c2"], c["c3"], c["c4"]), 1):
        shapes += conv(f"conv{i}", ch, dim // 4, 1, bias=False)
    shapes += (conv("score1", dim, 8, 1, bias=False)
               + conv("score2", 8, 4, 3, bias=False)
               + conv("score3", 4, 4, 3, bias=False) + conv("score4", 4, 1, 3))
    return (shapes + [("sddh.agg", (M, dim, dim))]
            + conv("sddh.off1", dim, 2 * M, K)
            + conv("sddh.off2", 2 * M, 2 * M, 1)
            + [("sddh.sf.weight", (dim, dim))])


def aliked_params(generator):
    """A float32 CPU tensor for each (name, shape) of `aliked_shapes()`,
    drawn from `generator` in that order: a weight of two or more axes
    and its bias normal with variance 1 / the weight's fan-in (`agg`'s
    fan-in is M dim; the weights of UNIT_NORM_INPUTS at dim / fan-in); a
    BatchNorm's scale 1 + normal at NORM_STD, its bias and running mean
    normal at NORM_STD, its running variance exp(normal at NORM_STD), so
    that every term is nonzero and every variance positive."""
    shapes = aliked_shapes()
    spans = dict(shapes)
    dim, M = N16["dim"], N16["M"]
    p = {}
    for name, shape in shapes:
        x = torch.randn(shape, generator=generator)
        layer, leaf = name.rsplit(".", 1)
        weight = spans.get(layer + ".weight", shape)
        if leaf == "running_var":
            p[name] = torch.exp(NORM_STD * x)
        elif leaf == "running_mean" or (len(weight) == 1 and leaf == "bias"):
            p[name] = NORM_STD * x
        elif len(weight) == 1:
            p[name] = 1 + NORM_STD * x
        elif name == "sddh.agg":
            p[name] = x / math.sqrt(M * dim)
        else:
            fan_in = math.prod(weight[1:])
            if layer in UNIT_NORM_INPUTS:
                fan_in /= dim
            p[name] = x / math.sqrt(fan_in)
    return p


def conv(p, name, x, padding):
    return F.conv2d(x, p[name + ".weight"], p.get(name + ".bias"),
                    padding=padding)


def batch_norm(p, name, x):
    return F.batch_norm(x, p[name + ".running_mean"], p[name + ".running_var"],
                        p[name + ".weight"], p[name + ".bias"], False, 0.0,
                        BN_EPS)


def sample(x, px, py):
    """Bilinear samples of x (1, C, h, w), zero outside, at pixel
    coordinates px, py (a, b): (C, a, b)."""
    h, w = x.shape[2:]
    grid = torch.stack([2 * px / max(w - 1, 1) - 1,
                        2 * py / max(h - 1, 1) - 1], -1)
    return F.grid_sample(x, grid[None], mode="bilinear",
                         padding_mode="zeros", align_corners=True)[0]


def deform_conv(p, name, x):
    """`deform_conv2d` of x (1, Cin, h, w) with the 3x3 kernel and bias of
    `name` and the offsets of `name.offset_conv`, tap by tap: ((1, Cout,
    h, w), the number of offsets at cvg's clamp max(h, w) / 4)."""
    h, w = x.shape[2:]
    offsets = conv(p, name + ".offset_conv", x, 1)[0]       # (18, h, w)
    ii = torch.arange(h, dtype=x.dtype, device=x.device)[:, None].expand(h, w)
    jj = torch.arange(w, dtype=x.dtype, device=x.device)[None, :].expand(h, w)
    weight = p[name + ".weight"]
    out = p[name + ".bias"][:, None, None].expand(-1, h, w)
    for k in range(9):
        ky, kx = divmod(k, 3)
        taps = sample(x, jj + kx - 1 + offsets[2 * k + 1],
                      ii + ky - 1 + offsets[2 * k])          # (Cin, h, w)
        out = out + torch.einsum("oc,chw->ohw", weight[:, :, ky, kx], taps)
    at_clamp = int((offsets.abs() >= max(h, w) / 4).sum())
    return out[None], at_clamp


def conv_block(p, name, x):
    x = F.selu(batch_norm(p, name + ".bn1", conv(p, name + ".conv1", x, 1)))
    return F.selu(batch_norm(p, name + ".bn2", conv(p, name + ".conv2", x, 1)))


def res_block(p, name, x, deformable: bool):
    """((1, Cout, h, w), offsets at the clamp)."""
    if deformable:
        y, n1 = deform_conv(p, name + ".conv1", x)
        y = F.selu(batch_norm(p, name + ".bn1", y))
        y, n2 = deform_conv(p, name + ".conv2", y)
    else:
        y = conv(p, name + ".conv1", x, 1)
        y = F.selu(batch_norm(p, name + ".bn1", y))
        y, n1, n2 = conv(p, name + ".conv2", y, 1), 0, 0
    y = batch_norm(p, name + ".bn2", y)
    return F.selu(y + conv(p, name + ".downsample", x, 0)), n1 + n2


def aliked_dense(p, image):
    """(3, H, W), H and W multiples of 32 -> (score (H, W), the L2
    normalised map (dim, H, W), offsets at the clamp)."""
    x = image[None]
    h, w = x.shape[2:]
    x1 = conv_block(p, "block1", x)
    x2, _ = res_block(p, "block2", F.avg_pool2d(x1, 2), False)
    x3, n3 = res_block(p, "block3", F.avg_pool2d(x2, 4), True)
    x4, n4 = res_block(p, "block4", F.avg_pool2d(x3, 4), True)
    levels = [F.selu(conv(p, f"conv{i}", xi, 0))
              for i, xi in enumerate((x1, x2, x3, x4), 1)]
    agg = torch.cat([levels[0]] + [
        F.interpolate(a, size=(h, w), mode="bilinear", align_corners=True)
        for a in levels[1:]], dim=1)
    s = F.selu(conv(p, "score1", agg, 0))
    s = F.selu(conv(p, "score2", s, 1))
    s = F.selu(conv(p, "score3", s, 1))
    score = torch.sigmoid(conv(p, "score4", s, 1))[0, 0]
    return score, F.normalize(agg, p=2, dim=1, eps=1e-12)[0], n3 + n4


def local_maxima(score, radius: int):
    """The score where it is its (2r+1)^2 window's maximum, else -inf."""
    pooled = F.max_pool2d(score[None, None], 2 * radius + 1, stride=1,
                          padding=radius)[0, 0]
    return torch.where(score >= pooled, score,
                       torch.full_like(score, -float("inf")))


def dkd(score, peaks):
    """Soft-argmax refinement of integer peaks (n, 2) (x, y) of the
    (h, w) score map over their (2r+1)^2 windows, edges repeated:
    (n, 2) float32 positions."""
    h, w = score.shape
    r = DKD_RADIUS
    padded = F.pad(score[None, None], (r, r, r, r), mode="replicate")
    windows = F.unfold(padded, 2 * r + 1)[0]               # ((2r+1)^2, h w)
    s = windows[:, peaks[:, 1] * w + peaks[:, 0]].T          # (n, (2r+1)^2)
    e = torch.exp((s - s.max(1, keepdim=True).values) / DKD_TEMPERATURE)
    d = torch.arange(-r, r + 1, dtype=score.dtype, device=score.device)
    grid = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1).reshape(-1, 2)
    residual = (e @ grid.flip(-1)) / e.sum(1, keepdim=True)  # (x, y)
    return peaks.to(score.dtype) + residual.clamp(-r, r)


def sddh(p, feat, xy):
    """Descriptors of pixel keypoints xy (n, 2) on the normalised map
    feat (dim, h, w): ((n, dim) unit vectors, offsets at the clamp)."""
    dim, h, w = feat.shape
    K, M = N16["K"], N16["M"]
    r = K // 2
    xi = torch.round(xy[:, 0]).long().clamp(r, w - 1 - r)
    yi = torch.round(xy[:, 1]).long().clamp(r, h - 1 - r)
    d = torch.arange(-r, r + 1, device=feat.device)
    patches = feat[:, (yi[:, None] + d)[:, :, None],
                   (xi[:, None] + d)[:, None, :]]           # (dim, n, K, K)
    o = F.selu(conv(p, "sddh.off1", patches.permute(1, 0, 2, 3), 0))
    off = conv(p, "sddh.off2", o, 0).reshape(-1, M, 2)      # (x, y)
    at_clamp = int((off.abs() >= max(h, w) / 4).sum())
    pos = xy[:, None, :] + off
    f = sample(feat[None], pos[..., 0], pos[..., 1]).permute(1, 2, 0)
    f = F.linear(f, p["sddh.sf.weight"])                    # (n, M, dim)
    desc = torch.einsum("nmc,mcd->nd", f, p["sddh.agg"])
    return F.normalize(desc, p=2, dim=1, eps=1e-12), at_clamp


def aliked_maps(p, image):
    """One (H, W) image in [0, 1], repeated to three channels and padded
    to a multiple of 32 -> (score (H, W), the normalised map (dim, H, W),
    both cut back to the image, and the backbone's offsets at the
    clamp)."""
    h, w = image.shape
    x = F.pad(image, (0, (-w) % 32, 0, (-h) % 32))[None].repeat(3, 1, 1)
    score, feat, at_clamp = aliked_dense(p, x)
    return score[:h, :w], feat[:, :h, :w], at_clamp


def select(score, max_keypoints: int, threshold: float, nms_radius: int):
    """The `max_keypoints` highest local maxima of the (h, w) score map
    (ties to the lower row-major index) whose score is above `threshold`,
    in that order: (peaks (n, 2) integer (x, y), scores (n,))."""
    w = score.shape[1]
    flat = local_maxima(score, nms_radius).reshape(-1)
    top = torch.sort(flat, descending=True, stable=True).indices
    top = top[:max_keypoints]
    top = top[flat[top] > threshold]
    return torch.stack([top % w, top // w], -1), flat[top]


def aliked(p, image, max_keypoints: int, threshold: float, nms_radius: int):
    """One (H, W) image in [0, 1] -> (xy (n, 2) refined pixel positions,
    scores (n,), descriptors (n, dim), peaks (n, 2) integer (x, y),
    offsets at cvg's clamp) of the keypoints `select` keeps."""
    score, feat, n_backbone = aliked_maps(p, image)
    peaks, scores = select(score, max_keypoints, threshold, nms_radius)
    xy = dkd(score, peaks)
    desc, n_sddh = sddh(p, feat, xy)
    return xy, scores, desc, peaks, n_backbone + n_sddh
