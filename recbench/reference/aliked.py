"""Plain reference of ALIKED-n16 + LightGlue for the cell
`pairs.aliked-lightglue-2048.b32`: a frozen copy of
`tests/plain_aliked.py` (every statement of that file but its imports,
with the same source; `tests/test_torch_aliked_lightglue.py` holds them
equal), and below it what the cell's check runs besides: `side_gaps`,
which holds one side's keypoints and descriptors to the reference's
maps. LightGlue, the matches and the plain RANSAC of the pair chain are
`reference/deep.py`'s (`lightglue`, `pair_outputs`, `chain_answers`,
`plain_ransac`), run at `input_dim` 128.

It imports nothing of the program. Its docstring of record, with the
published description and each departure from it, is the test file's.

`precision("float32")` is the reference proper: float32 with both TF32
flags off. `precision("tf32")` is the control's ALIKED, one precision
below the configuration's float32; the control's LightGlue is
`deep.precision("bfloat16")`, one below its TF32.
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


# ---- the cell's check (not in the tests' reference)

# the least score difference by which the cell's check takes a keypoint
# that one side has and the other lacks as decided, not a near-tie
SCORE_MARGIN = 1e-4


def window_offsets(device, radius: int = DKD_RADIUS):
    """The (2r+1)^2 integer offsets (x, y) of a window (a DKD window by
    default)."""
    d = torch.arange(-radius, radius + 1, device=device)
    return torch.stack(torch.meshgrid(d, d, indexing="xy"), -1).reshape(-1, 2)


def window_rival(score, pix, radius: int):
    """The largest score of each pixel's (2r+1)^2 window in the (h, w)
    score map but its own, pix (n, 2) integer (x, y): (n,)."""
    h, w = score.shape
    off = window_offsets(score.device, radius)
    off = off[(off != 0).any(-1)]
    q = pix[:, None, :] + off
    inside = ((q[..., 0] >= 0) & (q[..., 0] < w)
              & (q[..., 1] >= 0) & (q[..., 1] < h))
    v = score[q[..., 1].clamp(0, h - 1), q[..., 0].clamp(0, w - 1)]
    return torch.where(inside, v, torch.full_like(v, -float("inf"))).amax(1)


def decided_flips(score, peaks, max_keypoints: int, threshold: float,
                  nms_radius: int, pix):
    """The keypoints one side has and the other lacks that the float32
    reference's score map (h, w) decides by more than SCORE_MARGIN, so
    that no near-tie explains them. `peaks` (m, 2) are the reference's
    (`select` under the same settings), pix (n, 2) the side's pixels.

    A lost peak with a neighbour in its NMS window within the margin of
    its score, or a pixel of the side within the margin below such a
    neighbour, is a near-tie at NMS, and frees or takes one of the
    side's slots: with the budget full, the side's top-k edge moves by
    as many ranks of the reference's local maxima. Counted: the side's
    pixels clearly below another score of their window, or clearly below
    the lowest score the reference kept (the k-th peak's, moved by the
    ties; with the budget not full, the threshold); and the lost peaks,
    not tied at NMS, clearly above the best score the reference did not
    keep (the next local maximum, moved by the ties, or the
    threshold)."""
    w = score.shape[1]
    key, rkey = pix[:, 1] * w + pix[:, 0], peaks[:, 1] * w + peaks[:, 0]
    lost = peaks[~torch.isin(rkey, key)]
    extra = pix[~torch.isin(key, rkey)]
    s_lost = score[lost[:, 1], lost[:, 0]]
    s_extra = score[extra[:, 1], extra[:, 0]]
    r_lost = window_rival(score, lost, nms_radius)
    r_extra = window_rival(score, extra, nms_radius)
    lost_tie = r_lost > s_lost - SCORE_MARGIN
    extra_tie = (s_extra < r_extra) & (s_extra >= r_extra - SCORE_MARGIN)
    floor = rest = threshold
    m = len(peaks)
    if m == max_keypoints:
        v = torch.sort(local_maxima(score, nms_radius).reshape(-1),
                       descending=True).values
        shift = int(lost_tie.sum()) - int(extra_tie.sum())
        floor = max(threshold, float(v[min(m - 1 + max(shift, 0),
                                           v.numel() - 1)]))
        rest = max(threshold, float(v[max(m + min(shift, 0), 0)]))
    lost = ~lost_tie & (s_lost > rest + SCORE_MARGIN)
    extra = ((s_extra < r_extra - SCORE_MARGIN)
             | (s_extra < floor - SCORE_MARGIN))
    return int(lost.sum()) + int(extra.sum())


def side_gaps(p, score, feat, peaks, xy, scores, desc, settings):
    """One side's keypoints on one image, xy (n, 2) refined positions,
    their scores (n,) and descriptors (n, D), against the float32
    reference's score map (h, w) and normalised map (dim, h, w) of the
    same image, whose own selected peaks are `peaks` (m, 2), which
    `select` kept under `settings` (max_keypoints, threshold,
    nms_radius).

    A keypoint's DKD window is centred on an integer pixel within
    DKD_RADIUS px of it on each axis; its pixel is the one of that
    neighbourhood from which the reference's own refinement lands
    nearest, so that a peak the two sides part on at a near-tie is
    still found where the side took it. A keypoint is shared if its
    pixel is one of `peaks`: a keypoint taken from a non-maximum, from
    below the threshold or past the top-k is not. Returns a dict:
    xy_gap (px) and desc_gap (1 - cos against the reference's SDDH at
    its refined position), the largest over the shared keypoints;
    score_gap, the largest |score - the reference's score at the pixel|
    over them; missing, the side's keypoints left over once each peak
    is taken by one keypoint, and the reference's peaks that no keypoint
    took, the larger; flips, those of them that the scores decide
    (`decided_flips`); n, the side's keypoints; at_clamp, the
    reference's SDDH offsets at cvg's clamp on the shared keypoints."""
    h, w = score.shape
    n = len(xy)
    out = dict(xy_gap=0.0, desc_gap=0.0, score_gap=0.0, n=n,
               missing=max(n, len(peaks)), at_clamp=0, flips=0)
    if n == 0:
        out["flips"] = decided_flips(score, peaks, *settings, peaks[:0])
        return out
    cand = torch.round(xy).long()[:, None, :] + window_offsets(xy.device)
    cand[..., 0].clamp_(0, w - 1)
    cand[..., 1].clamp_(0, h - 1)
    rxy = dkd(score, cand.reshape(-1, 2)).reshape(n, -1, 2)
    dist = (rxy.double() - xy[:, None, :].double()).pow(2).sum(-1).sqrt()
    best = dist.argmin(1)
    rows = torch.arange(n, device=xy.device)
    pix, rxy, dist = cand[rows, best], rxy[rows, best], dist[rows, best]
    key, rkey = pix[:, 1] * w + pix[:, 0], peaks[:, 1] * w + peaks[:, 0]
    shared = torch.isin(key, rkey)
    taken = int(torch.unique(key[shared]).numel())
    out["missing"] = max(n - taken, len(peaks) - taken)
    out["flips"] = decided_flips(score, peaks, *settings, pix)
    if not bool(shared.any()):
        return out
    pix, rxy, dist = pix[shared], rxy[shared], dist[shared]
    rdesc, out["at_clamp"] = sddh(p, feat, rxy)
    cos = (desc[shared].double() * rdesc.double()).sum(-1)
    out.update(xy_gap=float(dist.max()),
               desc_gap=float((1 - cos).max()),
               score_gap=float((scores[shared] - score[pix[:, 1], pix[:, 0]])
                               .abs().max()))
    return out
