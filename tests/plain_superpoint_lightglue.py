"""Plain reference of SuperPoint + LightGlue, written from the published
equations: plain `torch`, float32 with both TF32 flags off, one image or
one pair at a time, on the valid keypoints only (no batch, no padding of
the keypoints, no masks). It imports nothing of the program. It draws
its own parameters from a seeded generator (`random_params`, every
weight, bias and norm term nonzero) under the names of the program's
modules (`state_dict()` of `SuperPointNet` and `LightGlueNet`), and the
program loads the same set, so a term that the program drops or
misapplies shows as a gap. `recbench/reference/deep.py` holds a frozen copy of every function
here.

SuperPoint (DeTone, Malisiewicz and Rabinovich, CVPRW 2018,
arXiv:1712.07629): a VGG encoder of eight 3x3 convolutions with ReLUs
and three 2x2 max pools; a detector head (3x3 to 256, ReLU, 1x1 to 65)
whose 65-way softmax per 8x8 cell, dustbin dropped, is laid back out at
full resolution; a descriptor head (3x3 to 256, ReLU, 1x1 to 256), L2
normalised; NMS, the top-k of the heat above the detection threshold,
and descriptors sampled bilinearly at the keypoints and normalised.

LightGlue (Lindenberger, Sarlin and Pollefeys, ICCV 2023,
arXiv:2306.13643; cvg/LightGlue): an input projection; a learned-Fourier
rotary encoding of the normalised keypoints, rotating interleaved pairs
(x_2j, x_2j+1) of each head's queries and keys by angle_j = Wr_j . p;
per layer a self block on each view (softmax(q k^T / sqrt(dh)) v, an
output projection, then x + FFN(concat(x, message)) with FFN = Linear,
LayerNorm, exact GELU, Linear) and a cross block (one projection for
both views' queries-and-keys, scaled by dh^-1/4 on each side, one
similarity softmaxed along each of its axes, messages to both views,
the same FFN form); a final projection scaled by d^-1/4 on each side, the
similarity S, matchability logits z, and the log-assignment
log_softmax_rows(S) + log_softmax_cols(S) + log sigmoid(z0) +
log sigmoid(z1); matches are the mutual argmax above a confidence.

Where this reference follows the program rather than the publications:

- NMS is one max pool over (2r+1)^2 windows (padding -inf), a pixel kept
  where it equals the window's maximum (cvg iterates the pool);
- the 4-px border that cvg's SuperPoint removes is kept;
- descriptors are sampled at (x / 8 - 0.5, y / 8 - 0.5) on the 1/8 map,
  clipped to [0, size / 8 - 1.001] (cvg's `grid_sample` maps the corners
  slightly differently);
- LightGlue projects 256-d descriptors through `input_proj` (cvg's
  SuperPoint model has an identity there, input and model width being
  equal) and unpacks `Wqkv`'s output as (head width, heads, 3) (cvg:
  (heads, head width, 3));
- no adaptive depth or width (cvg's `depth_confidence=-1`,
  `width_confidence=-1`), and no dustbin row or column: the assignment
  is the N0 x N1 block that cvg's `filter_matches` reads;
- the program's -1e9 masks exist only for its padded slots: there are
  none here.

`precision("float32")` is the reference proper. `precision("bfloat16")`
is the control one precision below a TF32 configuration: bfloat16
autocast around the convolutions and products with TF32 on, the cell
softmax, the descriptors' normalisation and the assignment head in
float32, as the program's `activation_dtype="bfloat16"` runs.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

SUPERPOINT_CONVS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a",
                    "conv3b", "conv4a", "conv4b")


@contextlib.contextmanager
def precision(mode: str, device_type: str = "cuda"):
    """"float32": both TF32 flags off; "bfloat16": bfloat16 autocast on
    `device_type` with TF32 on. The flags are restored on exit."""
    if mode not in ("float32", "bfloat16"):
        raise ValueError(f"precision must be float32 or bfloat16, got {mode!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    low = mode == "bfloat16"
    torch.backends.cuda.matmul.allow_tf32 = low
    torch.backends.cudnn.allow_tf32 = low
    try:
        with torch.autocast(device_type, dtype=torch.bfloat16, enabled=low):
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# the spread of the LayerNorm scales around 1, and of their biases
NORM_STD = 0.1
# layers whose input is a unit-norm descriptor, of element mean square
# 1 / D and not 1: their weights are drawn at variance 1 / (fan-in / D)
UNIT_NORM_INPUTS = ("input_proj",)


def superpoint_shapes(desc_dim: int = 256):
    """(name, shape) of every SuperPoint parameter at the published
    widths: eight 3x3 encoder convolutions (1 -> 64, 64, 64, 64, 128,
    128, 128, 128 channels), and on each head a 3x3 convolution to 256
    then a 1x1 one to 65 (detector) or `desc_dim` (descriptor)."""
    chans = (1, 64, 64, 64, 64, 128, 128, 128, 128)
    shapes = []
    for name, cin, cout in zip(SUPERPOINT_CONVS, chans, chans[1:]):
        shapes += [(name + ".weight", (cout, cin, 3, 3)),
                   (name + ".bias", (cout,))]
    for head, cout in (("P", 65), ("D", desc_dim)):
        shapes += [(f"conv{head}a.weight", (256, 128, 3, 3)),
                   (f"conv{head}a.bias", (256,)),
                   (f"conv{head}b.weight", (cout, 256, 1, 1)),
                   (f"conv{head}b.bias", (cout,))]
    return shapes


def lightglue_shapes(input_dim: int, dim: int, n_layers: int, heads: int):
    """(name, shape) of every LightGlue parameter: the input projection,
    the rotary encoding's Wr (head width / 2, 2), per layer a self block
    (Wqkv, out_proj, FFN) and a cross block (to_qk, to_v, to_out, FFN),
    each FFN Linear(2d, 2d), LayerNorm(2d), Linear(2d, d); the final
    projection and the matchability (d -> 1)."""
    def lin(name, cout, cin):
        return [(name + ".weight", (cout, cin)), (name + ".bias", (cout,))]

    def ffn(name):
        return (lin(name + ".0", 2 * dim, 2 * dim)
                + [(name + ".1.weight", (2 * dim,)),
                   (name + ".1.bias", (2 * dim,))]
                + lin(name + ".3", dim, 2 * dim))

    shapes = (lin("input_proj", dim, input_dim)
              + [("posenc.Wr.weight", (dim // heads // 2, 2))])
    for i in range(n_layers):
        s, c = f"transformers.{i}.self_attn", f"transformers.{i}.cross_attn"
        shapes += (lin(s + ".Wqkv", 3 * dim, dim) + lin(s + ".out_proj", dim, dim)
                   + ffn(s + ".ffn"))
        shapes += (lin(c + ".to_qk", dim, dim) + lin(c + ".to_v", dim, dim)
                   + lin(c + ".to_out", dim, dim) + ffn(c + ".ffn"))
    return shapes + lin("final_proj", dim, dim) + lin("matchability", 1, dim)


def random_params(shapes, generator):
    """A float32 CPU tensor for each (name, shape) of `shapes`, drawn from
    `generator` in that order: a weight of two or more axes and its bias
    normal with variance 1 / the weight's fan-in (LeCun's rule, which
    keeps unit-variance activations at unit variance; the weights of
    UNIT_NORM_INPUTS at variance 1, their fan-in being their input's
    size), a LayerNorm scale (one axis) 1 + normal at NORM_STD and its
    bias normal at NORM_STD, so that every term of every equation is
    nonzero."""
    spans = dict(shapes)
    p = {}
    for name, shape in shapes:
        x = torch.randn(shape, generator=generator)
        weight = spans.get(name[:-len("bias")] + "weight", shape)
        if name.rsplit(".", 1)[0] in UNIT_NORM_INPUTS \
                and name.endswith(".weight"):
            p[name] = x
        elif len(weight) >= 2:
            p[name] = x / math.sqrt(math.prod(weight[1:]))
        elif name.endswith(".weight"):
            p[name] = 1 + NORM_STD * x
        else:
            p[name] = NORM_STD * x
    return p


def conv(p, name, x, padding):
    return F.conv2d(x, p[name + ".weight"], p[name + ".bias"],
                    padding=padding)


def superpoint_dense(p, image):
    """(H, W) image, H and W multiples of 8 -> (heat (H, W) before NMS,
    descriptor map (D, H/8, W/8), L2 normalised over D)."""
    x = image[None, None]
    for i, name in enumerate(SUPERPOINT_CONVS):
        x = F.relu(conv(p, name, x, 1))
        if i in (1, 3, 5):
            x = F.max_pool2d(x, 2, 2)
    semi = conv(p, "convPb", F.relu(conv(p, "convPa", x, 1)), 0)[0]
    prob = torch.softmax(semi.float(), dim=0)[:64]           # (64, h, w)
    h, w = prob.shape[1:]
    # cell channel c = 8 r + s is the pixel (8 y + r, 8 x + s)
    heat = prob.reshape(8, 8, h, w).permute(2, 0, 3, 1).reshape(8 * h, 8 * w)
    desc = conv(p, "convDb", F.relu(conv(p, "convDa", x, 1)), 0)[0].float()
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=0), min=1e-12)
    return heat, desc


def nms(heat, radius: int):
    """The heat where it is its (2r+1)^2 window's maximum, else 0."""
    pooled = F.max_pool2d(heat[None, None], 2 * radius + 1, stride=1,
                          padding=radius)[0, 0]
    return torch.where(heat >= pooled, heat, torch.zeros_like(heat))


def sample_descriptors(desc, xy):
    """Bilinear samples of the (D, h, w) map at pixel keypoints xy (n, 2),
    L2 normalised: (n, D)."""
    _, h, w = desc.shape
    gx = torch.clamp(xy[:, 0] / 8.0 - 0.5, 0, w - 1.001)
    gy = torch.clamp(xy[:, 1] / 8.0 - 0.5, 0, h - 1.001)
    x0, y0 = torch.floor(gx).long(), torch.floor(gy).long()
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    fx, fy = gx - x0, gy - y0
    v = ((1 - fy) * (1 - fx) * desc[:, y0, x0] + (1 - fy) * fx * desc[:, y0, x1]
         + fy * (1 - fx) * desc[:, y1, x0] + fy * fx * desc[:, y1, x1]).T
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True),
                           min=1e-12)


def superpoint(p, image, max_keypoints: int, threshold: float,
               nms_radius: int):
    """One (H, W) image in [0, 1] -> its keypoints xy (n, 2) (x, y pixels),
    scores (n,) and descriptors (n, D): the `max_keypoints` highest peaks
    after NMS (ties to the lower row-major index) whose score is above
    `threshold`, in that order. The image is zero-padded to a multiple
    of 8 and the heat cut back to (H, W)."""
    h, w = image.shape
    heat, desc = superpoint_dense(p, F.pad(image, (0, (-w) % 8, 0, (-h) % 8)))
    heat = nms(heat, nms_radius)[:h, :w].reshape(-1)
    order = torch.sort(heat, descending=True, stable=True).indices
    top = order[:max_keypoints]
    top = top[heat[top] > threshold]
    xy = torch.stack([top % w, top // w], -1).to(torch.float32)
    return xy, heat[top], sample_descriptors(desc, xy)


def linear(p, name, x):
    return F.linear(x, p[name + ".weight"], p[name + ".bias"])


def normalize_keypoints(xy, h: int, w: int):
    """Centred on the image and scaled by half its longer side."""
    return (xy - torch.tensor([w / 2.0, h / 2.0], device=xy.device)) \
        / (max(h, w) / 2.0)


def rotate_pairs(t, angle):
    """t (n, heads, dh) with each interleaved pair (t_2j, t_2j+1) rotated
    by angle (n, dh / 2)."""
    c = torch.cos(angle)[:, None, :]
    s = torch.sin(angle)[:, None, :]
    t0, t1 = t[..., 0::2], t[..., 1::2]
    return torch.stack([t0 * c - t1 * s, t1 * c + t0 * s], -1).flatten(-2)


def ffn(p, name, x, message):
    y = linear(p, name + ".0", torch.cat([x, message], -1))
    y = F.layer_norm(y, y.shape[-1:], p[name + ".1.weight"],
                     p[name + ".1.bias"], eps=1e-5)
    return x + linear(p, name + ".3", F.gelu(y))


def self_block(p, name, x, angle, heads: int):
    n, d = x.shape
    dh = d // heads
    qkv = linear(p, name + ".Wqkv", x).reshape(n, dh, heads, 3)
    q, k, v = (qkv[..., i].transpose(1, 2) for i in range(3))  # (n, h, dh)
    q, k = rotate_pairs(q, angle), rotate_pairs(k, angle)
    att = torch.softmax(torch.einsum("nhd,mhd->hnm", q, k) / math.sqrt(dh),
                        dim=-1)
    ctx = torch.einsum("hnm,mhd->nhd", att, v).reshape(n, d)
    return ffn(p, name + ".ffn", x, linear(p, name + ".out_proj", ctx))


def cross_block(p, name, x0, x1, heads: int):
    d = x0.shape[1]
    dh = d // heads

    def split(t):
        return t.reshape(t.shape[0], heads, dh)

    qk0 = split(linear(p, name + ".to_qk", x0)) * dh ** -0.25
    qk1 = split(linear(p, name + ".to_qk", x1)) * dh ** -0.25
    v0 = split(linear(p, name + ".to_v", x0))
    v1 = split(linear(p, name + ".to_v", x1))
    sim = torch.einsum("nhd,mhd->hnm", qk0, qk1)             # (h, n0, n1)
    m0 = torch.einsum("hnm,mhd->nhd", torch.softmax(sim, dim=2), v1)
    m1 = torch.einsum("hnm,nhd->mhd", torch.softmax(sim, dim=1), v0)
    m0 = linear(p, name + ".to_out", m0.reshape(-1, d))
    m1 = linear(p, name + ".to_out", m1.reshape(-1, d))
    return ffn(p, name + ".ffn", x0, m0), ffn(p, name + ".ffn", x1, m1)


def lightglue(p, desc0, desc1, xy0, xy1, size0, size1, heads: int):
    """One pair: descriptors (n0, D), (n1, D), pixel keypoints (n0, 2),
    (n1, 2) of images of size (H, W) `size0`, `size1` -> (log-assignment
    (n0, n1), matchability logits z0 (n0,), z1 (n1,)), float32."""
    n_layers = sum(1 for k in p if k.endswith(".self_attn.Wqkv.weight"))
    x0, x1 = linear(p, "input_proj", desc0), linear(p, "input_proj", desc1)
    wr = p["posenc.Wr.weight"]
    a0 = F.linear(normalize_keypoints(xy0, *size0), wr)
    a1 = F.linear(normalize_keypoints(xy1, *size1), wr)
    for i in range(n_layers):
        name = f"transformers.{i}"
        x0 = self_block(p, name + ".self_attn", x0, a0, heads)
        x1 = self_block(p, name + ".self_attn", x1, a1, heads)
        x0, x1 = cross_block(p, name + ".cross_attn", x0, x1, heads)
    with torch.autocast(x0.device.type, enabled=False):
        x0, x1 = x0.float(), x1.float()
        d = x0.shape[1]
        f0 = linear(p, "final_proj", x0) / d ** 0.25
        f1 = linear(p, "final_proj", x1) / d ** 0.25
        sim = f0 @ f1.T
        z0 = linear(p, "matchability", x0)[:, 0]
        z1 = linear(p, "matchability", x1)[:, 0]
        log_assign = (F.log_softmax(sim, dim=1) + F.log_softmax(sim, dim=0)
                      + F.logsigmoid(z0)[:, None] + F.logsigmoid(z1)[None, :])
    return log_assign, z0, z1


def mutual_matches(log_assign, threshold: float):
    """(i0, i1): the pairs that are each other's argmax with confidence
    exp(log-assignment) above `threshold`, in the order of i0."""
    best1 = log_assign.argmax(1)
    best0 = log_assign.argmax(0)
    i0 = torch.arange(log_assign.shape[0], device=log_assign.device)
    conf = torch.exp(log_assign.max(1).values)
    keep = (best0[best1] == i0) & (conf > threshold)
    return i0[keep], best1[keep]
