"""SIFT: DoG scale space, 3-D extrema, subpixel refinement, then
orientation and descriptor by one of two samplers.

Port of `tpu3drec/ops/sift.py`. Every stage works on a batch of same-size
images `(B, H, W)`, so the `ori_desc` kernel launches once per octave for
the whole batch. Output is the reference's fixed-capacity bundle
`(xy, response, scale, angle, desc, mask)`, each with a leading `B`.

Each octave's DoG stack and extremum score come from `dog_extrema`: the
plain form (subtraction, two `max_pool3d`, gates, `where`) on the CPU,
the hand-written kernel `csrc/dog_extrema.cu` on the card, one launch an
octave with the same bits.

`sampler=` picks how orientation and descriptor are sampled, with the
reference's names: "pallas" (and "auto") runs the window route, the
`ori_desc` kernel on the card and its plain version on the CPU; "xla"
runs the reference's gather sampler (bilinear samples of the bf16
gradient stack on 9x9 and 12x12 grids, histograms as one-hot products)
on any device. `upscale=True` doubles the image first (JAX's linear
resize) and halves coordinates and scales on the way out, as the
reference does. `describe_at_points` gives SIFT orientations and
descriptors at fixed points, for the Harris and GFTT detectors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from tpu3drec_torch.core.types import DescriptorKind, Features
from tpu3drec_torch.ops.image import (
    band_matrix, downsample2, gaussian_blur_matmul, resize,
)
from tpu3drec_torch.utils.profiling import count, span, upload

# ---------------------------------------------------------------------
# constants (OpenCV defaults)
# ---------------------------------------------------------------------
N_LAYERS = 3            # nOctaveLayers
SIGMA0 = 1.6            # base sigma
INIT_SIGMA = 0.5        # assumed blur of the input image
ORI_BINS = 36
ORI_SIG_FCTR = 1.5
ORI_RADIUS_FCTR = 4.5   # 3 * ORI_SIG_FCTR
DESC_D = 4              # descriptor spatial bins
DESC_B = 8              # orientation bins
DESC_SCL_FCTR = 3.0     # hist width = 3 * scale
DESC_MAG_THR = 0.2
ORI_SAMPLES = 9         # orientation-patch side of the gather sampler
DESC_SAMPLES = 12       # descriptor-patch side of the gather sampler
EXTREMA_BORDER = 5      # px along every edge where no extremum is kept

# cv2-compatible orientation-bin direction: OpenCV's descriptor bins run
# the opposite way around the circle from this y-down layout, so the
# columns of every histogram are reversed (see the reference for the
# derivation); the result is byte-compatible with cv2.SIFT descriptors.
_OBIN_REV = (-np.arange(8)) % 8

# (ds, dy, dx) taps of the 3x3x3 quadratic fit
_STENCIL = [(0, 0, 0),
            (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
            (0, 0, 1), (0, 0, -1),
            (1, 1, 0), (1, -1, 0), (-1, 1, 0), (-1, -1, 0),
            (1, 0, 1), (1, 0, -1), (-1, 0, 1), (-1, 0, -1),
            (0, 1, 1), (0, 1, -1), (0, -1, 1), (0, -1, -1)]


def num_octaves(h: int, w: int, min_size: int = 16) -> int:
    return max(1, int(math.floor(math.log2(min(h, w) / min_size))) + 1)


def _patch_offsets_np(n: int) -> np.ndarray:
    """(n*n, 2) float32 (x, y) cell centres of an n x n grid over
    [-0.5, 0.5)^2, x fastest."""
    lin = (np.arange(n, dtype=np.float32) + np.float32(0.5)) / np.float32(n) \
        - np.float32(0.5)
    gx, gy = np.meshgrid(lin, lin, indexing="xy")
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


def _patch_offsets(n: int, device=None) -> torch.Tensor:
    return upload(_patch_offsets_np(n), device)


def _static_desc_bins():
    """The gather sampler's keypoint-independent descriptor constants:
    the 12x12 grid's x and y offsets (in scale units) and its trilinear
    row/column one-hots weighted by the Gaussian window, (144, 16);
    float32, built as the reference builds them."""
    P = DESC_SAMPLES
    offs = _patch_offsets_np(P)
    win = DESC_SCL_FCTR * (DESC_D + 1)
    ox = offs[:, 0] * win
    oy = offs[:, 1] * win
    wgt = np.exp(-(ox ** 2 + oy ** 2)
                 / (2 * (0.5 * DESC_D * DESC_SCL_FCTR) ** 2))

    def lin_onehot(binf, n):
        b0 = np.floor(binf).astype(int)
        f = binf - b0
        oh = np.zeros((len(binf), n), np.float32)
        for i, (b, ff) in enumerate(zip(b0, f)):
            if 0 <= b < n:
                oh[i, b] += 1 - ff
            if 0 <= b + 1 < n:
                oh[i, b + 1] += ff
        return oh

    rbin = oy / DESC_SCL_FCTR + DESC_D / 2 - 0.5
    cbin = ox / DESC_SCL_FCTR + DESC_D / 2 - 0.5
    ohr = lin_onehot(rbin, DESC_D)
    ohc = lin_onehot(cbin, DESC_D)
    rc = (ohr[:, :, None] * ohc[:, None, :]).reshape(len(ox), -1)
    rc = rc * wgt[:, None]
    return (ox.astype(np.float32), oy.astype(np.float32),
            rc.astype(np.float32))


_DESC_OX, _DESC_OY, _DESC_RC = _static_desc_bins()


def _bilinear_taps(x: torch.Tensor, y: torch.Tensor, h: int, w: int):
    """Flat index of the top-left tap and the fractions of bilinear
    samples at (x, y) in an (h, w) image, clamped inside it as the
    reference clamps them (to size - 1.001)."""
    x = torch.clamp(x, 0.0, w - 1.001)
    y = torch.clamp(y, 0.0, h - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return y0.to(torch.int64) * w + x0.to(torch.int64), x - x0, y - y0


def _blend(take, i00: torch.Tensor, w: int, fx: torch.Tensor,
           fy: torch.Tensor) -> torch.Tensor:
    """The bilinear blend of the four taps `take` reads at i00, i00 + 1,
    i00 + w and i00 + w + 1."""
    v00, v01 = take(i00), take(i00 + 1)
    v10, v11 = take(i00 + w), take(i00 + w + 1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def _bilinear_many(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Bilinear samples of `(B, H, W)` at `(B, ...)` coordinates."""
    B, h, w = img.shape
    flat = img.reshape(B, h * w)
    i00, fx, fy = _bilinear_taps(x, y, h, w)
    i00 = i00.reshape(B, -1)
    return _blend(lambda i: flat.gather(1, i).reshape(x.shape), i00, w, fx, fy)


def _sample_gradients(grad_stack: torch.Tensor, layer: torch.Tensor,
                      x: torch.Tensor, y: torch.Tensor):
    """Bilinear samples of both channels of a `(B, 2, S, H, W)` gradient
    stack (bf16 in the detector) at per-keypoint layers: layer `(B, K)`,
    x and y `(B, K, P)`. Each tap is cast to float32 before the blend, as
    in the reference. Returns (gx, gy), each `(B, K, P)` float32."""
    B, _, s, h, w = grad_stack.shape
    i00, fx, fy = _bilinear_taps(x, y, h, w)
    i00 = ((layer.to(torch.int64) * (h * w))[..., None] + i00).reshape(B, -1)

    def chan(flat):
        return _blend(lambda i: flat.gather(1, i).to(torch.float32)
                      .reshape(x.shape), i00, w, fx, fy)

    return (chan(grad_stack[:, 0].reshape(B, -1)),
            chan(grad_stack[:, 1].reshape(B, -1)))


def _orientation_from_samples(gx: torch.Tensor, gy: torch.Tensor,
                              offs: torch.Tensor) -> torch.Tensor:
    """Dominant orientation from `(..., P)` gradient samples on the grid
    `offs` (P, 2): a 36-bin histogram weighted by magnitude and a
    Gaussian, smoothed twice, its peak refined by a parabola."""
    mag = torch.sqrt(gx * gx + gy * gy)
    ori = torch.atan2(gy, gx)
    r2 = torch.sum(offs ** 2, dim=1)
    wgt = torch.exp(-r2 / (2.0 * ORI_SIG_FCTR ** 2))
    bin_f = (ori / (2 * math.pi) + 0.5) * ORI_BINS
    fl = torch.floor(bin_f)
    b0 = fl.to(torch.int64) % ORI_BINS
    frac = bin_f - fl
    w_all = mag * wgt
    oh0 = F.one_hot(b0, ORI_BINS).to(w_all.dtype)
    oh1 = F.one_hot((b0 + 1) % ORI_BINS, ORI_BINS).to(w_all.dtype)
    hist = (torch.einsum("...p,...pb->...b", w_all * (1 - frac), oh0)
            + torch.einsum("...p,...pb->...b", w_all * frac, oh1))

    def smooth(hh):
        return (6 * hh + 4 * (torch.roll(hh, 1, -1) + torch.roll(hh, -1, -1))
                + (torch.roll(hh, 2, -1) + torch.roll(hh, -2, -1))) / 16.0

    hist = smooth(smooth(hist))
    pk = torch.argmax(hist, dim=-1, keepdim=True)
    hl = hist.gather(-1, (pk - 1) % ORI_BINS)[..., 0]
    hc = hist.gather(-1, pk)[..., 0]
    hr = hist.gather(-1, (pk + 1) % ORI_BINS)[..., 0]
    denom = hl - 2 * hc + hr
    safe = denom.abs() > 1e-12
    dbin = torch.where(
        safe, 0.5 * (hl - hr) / torch.where(safe, denom, torch.ones_like(denom)),
        torch.zeros_like(denom))
    return (((pk[..., 0].to(torch.float32) + dbin) % ORI_BINS) / ORI_BINS
            - 0.5) * 2 * math.pi


def _descriptor_from_samples(gx: torch.Tensor, gy: torch.Tensor,
                             angle: torch.Tensor) -> torch.Tensor:
    """(..., 128) descriptors from (..., 144) rotated-patch gradient
    samples: trilinear 4x4x8 binning against the static spatial one-hots,
    cv2's bin direction, normalise, clip at 0.2, renormalise to 512."""
    mag = torch.sqrt(gx * gx + gy * gy)
    ori = torch.atan2(gy, gx) - angle[..., None]
    obin = (ori / (2 * math.pi) % 1.0) * DESC_B
    fl = torch.floor(obin)
    b0 = fl.to(torch.int64) % DESC_B
    f = obin - fl
    oh0 = F.one_hot(b0, DESC_B).to(mag.dtype)
    oh1 = F.one_hot((b0 + 1) % DESC_B, DESC_B).to(mag.dtype)
    t = mag[..., None] * (oh0 * (1 - f)[..., None] + oh1 * f[..., None])
    rc = upload(_DESC_RC, mag.device)
    desc = torch.einsum("...po,pg->...go", t, rc)[
        ..., upload(_OBIN_REV, mag.device)]
    desc = desc.reshape(*mag.shape[:-1], -1)
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc / torch.clamp(norm, min=1e-12)
    desc = torch.clamp(desc, max=DESC_MAG_THR)
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    return 512.0 * desc / torch.clamp(norm, min=1e-12)


def _rotated_desc_grid(x: torch.Tensor, y: torch.Tensor, angle: torch.Tensor,
                       scl: torch.Tensor):
    """(..., 144) sample coordinates of the rotated descriptor grid
    around (x, y) `(...)` at scale `scl`."""
    ox = upload(_DESC_OX, x.device)
    oy = upload(_DESC_OY, x.device)
    ca, sa = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    px = x[..., None] + (ca * ox - sa * oy) * scl[..., None]
    py = y[..., None] + (sa * ox + ca * oy) * scl[..., None]
    return px, py


def _gaussian_pyramid(img: torch.Tensor) -> torch.Tensor:
    """(B, N_LAYERS+3, H, W) stack for one octave; every level is blurred
    directly from the octave base with the composed sigma."""
    h, w = img.shape[-2:]
    k = 2.0 ** (1.0 / N_LAYERS)
    sigs = [math.sqrt((SIGMA0 * k ** i) ** 2 - SIGMA0 ** 2)
            for i in range(1, N_LAYERS + 3)]
    rh = torch.stack([band_matrix(h, s, img.device) for s in sigs])
    cw = torch.stack([band_matrix(w, s, img.device) for s in sigs])
    t = torch.matmul(rh, img[:, None])                 # (B, L, h, w)
    out = torch.matmul(t, cw.transpose(1, 2))
    return torch.cat([img[:, None], out], dim=1)


def _dog_extrema_mask(dog: torch.Tensor, contrast_threshold: float):
    """(B, S, H, W) bool: 3x3x3 extrema above the preliminary contrast
    gate, away from the scale ends and a 5-px border. Max pooling pads
    with -inf, the same as the reference's SAME reduce_window."""
    _, _, h, w = dog.shape
    mx = F.max_pool3d(dog[:, None], 3, 1, 1)[:, 0]
    mn = -F.max_pool3d(-dog[:, None], 3, 1, 1)[:, 0]
    prelim = 0.5 * contrast_threshold / N_LAYERS
    is_ext = ((dog >= mx) | (dog <= mn)) & (dog.abs() > prelim)
    ok = torch.zeros_like(is_ext)
    b = EXTREMA_BORDER
    ok[:, 1:N_LAYERS + 1, b:h - b, b:w - b] = True
    return is_ext & ok


def dog_extrema_plain(gauss: torch.Tensor, contrast_threshold: float):
    """The plain form of `dog_extrema`: the subtraction, the mask and the
    score as separate PyTorch operations."""
    dog = gauss[:, 1:] - gauss[:, :-1]
    ext = _dog_extrema_mask(dog, contrast_threshold)
    return dog, torch.where(ext, dog.abs(), torch.zeros_like(dog))


def dog_extrema_kernel(gauss: torch.Tensor, contrast_threshold: float):
    """The kernel's route for a contiguous CUDA Gaussian stack: one
    launch of `csrc/dog_extrema.cu` on the current stream, counted on the
    counter `dog_extrema.launches`."""
    if gauss.device.type != "cuda":
        raise ValueError("dog_extrema: the kernel takes a CUDA tensor")
    from tpu3drec_torch._nvcc import load
    fn = load("dog_extrema").dog_extrema_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B, S, h, w = gauss.shape
    dog = torch.empty((B, S - 1, h, w), dtype=gauss.dtype, device=gauss.device)
    score = torch.empty_like(dog)
    # the gate as float32, as PyTorch rounds the scalar `dog.abs() > prelim`
    prelim = 0.5 * contrast_threshold / N_LAYERS
    with torch.cuda.device(gauss.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(gauss.data_ptr(), dog.data_ptr(), score.data_ptr(), B, S, h,
                 w, prelim, EXTREMA_BORDER, stream)
    if err != 0:
        raise RuntimeError(f"dog_extrema kernel launch failed: CUDA error {err}")
    count("dog_extrema.launches")
    return dog, score


def dog_extrema(gauss: torch.Tensor, contrast_threshold: float):
    """DoG stack and extremum score of one octave's Gaussian stack
    `(B, N_LAYERS + 3, h, w)` float32, contiguous: `(dog, score)`, each
    `(B, N_LAYERS + 2, h, w)`, where score is |dog| at the 3x3x3 extrema
    that `_dog_extrema_mask` keeps and 0 elsewhere. The plain form for a
    CPU tensor, the kernel (`csrc/dog_extrema.cu`, the same bits) for a
    CUDA tensor."""
    if gauss.dtype != torch.float32 or gauss.ndim != 4:
        raise TypeError(f"dog_extrema: need a (B, S, h, w) float32 stack, "
                        f"got {gauss.dtype} {tuple(gauss.shape)}")
    if gauss.shape[1] != N_LAYERS + 3 or not gauss.is_contiguous():
        raise ValueError(f"dog_extrema: need {N_LAYERS + 3} contiguous "
                         f"levels, got {tuple(gauss.shape)} with strides "
                         f"{gauss.stride()}")
    if gauss.device.type == "cpu":
        return dog_extrema_plain(gauss, contrast_threshold)
    if gauss.device.type != "cuda":
        raise ValueError(f"dog_extrema: unsupported device {gauss.device}")
    return dog_extrema_kernel(gauss, contrast_threshold)


def _refine_candidates(dog: torch.Tensor, sel_s, sel_y, sel_x,
                       contrast_threshold: float, edge_threshold: float):
    """Quadratic subpixel refinement + contrast & edge rejection for
    (B, C) candidates. Tap indices are clamped into the stack: a
    zero-score slot can sit at a border, and `keep` masks it."""
    B, s, h, w = dog.shape
    flat = dog.reshape(B, -1)
    base = sel_s * (h * w) + sel_y * w + sel_x
    offs = upload([ds * (h * w) + dy * w + dx for ds, dy, dx in _STENCIL],
                  dog.device)
    idx = (base[..., None] + offs).clamp(0, s * h * w - 1)
    taps = flat.gather(1, idx.reshape(B, -1)).reshape(*base.shape, len(_STENCIL))
    (v, v_sp, v_sm, v_yp, v_ym, v_xp, v_xm,
     c_pp0, c_pm0, c_mp0, c_mm0,
     c_p0p, c_p0m, c_m0p, c_m0m,
     c_0pp, c_0pm, c_0mp, c_0mm) = taps.unbind(-1)

    d_s = 0.5 * (v_sp - v_sm)
    d_y = 0.5 * (v_yp - v_ym)
    d_x = 0.5 * (v_xp - v_xm)
    dss = v_sp + v_sm - 2 * v
    dyy = v_yp + v_ym - 2 * v
    dxx = v_xp + v_xm - 2 * v
    dsy = 0.25 * (c_pp0 - c_pm0 - c_mp0 + c_mm0)
    dsx = 0.25 * (c_p0p - c_p0m - c_m0p + c_m0m)
    dyx = 0.25 * (c_0pp - c_0pm - c_0mp + c_0mm)

    # closed-form symmetric 3x3 solve (adjugate / determinant)
    det = (dss * (dyy * dxx - dyx * dyx)
           - dsy * (dsy * dxx - dyx * dsx)
           + dsx * (dsy * dyx - dyy * dsx))
    safe = det.abs() > 1e-12
    inv_det = torch.where(safe, 1.0 / torch.where(safe, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    a00 = dyy * dxx - dyx * dyx
    a01 = dsx * dyx - dsy * dxx
    a02 = dsy * dyx - dsx * dyy
    a11 = dss * dxx - dsx * dsx
    a12 = dsy * dsx - dss * dyx
    a22 = dss * dyy - dsy * dsy
    off_s = torch.clamp(-(a00 * d_s + a01 * d_y + a02 * d_x) * inv_det, -0.5, 0.5)
    off_y = torch.clamp(-(a01 * d_s + a11 * d_y + a12 * d_x) * inv_det, -0.5, 0.5)
    off_x = torch.clamp(-(a02 * d_s + a12 * d_y + a22 * d_x) * inv_det, -0.5, 0.5)

    contrast = v + 0.5 * (d_s * off_s + d_y * off_y + d_x * off_x)
    keep = contrast.abs() >= contrast_threshold / N_LAYERS
    tr = dyy + dxx
    det2 = dyy * dxx - dyx * dyx
    r = edge_threshold
    keep &= (det2 > 0) & (tr * tr * r < (r + 1) ** 2 * det2)

    xs = sel_x.to(torch.float32) + off_x
    ys = sel_y.to(torch.float32) + off_y
    ls = sel_s.to(torch.float32) + off_s
    return xs, ys, ls, contrast, keep


@dataclasses.dataclass
class OctaveSample:
    """One octave's refined candidates and the `ori_desc` inputs for them.

    xs, ys, contrast, scl, keep: (B, C) in octave pixels; layer: (B, C)
    int32 gradient level (1..N_LAYERS) of each slot; dxs, dys: (B*S, h, w)
    bf16 gradient stacks; meta: (B*C, 4) int32 (`prep_meta`); hp, fb:
    padded height and fraction bits of this octave's shape; last: whether
    it is the last octave."""

    octave: int
    xs: torch.Tensor
    ys: torch.Tensor
    contrast: torch.Tensor
    scl: torch.Tensor
    keep: torch.Tensor
    layer: torch.Tensor
    dxs: torch.Tensor
    dys: torch.Tensor
    meta: torch.Tensor
    hp: int
    fb: int
    last: bool


def octave_samples(imgs: torch.Tensor, max_features: int = 2048,
                   contrast_threshold: float = 0.04,
                   edge_threshold: float = 10.0,
                   upscale: bool = False) -> Iterator[OctaveSample]:
    """Scale space, extrema, refinement and compaction, octave by octave.

    Yields each octave's candidates together with the exact inputs of its
    `ori_desc` call, so the detector and kernel checks share one path.
    With `upscale`, the scale space is built on the image doubled by JAX's
    linear resize, from a base blur that assumes twice INIT_SIGMA.

    Each octave's work runs under the spans `sift.blur` (the base blur or
    the decimation, then the pyramid), `sift.extrema` and `sift.refine`;
    none stays open across the `yield`."""
    from tpu3drec_torch.ops.pallas_sample import frac_bits, pad_dims, prep_meta

    B, h0, w0 = imgs.shape
    if upscale:
        h0, w0 = 2 * h0, 2 * w0
    dev = imgs.device
    n_oct = num_octaves(h0, w0)
    init = 2 * INIT_SIGMA if upscale else INIT_SIGMA
    sig_diff = math.sqrt(max(SIGMA0 ** 2 - init ** 2, 0.01))
    for o in range(n_oct):
        with span("sift.blur"):
            if o == 0:
                if upscale:
                    imgs = resize(imgs, (h0, w0))
                cur = gaussian_blur_matmul(imgs, sig_diff)
            else:
                cur = downsample2(gauss[:, N_LAYERS])
            gauss = _gaussian_pyramid(cur)              # (B, S, h, w)
        S, hh, wh = gauss.shape[1:]
        with span("sift.extrema"):
            dog, score = dog_extrema(gauss, contrast_threshold)
            score = score.reshape(B, -1)

            # per-octave candidate budget; the global top-K keeps
            # max_features across octaves afterwards
            cap = max(128, (max_features * 5 // 8) >> o)
            k_cap = min(cap, score.shape[1])
            vals, idx = torch.topk(score, k_cap, dim=1)
            cand_ok = vals > 0.0
            sel_s = idx // (hh * wh)
            rem = idx % (hh * wh)
            sel_y = rem // wh
            sel_x = rem % wh

        with span("sift.refine"):
            xs, ys, ls, contrast, keep = _refine_candidates(
                dog, sel_s, sel_y, sel_x, contrast_threshold, edge_threshold)
            keep &= cand_ok
            scl = SIGMA0 * torch.exp2(ls / N_LAYERS)
            layer = torch.clamp(torch.round(ls).to(torch.int32), 1, N_LAYERS)
            # central differences with zero borders
            dx_stack = F.pad(0.5 * (gauss[..., :, 2:] - gauss[..., :, :-2]),
                             (1, 1))
            dy_stack = F.pad(0.5 * (gauss[..., 2:, :] - gauss[..., :-2, :]),
                             (0, 0, 1, 1))

            # reject keypoints whose descriptor support is mostly off-image
            rdesc = DESC_SCL_FCTR * (DESC_D + 1) * 0.5 * math.sqrt(2.0) * scl
            keep &= ((torch.minimum(xs, wh - 1 - xs) >= 0.45 * rdesc)
                     & (torch.minimum(ys, hh - 1 - ys) >= 0.45 * rdesc))

            # compact: keep the strongest half of the slots by refined
            # contrast
            cap_c = max(64, k_cap // 2)
            if cap_c < k_cap:
                cscore = torch.where(keep, contrast.abs(),
                                     torch.zeros_like(contrast))
                cval, cidx = torch.topk(cscore, cap_c, dim=1)
                keep = keep.gather(1, cidx) & (cval > 0.0)
                xs, ys, ls, contrast, scl, layer = (
                    t.gather(1, cidx)
                    for t in (xs, ys, ls, contrast, scl, layer))

            hp, wp = pad_dims(hh, wh)
            glayer = layer + (torch.arange(B, device=dev, dtype=torch.int32)
                              * S)[:, None]
            meta = prep_meta(xs.reshape(-1), ys.reshape(-1),
                             glayer.reshape(-1), scl.reshape(-1),
                             keep.reshape(-1), hp, wp)
            dxs = dx_stack.to(torch.bfloat16).reshape(B * S, hh, wh)
            dys = dy_stack.to(torch.bfloat16).reshape(B * S, hh, wh)
        yield OctaveSample(
            octave=o, xs=xs, ys=ys, contrast=contrast, scl=scl, keep=keep,
            layer=layer, dxs=dxs, dys=dys, meta=meta, hp=hp,
            fb=frac_bits(hp, wp), last=o + 1 == n_oct)


def _gather_ori_desc(oc: OctaveSample):
    """Orientation and descriptor of an octave's slots by the gather
    sampler: (B, C) angles and (B, C, 128) descriptors."""
    B, C = oc.xs.shape
    S = oc.dxs.shape[0] // B
    h, w = oc.dxs.shape[-2:]
    grad = torch.stack([oc.dxs.reshape(B, S, h, w),
                        oc.dys.reshape(B, S, h, w)], dim=1)
    offs = _patch_offsets(ORI_SAMPLES, oc.xs.device) * 2.0 * ORI_RADIUS_FCTR
    px = oc.xs[..., None] + offs[:, 0] * oc.scl[..., None]
    py = oc.ys[..., None] + offs[:, 1] * oc.scl[..., None]
    gx, gy = _sample_gradients(grad, oc.layer, px, py)
    angle = _orientation_from_samples(gx, gy, offs)
    pxd, pyd = _rotated_desc_grid(oc.xs, oc.ys, angle, oc.scl)
    gxd, gyd = _sample_gradients(grad, oc.layer, pxd, pyd)
    return angle, _descriptor_from_samples(gxd, gyd, angle)


def detect_and_compute(imgs: torch.Tensor, max_features: int = 2048,
                       contrast_threshold: float = 0.04,
                       edge_threshold: float = 10.0,
                       upscale: bool = False,
                       sampler: str = "auto"):
    """Full SIFT on `(B, H, W)` float32 images in [0, 1] (a single
    `(H, W)` image is accepted too). Returns `(xy, response, scale,
    angle, desc, mask)` with capacity `max_features` per image.

    sampler: "pallas" or "auto" (the `ori_desc` window route) or "xla"
    (the gather sampler)."""
    from tpu3drec_torch.ops.pallas_sample import ori_desc_windows

    if sampler not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown SIFT sampler {sampler!r}")
    single = imgs.ndim == 2
    if single:
        imgs = imgs[None]
    B = imgs.shape[0]
    parts = []
    for oc in octave_samples(imgs, max_features, contrast_threshold,
                             edge_threshold, upscale):
        with span("sift.ori_desc"):
            if sampler == "xla":
                angle, desc = _gather_ori_desc(oc)
            else:
                angle, desc = ori_desc_windows(oc.dxs, oc.dys, oc.meta,
                                               oc.hp, oc.fb)
        with span("sift.select"):
            factor = (2.0 ** oc.octave) * (0.5 if upscale else 1.0)
            parts.append(dict(
                xy=torch.stack([oc.xs * factor, oc.ys * factor], dim=-1),
                response=oc.contrast.abs(),
                scale=oc.scl * factor * 2.0,
                angle=angle.reshape(B, -1),
                desc=desc.reshape(B, -1, desc.shape[-1]),
                mask=oc.keep,
            ))
            if oc.last:
                res = _select(parts, max_features)
    if single:
        res = tuple(t[0] for t in res)
    return res


def _select(parts, max_features: int):
    """The octaves' parts merged, the global top `max_features` by
    response kept (in octave order when all fit) and padded with zeros:
    `(xy, response, scale, angle, desc, mask)`."""
    merged = {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}
    B = merged["mask"].shape[0]
    score = torch.where(merged["mask"], merged["response"],
                        torch.full_like(merged["response"], -float("inf")))
    total = score.shape[1]
    k = min(max_features, total)
    if k == total:
        # every candidate slot fits: keep the octave order, as the
        # reference does (consumers are order-invariant)
        out = merged
    else:
        top, order = torch.topk(score, k, dim=1)
        out = {}
        for key, v in merged.items():
            ix = order.reshape(order.shape + (1,) * (v.ndim - 2))
            out[key] = v.gather(1, ix.expand(order.shape + v.shape[2:]))
        out["mask"] = out["mask"] & (top > -float("inf"))
    if k < max_features:
        pad = max_features - k
        out = {key: torch.cat([v, v.new_zeros((B, pad) + v.shape[2:])], dim=1)
               for key, v in out.items()}
    return (out["xy"], out["response"], out["scale"], out["angle"],
            out["desc"], out["mask"])


def detect_sift_features(img: torch.Tensor, max_features: int = 2048,
                         contrast_threshold: float = 0.04,
                         edge_threshold: float = 10.0,
                         upscale: bool = False, sampler: str = "auto",
                         method: str = "SIFT", **_unused) -> Features:
    """Detector-contract wrapper returning Features for one `(H, W)`
    image or a `(B, H, W)` batch."""
    xy, resp, scale, angle, desc, mask = detect_and_compute(
        img, max_features=max_features,
        contrast_threshold=contrast_threshold,
        edge_threshold=edge_threshold, upscale=upscale, sampler=sampler)
    return Features(xy=xy, response=resp, scale=scale, angle=angle,
                    desc=desc, mask=mask, method=method,
                    desc_kind=DescriptorKind.FLOAT.value,
                    image_shape=tuple(img.shape[-2:]))


def describe_at_points(img: torch.Tensor, xy: torch.Tensor,
                       mask: torch.Tensor, patch_scale: float = 2.0):
    """SIFT descriptors and orientations at given points, at one fixed
    scale (the Harris and GFTT detectors' descriptor). img `(B, H, W)`,
    xy `(B, K, 2)`, mask `(B, K)` (unbatched `(H, W)`, `(K, 2)`, `(K,)`
    too). Samples float32 central differences of the sigma-1.6 blur,
    zero at the border. Returns (desc (B, K, 128), zero where masked;
    angle (B, K), zero where masked)."""
    single = img.ndim == 2
    if single:
        img, xy, mask = img[None], xy[None], mask[None]
    blur = gaussian_blur_matmul(img, SIGMA0)
    dx = F.pad(0.5 * (blur[..., :, 2:] - blur[..., :, :-2]), (1, 1))
    dy = F.pad(0.5 * (blur[..., 2:, :] - blur[..., :-2, :]), (0, 0, 1, 1))
    x, y = xy[..., 0], xy[..., 1]
    scl = torch.full_like(x, patch_scale)
    offs = _patch_offsets(ORI_SAMPLES, img.device) * 2.0 * ORI_RADIUS_FCTR
    px = x[..., None] + offs[:, 0] * scl[..., None]
    py = y[..., None] + offs[:, 1] * scl[..., None]
    angle = _orientation_from_samples(_bilinear_many(dx, px, py),
                                      _bilinear_many(dy, px, py), offs)
    pxd, pyd = _rotated_desc_grid(x, y, angle, scl)
    desc = _descriptor_from_samples(_bilinear_many(dx, pxd, pyd),
                                    _bilinear_many(dy, pxd, pyd), angle)
    desc = desc * mask[..., None]
    angle = torch.where(mask, angle, torch.zeros_like(angle))
    if single:
        return desc[0], angle[0]
    return desc, angle
