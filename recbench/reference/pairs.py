"""Plain reference of the SIFT pair step: SIFT (DoG scale space, 3-D
extrema, subpixel refinement, the window-route orientation and
descriptor), int8 2-NN with the 0.75 ratio test, 4-point homography
RANSAC.

A frozen copy of the plain PyTorch path of `tpu3drec_torch` as it stood
when the benchmark was written (`ops/sift.py`, `ops/image.py`,
`ops/pallas_sample.py:ori_desc_plain`, `ops/match.py`,
`ops/pallas_match.py:knn2_plain`, `ops/ransac.py`, `ops/geometry.py`,
`pair_step.py`), with no kernel, cache or profiler range. It imports
nothing of the program, so a later change to the program cannot move
the yardstick. `precision="tf32"` rounds the operands of the scale
space's float32 matmuls to TF32 (10 mantissa bits, round to nearest),
as the tensor cores do with TF32 on: that is the control, one precision
below the configuration's float32 with TF32 off.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

RATIO = 0.75

# ---- from ops/sift.py

N_LAYERS = 3


SIGMA0 = 1.6


INIT_SIGMA = 0.5


ORI_BINS = 36


ORI_SIG_FCTR = 1.5


ORI_RADIUS_FCTR = 4.5


DESC_D = 4


DESC_B = 8


DESC_SCL_FCTR = 3.0


DESC_MAG_THR = 0.2


_OBIN_REV = (-np.arange(8)) % 8


_STENCIL = [(0, 0, 0),
            (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
            (0, 0, 1), (0, 0, -1),
            (1, 1, 0), (1, -1, 0), (-1, 1, 0), (-1, -1, 0),
            (1, 0, 1), (1, 0, -1), (-1, 0, 1), (-1, 0, -1),
            (0, 1, 1), (0, 1, -1), (0, -1, 1), (0, -1, -1)]


def num_octaves(h: int, w: int, min_size: int = 16) -> int:
    return max(1, int(math.floor(math.log2(min(h, w) / min_size))) + 1)


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
    b = 5
    ok[:, 1:N_LAYERS + 1, b:h - b, b:w - b] = True
    return is_ext & ok


def _refine_candidates(dog: torch.Tensor, sel_s, sel_y, sel_x,
                       contrast_threshold: float, edge_threshold: float):
    """Quadratic subpixel refinement + contrast & edge rejection for
    (B, C) candidates. Tap indices are clamped into the stack: a
    zero-score slot can sit at a border, and `keep` masks it."""
    B, s, h, w = dog.shape
    flat = dog.reshape(B, -1)
    base = sel_s * (h * w) + sel_y * w + sel_x
    offs = torch.tensor([ds * (h * w) + dy * w + dx for ds, dy, dx in _STENCIL],
                        device=dog.device)
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


# ---- from ops/image.py

@functools.lru_cache(maxsize=256)
def _band_matrix(n: int, sigma: float, radius: int = None) -> np.ndarray:
    """(n, n) banded Toeplitz blur matrix with reflect-101 boundary.

    Taps are built in float64 and the matrix accumulated in float32,
    exactly as the reference builds it, so both packages blur with the
    same constants. The cache holds read-only numpy arrays."""
    if radius is None:
        radius = max(1, int(math.ceil(4.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    taps = np.exp(-0.5 * (x / sigma) ** 2)
    taps /= taps.sum()
    B = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    for k, w in zip(range(-radius, radius + 1), taps):
        j = idx + k
        j = np.where(j < 0, -j, j)
        j = np.where(j >= n, 2 * (n - 1) - j, j)
        B[idx, j] += w
    B.setflags(write=False)
    return B


def band_matrix(n: int, sigma: float, device) -> torch.Tensor:
    """`_band_matrix` as a float32 tensor on `device`."""
    return torch.tensor(_band_matrix(n, float(sigma)), device=device)


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour decimation (SIFT octave downsampling)."""
    return img[..., ::2, ::2]


# ---- from ops/pallas_sample.py

WIN_H = 96


CORE_H = 88


CORE_W = 128


ORI_H = 56


CELL = 4


CH, CW = CORE_H // CELL, CORE_W // CELL


_TWO_PI = 2 * math.pi


def frac_bits(hp: int, wp: int) -> int:
    """Fixed-point fraction bits of the (x, y) meta: the largest fb <= 6
    with 2**(16-fb) >= max(hp, wp), so every coordinate of the padded
    stack fits a 16-bit field."""
    m = max(hp, wp)
    if m > 32768:
        raise ValueError(f"image dim {m} exceeds the 16-bit meta pack")
    return max(1, min(6, 16 - (m - 1).bit_length()))


def pad_dims(h: int, w: int):
    """The reference's padded gradient-stack dims; `hp` sets the window
    row quantisation and both set `frac_bits`."""
    hp = max(WIN_H, (h + 7) // 8 * 8)
    wp = max(256, (w + 127) // 128 * 128)
    return hp, wp


def prep_meta(xs, ys, layer, scl, keep, hp: int, wp: int) -> torch.Tensor:
    """(K, 4) int32 meta `[xq, yq, sclq, layer]`: x, y rounded (half to
    even) to 1/2**frac_bits(hp, wp) px, the scale to 1/1024, and `layer`
    set to -1 where `keep` is False."""
    scale = float(1 << frac_bits(hp, wp))
    xq = torch.clamp(torch.round(xs * scale), 0, 65535).to(torch.int32)
    yq = torch.clamp(torch.round(ys * scale), 0, 65535).to(torch.int32)
    sclq = torch.clamp(torch.round(scl.to(torch.float32) * 1024.0),
                       0, 32767).to(torch.int32)
    lay = torch.where(keep, layer.to(torch.int32),
                      torch.full_like(xq, -1))
    return torch.stack([xq, yq, sclq, lay], dim=1).contiguous()


def _floor_div(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def _fmod_floor(x, m: float):
    """`jnp.remainder` for floats: fmod, shifted into [0, m)."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def _geometry(meta: torch.Tensor, hp: int, fb: int):
    """Per-keypoint dequantised coords and the window origins."""
    xq, yq, sclq, lay = meta.to(torch.int64).unbind(1)
    inv = 1.0 / (1 << fb)
    x = xq.to(torch.float32) * inv
    y = yq.to(torch.float32) * inv
    scl = sclq.to(torch.float32) * (1.0 / 1024.0)
    half = 1 << (fb - 1)
    rxi = (xq + half) >> fb
    ryi = (yq + half) >> fb
    y0 = torch.clamp(_floor_div(ryi - 44, 8) * 8, 0, hp - WIN_H)
    yoff = ryi - y0
    row0 = torch.clamp(_floor_div(yoff - 40, 8) * 8, 0, WIN_H - CORE_H)
    row0b = torch.clamp(_floor_div(yoff - ORI_H // 2, 8) * 8, 0,
                        WIN_H - ORI_H)
    return x, y, scl, lay, rxi - 64, y0 + row0, y0 + row0b


def _window(flat, lay, row_start, nrows: int, col_start, h: int, w: int):
    """(K, nrows, 128) f32 slab of a flattened (L*h*w,) stack, zero
    outside the image, plus the absolute row / column indices."""
    dev = flat.device
    rows = row_start[:, None] + torch.arange(nrows, device=dev)
    cols = col_start[:, None] + torch.arange(CORE_W, device=dev)
    inside = (((rows >= 0) & (rows < h))[:, :, None]
              & ((cols >= 0) & (cols < w))[:, None, :])
    idx = (lay[:, None, None] * (h * w)
           + rows.clamp(0, h - 1)[:, :, None] * w
           + cols.clamp(0, w - 1)[:, None, :])
    vals = flat[idx].to(torch.float32)
    return torch.where(inside, vals, torch.zeros_like(vals)), rows, cols


def _band_histogram(dxf, dyf, meta, hp: int, fb: int, h: int, w: int):
    """The twice-smoothed 36-bin orientation histogram (k, 36) over each
    VALID keypoint's band."""
    x, y, scl, lay, xs0, _, ysb = _geometry(meta, hp, fb)
    k = meta.shape[0]
    dev = dxf.device
    bdx, brows, bcols = _window(dxf, lay, ysb, ORI_H, xs0, h, w)
    bdy, _, _ = _window(dyf, lay, ysb, ORI_H, xs0, h, w)
    magb = torch.sqrt(bdx * bdx + bdy * bdy)
    thetab = torch.atan2(bdy, bdx)
    inv_scl = (1.0 / scl)[:, None]
    ub = ((bcols.to(torch.float32) - x[:, None]) * inv_scl)[:, None, :]
    vb = ((brows.to(torch.float32) - y[:, None]) * inv_scl)[:, :, None]
    mb = (ub.abs() <= ORI_RADIUS_FCTR) & (vb.abs() <= ORI_RADIUS_FCTR)
    wgt = torch.exp(-(ub * ub + vb * vb) / (2.0 * ORI_SIG_FCTR ** 2)) * mb
    binf = (thetab / _TWO_PI + 0.5) * ORI_BINS
    b0f = torch.floor(binf)
    b0 = b0f.to(torch.int64) % ORI_BINS
    frac = binf - b0f
    w_all = magb * wgt
    hist = torch.zeros(k, ORI_BINS, device=dev)
    hist.scatter_add_(1, b0.reshape(k, -1), (w_all * (1.0 - frac)).reshape(k, -1))
    hist.scatter_add_(1, ((b0 + 1) % ORI_BINS).reshape(k, -1),
                      (w_all * frac).reshape(k, -1))

    def smooth(hh):
        return (6 * hh + 4 * (hh.roll(1, -1) + hh.roll(-1, -1))
                + hh.roll(2, -1) + hh.roll(-2, -1)) / 16.0

    return smooth(smooth(hist))


def _ori_desc_dense(dxf, dyf, meta, hp: int, fb: int, h: int, w: int):
    """Dense form for a chunk of VALID keypoints: (angle (k,), raw (k,16,8))."""
    x, y, scl, lay, xs0, ys0, _ = _geometry(meta, hp, fb)
    k = meta.shape[0]
    dev = dxf.device

    # ---- orientation: the histogram's first argmax and a parabolic peak
    hist = _band_histogram(dxf, dyf, meta, hp, fb, h, w)
    pk = torch.argmax(hist, dim=1)
    hl = hist.gather(1, ((pk - 1) % ORI_BINS)[:, None])[:, 0]
    hc = hist.gather(1, pk[:, None])[:, 0]
    hr = hist.gather(1, ((pk + 1) % ORI_BINS)[:, None])[:, 0]
    denom = hl - 2 * hc + hr
    safe = denom.abs() > 1e-12
    dbin = torch.where(safe, 0.5 * (hl - hr) / torch.where(
        safe, denom, torch.ones_like(denom)), torch.zeros_like(denom))
    angle = (_fmod_floor(pk.to(torch.float32) + dbin, float(ORI_BINS))
             / ORI_BINS - 0.5) * 2 * math.pi

    # ---- descriptor: 8 orientation channels, 4x4 box cells, tent binning
    dx, rows, cols = _window(dxf, lay, ys0, CORE_H, xs0, h, w)
    dy, _, _ = _window(dyf, lay, ys0, CORE_H, xs0, h, w)
    mag = torch.sqrt(dx * dx + dy * dy)
    theta = torch.atan2(dy, dx)
    ca = torch.cos(angle)[:, None, None]
    sa = torch.sin(angle)[:, None, None]
    inv_hw = (1.0 / (DESC_SCL_FCTR * scl))[:, None, None]
    rx = (cols.to(torch.float32) - x[:, None])[:, None, :]
    ry = (rows.to(torch.float32) - y[:, None])[:, :, None]
    ud = (ca * rx + sa * ry) * inv_hw
    vd = (-sa * rx + ca * ry) * inv_hw
    wd = torch.exp(-(ud * ud + vd * vd) / (2 * (0.5 * DESC_D) ** 2))
    okb = ((vd + 1.5 > -1) & (vd + 1.5 < DESC_D)
           & (ud + 1.5 > -1) & (ud + 1.5 < DESC_D))
    obin = _fmod_floor((theta - angle[:, None, None]) / _TWO_PI, 1.0) * DESC_B
    magw = mag * wd * okb
    o = torch.arange(DESC_B, device=dev, dtype=torch.float32)[None, :, None, None]
    d = (obin[:, None] - o).abs()
    tent = torch.clamp(1.0 - torch.minimum(d, DESC_B - d), min=0.0)
    coarse = (magw[:, None] * tent).reshape(
        k, DESC_B, CH, CELL, CW, CELL).sum(dim=(3, 5))        # (k, 8, 22, 32)

    # cell-centre spatial bins
    jcc = torch.arange(CW, device=dev, dtype=torch.float32)
    icc = torch.arange(CH, device=dev, dtype=torch.float32)
    rx_c = ((xs0.to(torch.float32)[:, None] + CELL * jcc + 0.5 * (CELL - 1))
            - x[:, None])[:, None, :]
    ry_c = ((ys0.to(torch.float32)[:, None] + CELL * icc + 0.5 * (CELL - 1))
            - y[:, None])[:, :, None]
    ud_c = (ca * rx_c + sa * ry_c) * inv_hw
    vd_c = (-sa * rx_c + ca * ry_c) * inv_hw
    rbin = vd_c + (DESC_D / 2 - 0.5)
    cbin = ud_c + (DESC_D / 2 - 0.5)
    r = torch.arange(DESC_D, device=dev, dtype=torch.float32)[None, :, None, None]
    tr = torch.clamp(1.0 - (rbin[:, None] - r).abs(), min=0.0)   # (k, 4, 22, 32)
    tc = torch.clamp(1.0 - (cbin[:, None] - r).abs(), min=0.0)
    raw = torch.einsum("krhw,kchw,kohw->krco", tr, tc, coarse)
    return angle, raw.reshape(k, DESC_D * DESC_D, DESC_B)


def normalize_descriptors(raw: torch.Tensor) -> torch.Tensor:
    """(K, 16, 8) raw -> (K, 128): cv2 orientation-bin order, unit norm,
    clip at 0.2, renormalise to 512."""
    K = raw.shape[0]
    desc = raw[:, :, torch.as_tensor(_OBIN_REV, device=raw.device)].reshape(K, -1)
    norm = torch.linalg.vector_norm(desc, dim=1, keepdim=True)
    desc = desc / torch.clamp(norm, min=1e-12)
    desc = torch.clamp(desc, max=DESC_MAG_THR)
    norm = torch.linalg.vector_norm(desc, dim=1, keepdim=True)
    return 512.0 * desc / torch.clamp(norm, min=1e-12)


# ---- from ops/match.py

def quantize_u8(desc: torch.Tensor) -> torch.Tensor:
    """float descriptors on the 0..255 scale -> int8 (round half to even,
    shifted by -128, distance-invariant)."""
    return (torch.round(torch.clamp(desc, 0.0, 255.0)) - 128.0).to(torch.int8)


# ---- from ops/pallas_match.py

INT_BIG = 2 ** 31 - 1


def _top2(raw, big):
    """(idx, val) of the two smallest values along the last axis, ties to
    the lowest index (the reference's `_top2_min`)."""
    i1 = torch.argmin(raw, dim=-1, keepdim=True)
    v1 = raw.gather(-1, i1)
    cols = torch.arange(raw.shape[-1], device=raw.device)
    masked = torch.where(cols == i1, big, raw)
    i2 = torch.argmin(masked, dim=-1, keepdim=True)
    v2 = masked.gather(-1, i2)
    return torch.cat([i1, i2], -1), torch.cat([v1, v2], -1)


def _raw_block(a, b, bnorm, mask2):
    """Masked `bnorm - 2 a.b` of every row of `a` against the rows of `b`."""
    if a.dtype == torch.int8:
        # int8 products summed over D <= 1024 stay below 2**24, so a
        # float32 product is exact whatever its summation order
        dot = torch.matmul(a.to(torch.float32),
                           b.to(torch.float32).transpose(1, 2)).to(torch.int32)
    else:
        dot = torch.matmul(a, b.transpose(1, 2))
    raw = bnorm[:, None, :] - 2 * dot
    big = torch.full((), INT_BIG if a.dtype == torch.int8 else 3.4e38, dtype=raw.dtype, device=raw.device)
    return torch.where(mask2[:, None, :], raw, big), big


# ---- from ops/ransac.py

_U_HIGH = 2 ** 31 - 1


def draw_uniform(num_hypotheses: int, sample_size: int,
                 generator: torch.Generator, device=None) -> torch.Tensor:
    """(K, s) int32 uniforms in [0, 2**31 - 1), the reference's range,
    drawn on the generator's device and moved to `device`."""
    return torch.randint(0, _U_HIGH, (num_hypotheses, sample_size),
                         generator=generator, device=generator.device,
                         dtype=torch.int64).to(device=device, dtype=torch.int32)


def ranks_to_indices(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, K, s) distinct indices of valid points from uniforms `u`
    ((K, s), shared by every problem, or (B, K, s)).

    Floyd's algorithm draws s distinct ranks in [0, n_valid) (a collision
    at step j is replaced by the rank n_valid - s + j); ranks map to
    point indices through the mask cumsum. With fewer than s valid points
    the out-of-range ranks land on masked points, and the degenerate
    models are rejected by the scoring."""
    B, n = mask.shape
    s = u.shape[-1]
    if u.ndim == 2:
        u = u.expand(B, *u.shape)
    u = u.to(torch.int64)
    m = mask.to(torch.int64)
    nv = torch.clamp(m.sum(-1), min=s)[:, None]            # (B, 1)
    csum = torch.cumsum(m, dim=-1)
    ranks = []
    for j in range(s):
        t = u[..., j] % (nv - s + 1 + j)
        for r in ranks:
            t = torch.where(t == r, nv - s + j, t)
        ranks.append(t)
    ranks = torch.stack(ranks, dim=-1)                      # (B, K, s)
    idx = torch.searchsorted(csum, ranks.reshape(B, -1) + 1, side="left")
    return torch.clamp(idx, max=n - 1).reshape(ranks.shape)


# ---- from ops/geometry.py

_SQRT2 = math.sqrt(2.0)


def _homography_4pt_flat(p1: torch.Tensor, p2: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact minimal 4-point homography (projective-basis method, written
    out as scalar formulas): p1, p2 (..., 4, 2) -> (h (..., 9), valid)."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]

    def norm4(x, y):
        mx = 0.25 * x.sum(-1, keepdim=True)
        my = 0.25 * y.sum(-1, keepdim=True)
        cx = x - mx
        cy = y - my
        md = 0.25 * torch.sqrt(cx * cx + cy * cy).sum(-1, keepdim=True)
        s = _SQRT2 / torch.clamp(md, min=1e-9)
        return cx * s, cy * s, s[..., 0], mx[..., 0], my[..., 0]

    x, y, s1, mx1, my1 = norm4(x, y)
    u, v, s2, mx2, my2 = norm4(u, v)

    def basis(px, py):
        x1, x2, x3, x4 = px.unbind(-1)
        y1, y2, y3, y4 = py.unbind(-1)
        l1 = (y2 - y3) * x4 + (x3 - x2) * y4 + (x2 * y3 - x3 * y2)
        l2 = (y3 - y1) * x4 + (x1 - x3) * y4 + (x3 * y1 - x1 * y3)
        l3 = (y1 - y2) * x4 + (x2 - x1) * y4 + (x1 * y2 - x2 * y1)
        return (l1 * x1, l2 * x2, l3 * x3,
                l1 * y1, l2 * y2, l3 * y3,
                l1, l2, l3), (l1, l2, l3)

    B1, lam1 = basis(x, y)
    B2, lam2 = basis(u, v)
    a, b, c, d, e, f, g, h_, i = B1
    A00 = e * i - f * h_
    A01 = c * h_ - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h_ - e * g
    A21 = b * g - a * h_
    A22 = a * e - b * d
    p, q, r, t, w, z, m, n, o = B2
    H00 = p * A00 + q * A10 + r * A20
    H01 = p * A01 + q * A11 + r * A21
    H02 = p * A02 + q * A12 + r * A22
    H10 = t * A00 + w * A10 + z * A20
    H11 = t * A01 + w * A11 + z * A21
    H12 = t * A02 + w * A12 + z * A22
    H20 = m * A00 + n * A10 + o * A20
    H21 = m * A01 + n * A11 + o * A21
    H22 = m * A02 + n * A12 + o * A22
    inv_s2 = 1.0 / s2
    G00 = H00 * inv_s2 + mx2 * H20
    G01 = H01 * inv_s2 + mx2 * H21
    G02 = H02 * inv_s2 + mx2 * H22
    G10 = H10 * inv_s2 + my2 * H20
    G11 = H11 * inv_s2 + my2 * H21
    G12 = H12 * inv_s2 + my2 * H22
    t02 = -s1 * mx1
    t12 = -s1 * my1
    F00 = G00 * s1
    F01 = G01 * s1
    F02 = G00 * t02 + G01 * t12 + G02
    F10 = G10 * s1
    F11 = G11 * s1
    F12 = G10 * t02 + G11 * t12 + G12
    F20 = H20 * s1
    F21 = H21 * s1
    F22 = H20 * t02 + H21 * t12 + H22

    lam_min = torch.stack([lam1[0].abs(), lam1[1].abs(), lam1[2].abs(),
                           lam2[0].abs(), lam2[1].abs(), lam2[2].abs()],
                          -1).amin(-1)
    ok = (lam_min > 1e-12) & (F22.abs() > 1e-12)
    inv = torch.where(ok, 1.0 / torch.where(ok, F22, torch.ones_like(F22)),
                      torch.ones_like(F22))
    hv = torch.stack([F00, F01, F02, F10, F11, F12, F20, F21, F22], -1) \
        * inv[..., None]
    return hv, ok & torch.isfinite(hv).all(-1)


def _homography_transfer_error_flat(hv: torch.Tensor, pts1: torch.Tensor,
                                    pts2: torch.Tensor) -> torch.Tensor:
    """Transfer error of flat models: hv (B, K, 9), pts (B, N, 2) ->
    (B, K, N)."""
    x = pts1[..., None, :, 0]
    y = pts1[..., None, :, 1]
    h = [hv[..., j, None] for j in range(9)]
    px = h[0] * x + h[1] * y + h[2]
    py = h[3] * x + h[4] * y + h[5]
    z = h[6] * x + h[7] * y + h[8]
    bad = z.abs() < 1e-10
    zi = 1.0 / torch.where(bad, torch.ones_like(z), z)
    ex = px * zi - pts2[..., None, :, 0]
    ey = py * zi - pts2[..., None, :, 1]
    return torch.where(bad, torch.full_like(z, 1e12), ex * ex + ey * ey)


# ---- precision of the scale space's matmuls

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def matmul_for(precision: str):
    if precision == "float32":
        return torch.matmul
    if precision == "tf32":
        return lambda a, b: torch.matmul(tf32_round(a), tf32_round(b))
    raise ValueError(f"unknown precision {precision!r}")


def gaussian_blur_matmul(img, sigma, mm):
    if sigma <= 0:
        return img
    h, w = img.shape[-2:]
    bh = band_matrix(h, sigma, img.device)
    bw = band_matrix(w, sigma, img.device)
    return mm(mm(bh, img), bw.T)


def _gaussian_pyramid(img, mm):
    h, w = img.shape[-2:]
    k = 2.0 ** (1.0 / N_LAYERS)
    sigs = [math.sqrt((SIGMA0 * k ** i) ** 2 - SIGMA0 ** 2)
            for i in range(1, N_LAYERS + 3)]
    rh = torch.stack([band_matrix(h, s, img.device) for s in sigs])
    cw = torch.stack([band_matrix(w, s, img.device) for s in sigs])
    t = mm(rh, img[:, None])
    out = mm(t, cw.transpose(1, 2))
    return torch.cat([img[:, None], out], dim=1)


# ---- orientation and descriptor (the kernel's plain form)

def ori_desc_plain(dxs, dys, meta, hp, fb, chunk):
    _, h, w = dxs.shape
    K = meta.shape[0]
    angle = torch.zeros(K, device=dxs.device)
    raw = torch.zeros(K, DESC_D * DESC_D, DESC_B, device=dxs.device)
    valid = torch.nonzero(meta[:, 3] >= 0)[:, 0]
    dxf, dyf = dxs.reshape(-1), dys.reshape(-1)
    for s in range(0, valid.shape[0], chunk):
        sel = valid[s:s + chunk]
        a, r = _ori_desc_dense(dxf, dyf, meta[sel], hp, fb, h, w)
        angle[sel] = a
        raw[sel] = r
    return angle, raw


# ---- detection

def detect_and_compute(imgs, max_features, precision="float32",
                       contrast_threshold=0.04, edge_threshold=10.0):
    """(xy (B, K, 2), desc (B, K, 128), mask (B, K)) of SIFT on (B, H, W)
    float32 images in [0, 1], K = max_features slots."""
    mm = matmul_for(precision)
    B, h0, w0 = imgs.shape
    dev = imgs.device
    chunk = 1024 if imgs.is_cuda else 64
    sig_diff = math.sqrt(max(SIGMA0 ** 2 - INIT_SIGMA ** 2, 0.01))
    cur = gaussian_blur_matmul(imgs, sig_diff, mm)
    parts = []
    n_oct = num_octaves(h0, w0)
    for o in range(n_oct):
        gauss = _gaussian_pyramid(cur, mm)
        S, hh, wh = gauss.shape[1:]
        dog = gauss[:, 1:] - gauss[:, :-1]
        ext = _dog_extrema_mask(dog, contrast_threshold)
        cap = max(128, (max_features * 5 // 8) >> o)
        score = torch.where(ext, dog.abs(), torch.zeros_like(dog)).reshape(B, -1)
        k_cap = min(cap, score.shape[1])
        vals, idx = torch.topk(score, k_cap, dim=1)
        cand_ok = vals > 0.0
        sel_s = idx // (hh * wh)
        rem = idx % (hh * wh)
        sel_y = rem // wh
        sel_x = rem % wh
        xs, ys, ls, contrast, keep = _refine_candidates(
            dog, sel_s, sel_y, sel_x, contrast_threshold, edge_threshold)
        keep &= cand_ok
        scl = SIGMA0 * torch.exp2(ls / N_LAYERS)
        layer = torch.clamp(torch.round(ls).to(torch.int32), 1, N_LAYERS)
        dx_stack = F.pad(0.5 * (gauss[..., :, 2:] - gauss[..., :, :-2]), (1, 1))
        dy_stack = F.pad(0.5 * (gauss[..., 2:, :] - gauss[..., :-2, :]),
                         (0, 0, 1, 1))
        rdesc = DESC_SCL_FCTR * (DESC_D + 1) * 0.5 * math.sqrt(2.0) * scl
        keep &= ((torch.minimum(xs, wh - 1 - xs) >= 0.45 * rdesc)
                 & (torch.minimum(ys, hh - 1 - ys) >= 0.45 * rdesc))
        cap_c = max(64, k_cap // 2)
        if cap_c < k_cap:
            cscore = torch.where(keep, contrast.abs(), torch.zeros_like(contrast))
            cval, cidx = torch.topk(cscore, cap_c, dim=1)
            keep = keep.gather(1, cidx) & (cval > 0.0)
            xs, ys, contrast, scl, layer = (
                t.gather(1, cidx) for t in (xs, ys, contrast, scl, layer))
        hp, wp = pad_dims(hh, wh)
        fb = frac_bits(hp, wp)
        glayer = layer + (torch.arange(B, device=dev, dtype=torch.int32) * S)[:, None]
        meta = prep_meta(xs.reshape(-1), ys.reshape(-1), glayer.reshape(-1),
                         scl.reshape(-1), keep.reshape(-1), hp, wp)
        dxs = dx_stack.to(torch.bfloat16).reshape(B * S, hh, wh)
        dys = dy_stack.to(torch.bfloat16).reshape(B * S, hh, wh)
        _, raw = ori_desc_plain(dxs, dys, meta, hp, fb, chunk)
        desc = normalize_descriptors(raw)
        factor = 2.0 ** o
        parts.append(dict(xy=torch.stack([xs * factor, ys * factor], dim=-1),
                          response=contrast.abs(),
                          desc=desc.reshape(B, -1, desc.shape[-1]),
                          mask=keep))
        if o + 1 < n_oct:
            cur = downsample2(gauss[:, N_LAYERS])
    merged = {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}
    score = torch.where(merged["mask"], merged["response"],
                        torch.full_like(merged["response"], -float("inf")))
    total = score.shape[1]
    k = min(max_features, total)
    out = merged
    if k < total:
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
    return out["xy"], out["desc"], out["mask"]


# ---- matching

def knn2_l2_int8(desc1, desc2, mask2):
    """(idx (B, N, 2), dist (B, N, 2)) of the masked int8 2-NN."""
    q1, q2 = quantize_u8(desc1), quantize_u8(desc2)
    n1 = q1.to(torch.int32).square().sum(-1, dtype=torch.int32)
    n2 = q2.to(torch.int32).square().sum(-1, dtype=torch.int32)
    raw, big = _raw_block(q1, q2, n2, mask2)
    idx, val = _top2(raw, big)
    val = torch.where(val == INT_BIG, val, val + n1[..., None])
    return idx, torch.sqrt(torch.clamp(val, min=0).to(torch.float32))


# ---- RANSAC

def ransac_homography(pts1, pts2, mask, u, threshold=4.0):
    """(H (B, 3, 3), num_inliers (B,)) of the best 4-point model."""
    B, n = mask.shape
    idx = ranks_to_indices(u.to(pts1.device), mask)
    K = idx.shape[1]
    flat = idx.reshape(B, -1, 1)
    s1 = pts1.gather(1, flat.expand(-1, -1, 2)).reshape(B, K, 4, 2)
    s2 = pts2.gather(1, flat.expand(-1, -1, 2)).reshape(B, K, 4, 2)
    models, valid = _homography_4pt_flat(s1, s2)
    res = _homography_transfer_error_flat(models, pts1, pts2)
    thr2 = torch.tensor(threshold, dtype=torch.float32, device=res.device) ** 2
    inl = (res <= thr2) & mask[:, None, :]
    score = torch.where(inl, thr2 - res, torch.zeros_like(res)).sum(-1)
    score = torch.where(valid, score, torch.full_like(score, -1.0))
    best = torch.argmax(score, dim=1)
    rows = torch.arange(B, device=best.device)
    num_inl = inl[rows, best].sum(-1, dtype=torch.int32)
    success = score[rows, best] > 0
    return (models[rows, best].reshape(-1, 3, 3),
            torch.where(success, num_inl, torch.zeros_like(num_inl)))


# ---- the pair step

def pair_step(img1, img2, max_features, num_hypotheses, precision="float32"):
    """num_matches (B,), num_inliers (B,), homography (B, 3, 3) of the B
    pairs, on the images' device; RANSAC's uniforms drawn as the program
    draws them (one generator seeded with 0 on that device)."""
    B = img1.shape[0]
    xy, desc, mask = detect_and_compute(torch.cat([img1, img2]), max_features,
                                        precision)
    nn_idx, nn_dist = knn2_l2_int8(desc[:B], desc[B:], mask[B:])
    ok = (nn_dist[..., 0] < RATIO * torch.clamp(nn_dist[..., 1], min=1e-12)) \
        & mask[:B]
    p2 = xy[B:].gather(1, nn_idx[..., :1].long().expand(-1, -1, 2))
    gen = torch.Generator(device=img1.device).manual_seed(0)
    u = draw_uniform(num_hypotheses, 4, gen, img1.device)
    H, ni = ransac_homography(xy[:B], p2, ok, u)
    return {"num_matches": ok.sum(-1, dtype=torch.int32),
            "num_inliers": ni, "homography": H}
