"""SIFT orientation + descriptor per keypoint: the `ori_desc` kernel.

Port of `tpu3drec/ops/pallas_sample.py:ori_desc_windows`. For each
keypoint slot it reads a window of the bf16 dx/dy gradient stacks at the
keypoint's layer, builds a 36-bin orientation histogram over a
keypoint-centred band (Gaussian-weighted, smoothed twice, argmax with a
parabolic peak) and computes the rotated 4x4x8 SIFT descriptor densely
over the window pixels (orientation tents, 4x4 box cells, trilinear
spatial bins). Invalid slots return zeros.

Three forms of the one function live here:
  - `ori_desc`: the wrapper. CPU tensors go to `ori_desc_plain`; CUDA
    tensors go to the hand-written kernel `csrc/ori_desc.cu` (or raise).
  - `ori_desc_plain`: the same arithmetic as batched dense tensor ops,
    chunked over keypoints (a (K, 88, 128) temporary per channel).
  - `ori_desc_windows`: the wrapper plus the descriptor normalisation
    (cv2 bin order, unit norm, clip at 0.2, renorm to 512), which runs
    outside the kernel as in the reference.

On the card the wrapper makes one call of the kernel library, which
lists the valid slots on the device (no host sync), zeroes the invalid
slots' outputs and visits the valid slots only. The kernel loads and
scans only each slot's `support_boxes` box, the window pixels that can
carry weight; it computes the box itself with the same float32
operations (a launch can write the boxes out, and the card's smoke run
holds them equal to this function). The CPU tests check the function.

Semantics kept from the reference even though the port pads nothing:
window rows start at the 8-quantised `_row_starts` of the padded stack
height `hp = pad_dims(h, w)[0]`, columns at `rxi - 64`; `rxi`/`ryi` are
the fixed-point round-half-up of x, y at 1/2**fb px; the scale travels at
1/1024 px; pixels outside the octave image count as zero. The keypoint
meta is one int32 row `[xq, yq, sclq, layer]` per slot, `layer = -1` for
an invalid slot and otherwise an index into the flattened (images x
layers) stack.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tpu3drec_torch.ops.sift import (
    DESC_B, DESC_D, DESC_MAG_THR, DESC_SCL_FCTR, ORI_BINS, ORI_RADIUS_FCTR,
    ORI_SIG_FCTR, _OBIN_REV,
)

WIN_H = 96     # window rows the core and the band are cut from
CORE_H = 88    # descriptor core rows
CORE_W = 128   # core columns; the keypoint sits at column 64
ORI_H = 56     # orientation band rows
CELL = 4       # box-downsample factor for the descriptor grid
CH, CW = CORE_H // CELL, CORE_W // CELL  # coarse grid (22, 32)
_TWO_PI = 2 * math.pi
# A descriptor pixel has |ud|, |vd| < DESC_D/2 + 0.5 in cells of
# DESC_SCL_FCTR * scl px, so it lies within this many scl of the keypoint
# whatever the angle; the orientation band (|u|, |v| <= ORI_RADIUS_FCTR)
# lies inside the same disc. SUPPORT_SLACK px absorbs float rounding.
SUPPORT_RADIUS_FCTR = DESC_SCL_FCTR * (DESC_D / 2 + 0.5) * math.sqrt(2.0)
SUPPORT_SLACK = 0.5
# csrc/ori_desc.cu caches a box of up to this many pixels in shared memory
# and reads larger ones (scales beyond the detector's) from global memory
CACHE_PX = 6400


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


def support_radius(scl: torch.Tensor) -> torch.Tensor:
    """Radius (px) of the disc around a keypoint outside which no pixel
    has a band or descriptor weight; the kernel computes and loads
    gradients only inside it."""
    return SUPPORT_RADIUS_FCTR * scl + SUPPORT_SLACK


def support_boxes(meta: torch.Tensor, hp: int, fb: int, h: int,
                  w: int) -> torch.Tensor:
    """(K, 4) int32 `[r0, r1, c0, c1]`: the half-open box of octave-image
    pixels that can carry weight for each slot. It is the bounding box of
    the orientation band box (|u|, |v| <= ORI_RADIUS_FCTR, within the
    56 band rows) and the rotation-invariant descriptor box
    (`support_radius`, within the 88 core rows), clipped to the window
    columns and the image. An empty box is all zeros; rows of invalid
    slots are computed all the same and never read."""
    x, y, scl, _, xs0, ys0, ysb = _geometry(meta, hp, fb)
    rb = ORI_RADIUS_FCTR * scl + SUPPORT_SLACK
    rd = support_radius(scl)
    # spans, one column each: band rows, core rows, band cols, core cols
    c = torch.stack([y, y, x, x], 1)
    r = torch.stack([rb, rd, rb, rd], 1)
    lo = torch.stack([ysb, ys0, xs0, xs0], 1)
    col_hi = torch.clamp(xs0 + CORE_W, max=w)
    hi = torch.stack([torch.clamp(ysb + ORI_H, max=h),
                      torch.clamp(ys0 + CORE_H, max=h), col_hi, col_hi], 1)
    a = torch.maximum(torch.ceil(c - r).to(torch.int64), lo).clamp(min=0)
    b = torch.minimum(torch.floor(c + r).to(torch.int64) + 1, hi)
    a_b, a_d = a[:, 0::2], a[:, 1::2]          # band / desc (rows, cols)
    b_b, b_d = b[:, 0::2], b[:, 1::2]
    band = (b_b > a_b).all(1, keepdim=True)
    desc = (b_d > a_d).all(1, keepdim=True)
    big = 1 << 30
    lo_ = torch.minimum(torch.where(band, a_b, big), torch.where(desc, a_d, big))
    hi_ = torch.maximum(torch.where(band, b_b, -big),
                        torch.where(desc, b_d, -big))
    box = torch.stack([lo_[:, 0], hi_[:, 0], lo_[:, 1], hi_[:, 1]], 1)
    return torch.where(band | desc, box, 0).to(torch.int32).contiguous()


def ori_desc_plain(dxs: torch.Tensor, dys: torch.Tensor, meta: torch.Tensor,
                   hp: int, fb: int):
    """Plain PyTorch version of the kernel: (angle (K,), raw (K, 16, 8)).
    Valid slots go through in chunks; a chunk's (k, 8, 88, 128) tent
    tensor is 46 MB per 128 slots."""
    _, h, w = dxs.shape
    K = meta.shape[0]
    chunk = 1024 if dxs.is_cuda else 64
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


def _check(dxs, dys, meta, hp: int, fb: int):
    if dxs.dtype != torch.bfloat16 or dys.dtype != torch.bfloat16:
        raise TypeError("ori_desc: gradient stacks must be bfloat16")
    if dxs.ndim != 3 or dxs.shape != dys.shape:
        raise ValueError(f"ori_desc: stacks must be equal (L, H, W), got "
                         f"{tuple(dxs.shape)} and {tuple(dys.shape)}")
    if meta.dtype != torch.int32 or meta.ndim != 2 or meta.shape[1] != 4:
        raise ValueError("ori_desc: meta must be (K, 4) int32")
    if not (dxs.device == dys.device == meta.device):
        raise ValueError("ori_desc: tensors on different devices")
    if not (dxs.is_contiguous() and dys.is_contiguous()
            and meta.is_contiguous()):
        raise ValueError("ori_desc: tensors must be contiguous")
    if hp < max(WIN_H, dxs.shape[1]) or not 1 <= fb <= 6:
        raise ValueError(f"ori_desc: bad hp={hp} / fb={fb}")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from tpu3drec_torch._nvcc import load
    fn = load("ori_desc").ori_desc_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def launch_kernel(dxs, dys, meta, hp: int, fb: int, angle, raw, work=None,
                  boxes_out=None):
    """One call of csrc/ori_desc.cu, writing every slot of `angle` (K,) and
    `raw` (K, 16, 8): zeros for the invalid slots, the kernel's result
    for the valid ones. `work`, (K + 2,) int32 scratch, receives the
    valid-slot count, a counter and the list of valid slots (in no fixed
    order). The kernel crops each slot to the box that `support_boxes`
    defines, computing it with the same float32 operations; `boxes_out`,
    a (K, 4) int32 tensor, receives those boxes for checks."""
    _, h, w = dxs.shape
    K = meta.shape[0]
    if meta.data_ptr() % 16 or raw.data_ptr() % 16:
        raise ValueError("ori_desc: meta and raw must be 16-byte aligned")
    if work is None:
        work = torch.empty(K + 2, device=dxs.device, dtype=torch.int32)
    with torch.cuda.device(dxs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            dxs.data_ptr(), dys.data_ptr(), meta.data_ptr(), work.data_ptr(),
            K, h, w, hp, fb, SUPPORT_RADIUS_FCTR, SUPPORT_SLACK,
            angle.data_ptr(), raw.data_ptr(),
            0 if boxes_out is None else boxes_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ori_desc kernel launch failed: CUDA error {err}")
    ori_desc.launches += 1


def _launch(dxs, dys, meta, hp: int, fb: int):
    """Outputs from one allocation, one call of the kernel library;
    nothing is read back to the host."""
    K = meta.shape[0]
    nraw = DESC_D * DESC_D * DESC_B
    out = torch.empty(K * (nraw + 1), device=dxs.device, dtype=torch.float32)
    raw = out[:K * nraw].view(K, DESC_D * DESC_D, DESC_B)
    angle = out[K * nraw:]
    if K > 0:
        if meta.data_ptr() % 16:
            meta = meta.clone()            # the kernel reads rows as int4
        launch_kernel(dxs, dys, meta, hp, fb, angle, raw)
    return angle, raw


def ori_desc(dxs: torch.Tensor, dys: torch.Tensor, meta: torch.Tensor,
             hp: int, fb: int):
    """(angle (K,), raw descriptor (K, 16, 8)) for every meta row.

    dxs, dys: (L, H, W) bf16 gradient stacks (images x layers flattened);
    meta: (K, 4) int32 from `prep_meta`, layers in [-1, L); hp, fb: the
    padded stack height and fraction bits (`pad_dims`, `frac_bits`).

    On the card the kernel is bound by its arithmetic (an atan2, a sqrt
    and two exp per support pixel, eight orientation tents per
    descriptor pixel), not by bytes: it reads each slot's support box
    once, mostly from L2. `ori_desc.launches` counts kernel launches."""
    _check(dxs, dys, meta, hp, fb)
    if dxs.device.type == "cpu":
        return ori_desc_plain(dxs, dys, meta, hp, fb)
    if dxs.device.type != "cuda":
        raise ValueError(f"ori_desc: unsupported device {dxs.device}")
    return _launch(dxs, dys, meta, hp, fb)


ori_desc.launches = 0


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


def ori_desc_windows(dxs, dys, meta, hp: int, fb: int):
    """(angle (K,), desc (K, 128)) with the reference's normalisation."""
    angle, raw = ori_desc(dxs, dys, meta, hp, fb)
    return angle, normalize_descriptors(raw)
