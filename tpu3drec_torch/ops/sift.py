"""SIFT: DoG scale space, 3-D extrema, subpixel refinement, then
orientation and descriptor through the `ori_desc` kernel.

Port of `tpu3drec/ops/sift.py:detect_and_compute` with the window sampler
(`sampler="pallas"` there). Every stage works on a batch of same-size
images `(B, H, W)`, so the `ori_desc` kernel launches once per octave for
the whole batch. Output is the reference's fixed-capacity bundle
`(xy, response, scale, angle, desc, mask)`, each with a leading `B`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from tpu3drec_torch.core.types import DescriptorKind, Features
from tpu3drec_torch.ops.image import (
    band_matrix, downsample2, gaussian_blur_matmul,
)

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


@dataclasses.dataclass
class OctaveSample:
    """One octave's refined candidates and the `ori_desc` inputs for them.

    xs, ys, contrast, scl, keep: (B, C) in octave pixels; dxs, dys:
    (B*S, h, w) bf16 gradient stacks; meta: (B*C, 4) int32 (`prep_meta`);
    hp, fb: padded height and fraction bits of this octave's shape."""

    octave: int
    xs: torch.Tensor
    ys: torch.Tensor
    contrast: torch.Tensor
    scl: torch.Tensor
    keep: torch.Tensor
    dxs: torch.Tensor
    dys: torch.Tensor
    meta: torch.Tensor
    hp: int
    fb: int


def octave_samples(imgs: torch.Tensor, max_features: int = 2048,
                   contrast_threshold: float = 0.04,
                   edge_threshold: float = 10.0) -> Iterator[OctaveSample]:
    """Scale space, extrema, refinement and compaction, octave by octave.

    Yields each octave's candidates together with the exact inputs of its
    `ori_desc` call, so the detector and kernel checks share one path."""
    from tpu3drec_torch.ops.pallas_sample import frac_bits, pad_dims, prep_meta

    B, h0, w0 = imgs.shape
    dev = imgs.device
    n_oct = num_octaves(h0, w0)
    sig_diff = math.sqrt(max(SIGMA0 ** 2 - INIT_SIGMA ** 2, 0.01))
    cur = gaussian_blur_matmul(imgs, sig_diff)
    for o in range(n_oct):
        gauss = _gaussian_pyramid(cur)                  # (B, S, h, w)
        S, hh, wh = gauss.shape[1:]
        dog = gauss[:, 1:] - gauss[:, :-1]
        ext = _dog_extrema_mask(dog, contrast_threshold)

        # per-octave candidate budget; the global top-K keeps
        # max_features across octaves afterwards
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
        # central differences with zero borders
        dx_stack = F.pad(0.5 * (gauss[..., :, 2:] - gauss[..., :, :-2]), (1, 1))
        dy_stack = F.pad(0.5 * (gauss[..., 2:, :] - gauss[..., :-2, :]),
                         (0, 0, 1, 1))

        # reject keypoints whose descriptor support is mostly off-image
        rdesc = DESC_SCL_FCTR * (DESC_D + 1) * 0.5 * math.sqrt(2.0) * scl
        keep &= ((torch.minimum(xs, wh - 1 - xs) >= 0.45 * rdesc)
                 & (torch.minimum(ys, hh - 1 - ys) >= 0.45 * rdesc))

        # compact: keep the strongest half of the slots by refined contrast
        cap_c = max(64, k_cap // 2)
        if cap_c < k_cap:
            cscore = torch.where(keep, contrast.abs(), torch.zeros_like(contrast))
            cval, cidx = torch.topk(cscore, cap_c, dim=1)
            keep = keep.gather(1, cidx) & (cval > 0.0)
            xs, ys, ls, contrast, scl, layer = (
                t.gather(1, cidx) for t in (xs, ys, ls, contrast, scl, layer))

        hp, wp = pad_dims(hh, wh)
        glayer = layer + (torch.arange(B, device=dev, dtype=torch.int32) * S)[:, None]
        meta = prep_meta(xs.reshape(-1), ys.reshape(-1), glayer.reshape(-1),
                         scl.reshape(-1), keep.reshape(-1), hp, wp)
        yield OctaveSample(
            octave=o, xs=xs, ys=ys, contrast=contrast, scl=scl, keep=keep,
            dxs=dx_stack.to(torch.bfloat16).reshape(B * S, hh, wh),
            dys=dy_stack.to(torch.bfloat16).reshape(B * S, hh, wh),
            meta=meta, hp=hp, fb=frac_bits(hp, wp))
        if o + 1 < n_oct:
            cur = downsample2(gauss[:, N_LAYERS])


def detect_and_compute(imgs: torch.Tensor, max_features: int = 2048,
                       contrast_threshold: float = 0.04,
                       edge_threshold: float = 10.0):
    """Full SIFT on `(B, H, W)` float32 images in [0, 1] (a single
    `(H, W)` image is accepted too). Returns `(xy, response, scale,
    angle, desc, mask)` with capacity `max_features` per image."""
    from tpu3drec_torch.ops.pallas_sample import ori_desc_windows

    single = imgs.ndim == 2
    if single:
        imgs = imgs[None]
    B = imgs.shape[0]
    parts = []
    for oc in octave_samples(imgs, max_features, contrast_threshold,
                             edge_threshold):
        angle, desc = ori_desc_windows(oc.dxs, oc.dys, oc.meta, oc.hp, oc.fb)
        factor = 2.0 ** oc.octave
        parts.append(dict(
            xy=torch.stack([oc.xs * factor, oc.ys * factor], dim=-1),
            response=oc.contrast.abs(),
            scale=oc.scl * factor * 2.0,
            angle=angle.reshape(B, -1),
            desc=desc.reshape(B, -1, desc.shape[-1]),
            mask=oc.keep,
        ))

    merged = {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}
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
    res = (out["xy"], out["response"], out["scale"], out["angle"],
           out["desc"], out["mask"])
    if single:
        res = tuple(t[0] for t in res)
    return res


def detect_sift_features(img: torch.Tensor, max_features: int = 2048,
                         contrast_threshold: float = 0.04,
                         edge_threshold: float = 10.0,
                         upscale: bool = False,
                         method: str = "SIFT", **_unused) -> Features:
    """Detector-contract wrapper returning a Features for one image."""
    if upscale:
        raise NotImplementedError("tpu3drec_torch SIFT: upscale=True is "
                                  "not ported yet")
    xy, resp, scale, angle, desc, mask = detect_and_compute(
        img, max_features=max_features,
        contrast_threshold=contrast_threshold,
        edge_threshold=edge_threshold)
    return Features(xy=xy, response=resp, scale=scale, angle=angle,
                    desc=desc, mask=mask, method=method,
                    desc_kind=DescriptorKind.FLOAT.value,
                    image_shape=tuple(img.shape[-2:]))
