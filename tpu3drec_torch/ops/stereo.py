"""Stereo depth: rectification, cost volumes, SGM aggregation,
winner-take-all with left-right check, un-rectification, multi-view
depth fusion, and plane-sweep stereo for unrectified pairs.

Port of `tpu3drec/ops/stereo.py`. The 3x3 camera
math (rectifying homographies, baselines, ray factors) is float32 work
on the host, in the reference's order of operations; grids, warps,
volumes and everything per pixel run on the images' device. Every pair
of a block goes through each stage together: one batched gather per
warp, one (N, D, H, W) cost volume, SGM over all 2N volumes in chunks
of `_SGM_MEGABATCH` (`ops/pallas_sgm.py`: the `sgm` kernel on the card,
its plain version on the CPU). Warps are the plain four-tap gather; the
reference's TPU band warp has no counterpart.

The plane sweep (`plane_sweep_depth`) warps the neighbour view by every
plane's homography in one batched gather, aggregates the (D, H, W)
volume through the same `sgm` route and picks depth by WTA; its
blockwise form keeps an O(H W) carry on the device instead of the volume
(a Python loop over the planes in slabs, no host sync inside).

The stages run under profiler ranges `dense.rectify`, `dense.cost`,
`dense.sgm`, `dense.wta_lr`, `dense.unrectify`, `dense.fuse` and, in the
plane sweep, `dense.sweep_cost`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from tpu3drec_torch.ops.image import (
    box_filter, central_gradients, grid_in_bounds, homography_grid,
    sample_grid, to_device, warp_perspective,
)
from tpu3drec_torch.ops.pallas_sgm import sgm_aggregate_batch

# cost volumes per SGM call, as in the reference's fused program
_SGM_MEGABATCH = 8


def _host(x) -> torch.Tensor:
    """Camera data as a float32 CPU tensor."""
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(v * v)) over the last axis, as `jnp.linalg.norm`."""
    return torch.sqrt(torch.sum(v * v, -1))


# ---------------------------------------------------------------------
# rectification (host camera math, device grids)
# ---------------------------------------------------------------------

def rectify_homographies(K1, K2, R, t, with_rotation: bool = False):
    """Fusiello rectification: homographies H1, H2 mapping each original
    image onto a common fronto-parallel rectified plane, the new K and,
    with `with_rotation`, the cam1 -> rectified rotation R_new.

    (R, t): pose of camera 2 relative to camera 1 (x2 = R x1 + t). All
    arguments may carry leading batch dimensions; float32 on the host."""
    K1, K2, R, t = (_host(a) for a in (K1, K2, R, t))
    Rt = R.transpose(-1, -2)
    vx = (-Rt @ t[..., None])[..., 0]          # c2 - c1, with c1 = 0
    vx = vx / torch.clamp(_norm(vx), min=1e-12)[..., None]
    old_z = torch.tensor([0.0, 0.0, 1.0]).expand_as(vx)
    vy = torch.linalg.cross(old_z, vx)
    ny = _norm(vy)[..., None]
    vy = torch.where(ny > 1e-6, vy / torch.clamp(ny, min=1e-12),
                     torch.tensor([0.0, 1.0, 0.0]))
    vz = torch.linalg.cross(vx, vy)
    R_new = torch.stack([vx, vy, vz], -2)      # cam1 frame -> rectified
    K_new = 0.5 * (K1 + K2)
    K_new[..., 0, 1] = 0.0
    H1 = K_new @ R_new @ torch.linalg.inv(K1)
    H2 = K_new @ (R_new @ Rt) @ torch.linalg.inv(K2)
    if with_rotation:
        return H1, H2, K_new, R_new
    return H1, H2, K_new


def rectify_pair(img1: torch.Tensor, img2: torch.Tensor, K1, K2, R, t):
    """Warp both (..., H, W) images to the rectified frame; returns
    (r1, r2, K_new, baseline, (H1, H2), R_new), the camera terms float32
    on the host."""
    H1, H2, K_new, R_new = rectify_homographies(K1, K2, R, t,
                                                with_rotation=True)
    shape = img1.shape[-2:]
    r1 = sample_grid(img1.expand(*H1.shape[:-2], *shape),
                     *homography_grid(torch.linalg.inv(H1), shape,
                                      img1.device))
    r2 = sample_grid(img2, *homography_grid(torch.linalg.inv(H2), shape,
                                            img2.device))
    Rt, t = _host(R).transpose(-1, -2), _host(t)
    baseline = _norm((-Rt @ t[..., None])[..., 0])
    return r1, r2, K_new, baseline, (H1, H2), R_new


def unrectify_depth(depth_r: torch.Tensor, valid_r: torch.Tensor, H1, K1,
                    R_new, out_shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map rectified-frame depth (..., h, w) back to the ORIGINAL camera-1
    view: sample it at H1 p1 and divide by the ray factor
    (R_new K1^-1 p1)_z. Pixels whose rectified footprint is out of bounds,
    touches an invalid rectified pixel, or looks backward are invalid.
    Returns (depth_ref, valid_ref) of shape (..., *out_shape)."""
    h, w = out_shape
    dev = depth_r.device
    sx, sy = homography_grid(_host(H1), out_shape, dev)
    z_r = sample_grid(depth_r, sx, sy)
    v_r = sample_grid(valid_r.to(torch.float32), sx, sy)
    inb = grid_in_bounds(depth_r.shape[-2:], sx, sy)
    # ray factor: third row of R_new K1^-1 applied to (x, y, 1)
    m = to_device(_host(R_new) @ torch.linalg.inv(_host(K1)), dev)
    m = m[..., None, None]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    ray_z = m[..., 2, 0, :, :] * xs + m[..., 2, 1, :, :] * ys \
        + m[..., 2, 2, :, :]
    safe = torch.where(torch.abs(ray_z) > 1e-9, ray_z, 1.0)
    depth_ref = z_r / safe
    valid = inb & (v_r > 0.999) & (ray_z > 1e-9) & (depth_ref > 1e-9)
    return torch.where(valid, depth_ref, 0.0), valid


# ---------------------------------------------------------------------
# cost volume, SGM, winner-take-all
# ---------------------------------------------------------------------

def _shift_cols(w: int, num_disparities: int, sign: int, device):
    """(D, W) source columns of `roll(x, sign * d)` along the last axis."""
    d = torch.arange(num_disparities, device=device)[:, None]
    return (torch.arange(w, device=device)[None, :] - sign * d) % w


def cost_volume(left: torch.Tensor, right: torch.Tensor,
                num_disparities: int = 64) -> torch.Tensor:
    """(..., D, H, W) SGBM-like matching cost |dI| + 2 |d(grad I)| of
    (..., H, W) images: the right image shifted right by d (wrapping, as
    `jnp.roll`), with the wrapped columns set to 1e3."""
    gl_x, _ = central_gradients(left)
    gr_x, _ = central_gradients(right)
    w = left.shape[-1]
    cols = _shift_cols(w, num_disparities, 1, left.device)
    shifted = right[..., cols].transpose(-2, -3)      # (..., D, H, W)
    gshift = gr_x[..., cols].transpose(-2, -3)
    c = torch.abs(left[..., None, :, :] - shifted) \
        + 2.0 * torch.abs(gl_x[..., None, :, :] - gshift)
    wrapped = torch.arange(w, device=left.device)[None, :] \
        < torch.arange(num_disparities, device=left.device)[:, None]
    return torch.where(wrapped[:, None, :], 1e3, c)


def _right_view_volume(vol: torch.Tensor) -> torch.Tensor:
    """cost_R(d, y, x) = cost_L(d, y, x + d), wrapping (`roll` by -d)."""
    D, h, w = vol.shape[-3:]
    cols = _shift_cols(w, D, -1, vol.device)[:, None, :]
    return torch.gather(vol, -1, cols.expand(*vol.shape))


def sgm_aggregate(volume: torch.Tensor, p1x100: int = 15,
                  p2x100: int = 90) -> torch.Tensor:
    """4-direction semi-global aggregation of a (D, H, W) cost volume."""
    return sgm_aggregate_batch(volume[None], p1x100, p2x100)[0]


def winner_take_all(volume: torch.Tensor):
    """(..., H, W) float disparity with parabolic subpixel refinement, and
    the min-cost map, from (..., D, H, W) costs. Ties go to the lowest d."""
    D = volume.shape[-3]
    d = torch.argmin(volume, dim=-3, keepdim=True)
    c0 = torch.gather(volume, -3, d)
    cm = torch.gather(volume, -3, torch.clamp(d - 1, 0, D - 1))
    cp = torch.gather(volume, -3, torch.clamp(d + 1, 0, D - 1))
    denom = cm - 2 * c0 + cp
    big = torch.abs(denom) > 1e-9
    off = torch.where(big, 0.5 * (cm - cp) / torch.where(big, denom, 1.0), 0.0)
    disp = d.to(torch.float32) + torch.clamp(off, -0.5, 0.5)
    return disp.squeeze(-3), c0.squeeze(-3)


class StereoResult(NamedTuple):
    disparity: torch.Tensor   # (..., H, W) float, invalid = 0
    depth: torch.Tensor       # (..., H, W) float, invalid = 0
    valid: torch.Tensor       # (..., H, W) bool


def _wta_lr_depth(agg_l: torch.Tensor, agg_r: torch.Tensor, fb: torch.Tensor,
                  lr_max_diff: float) -> StereoResult:
    """Winner-take-all + left-right consistency + depth = f*B/d from
    aggregated left/right (..., D, H, W) volumes; `fb` is focal * baseline
    (float32, one per leading index)."""
    disp, _ = winner_take_all(agg_l)
    disp_r, _ = winner_take_all(agg_r)
    # LR check: disp_L(x) == disp_R(x - disp_L(x))
    h, w = disp.shape[-2:]
    xs = torch.arange(w, device=disp.device, dtype=torch.float32) - disp
    xs_i = torch.clamp(torch.round(xs).to(torch.int64), 0, w - 1)
    dr = torch.gather(disp_r, -1, xs_i)
    consistent = torch.abs(disp - dr) <= lr_max_diff
    valid = consistent & (disp > 0.5)
    fb = to_device(fb, disp.device).reshape(*fb.shape, 1, 1)
    depth = torch.where(valid, fb / torch.clamp(disp, min=1e-6), 0.0)
    return StereoResult(disparity=torch.where(valid, disp, 0.0),
                        depth=depth, valid=valid)


def stereo_depth_rectified(left: torch.Tensor, right: torch.Tensor, focal,
                           baseline, num_disparities: int = 64,
                           lr_max_diff: float = 1.5) -> StereoResult:
    """SGBM-equivalent depth from one rectified (H, W) pair:
    depth = f * B / d, with left-right consistency masking."""
    vol = cost_volume(left, right, num_disparities)
    agg2 = sgm_aggregate_batch(torch.stack([vol, _right_view_volume(vol)]))
    fb = _host(focal) * _host(baseline)
    return _wta_lr_depth(agg2[0], agg2[1], fb, lr_max_diff)


def stereo_depth_pair(img1: torch.Tensor, img2: torch.Tensor, K1, K2, R, t,
                      num_disparities: int = 64) -> Dict:
    """Full two-view path: rectify -> SGM -> depth in the ORIGINAL img1
    view ("depth"/"valid", z in the original camera-1 frame); the
    rectified-frame products stay under rectified_* / disparity /
    K_rectified."""
    r1, r2, K_new, baseline, (H1, H2), R_new = rectify_pair(
        img1, img2, K1, K2, R, t)
    res = stereo_depth_rectified(r1, r2, K_new[0, 0], baseline,
                                 num_disparities)
    depth, valid = unrectify_depth(res.depth, res.valid, H1, K1, R_new,
                                   img1.shape)
    return {"rectified_left": r1, "rectified_right": r2,
            "depth": depth, "disparity": res.disparity,
            "valid": valid, "rectified_depth": res.depth,
            "rectified_valid": res.valid, "K_rectified": K_new,
            "H1": H1, "H2": H2, "baseline": baseline}


# ---------------------------------------------------------------------
# blocks of pairs against one reference view, and fusion
# ---------------------------------------------------------------------

def _pairs_block(img_ref, imgs, K_ref, K2s, Rs, ts, num_disparities,
                 lr_max_diff):
    """Rectify + cost + batched SGM + WTA/LR + un-rectify for a block of
    N pairs (img_ref (H, W) against imgs (N, H, W)). Each pair rectifies
    into its own frame, so every depth map is mapped back to the ORIGINAL
    reference view before it leaves. Returns (depths (N, H, W), valids,
    baselines (N,) float32 on the host, K_rectified of pair 0)."""
    N = imgs.shape[0]
    with record_function("dense.rectify"):
        r1, r2, K_new, baseline, (H1, _), R_new = rectify_pair(
            img_ref, imgs, K_ref[None].expand(N, 3, 3), K2s, Rs, ts)
    with record_function("dense.cost"):
        vol = cost_volume(r1, r2, num_disparities)        # (N, D, H, W)
        # left and right view of each pair side by side: (2N, D, H, W)
        vols = torch.stack([vol, _right_view_volume(vol)], 1).flatten(0, 1)
        del vol
    with record_function("dense.sgm"):
        agg = torch.cat([sgm_aggregate_batch(vols[s:s + _SGM_MEGABATCH])
                         for s in range(0, 2 * N, _SGM_MEGABATCH)])
        del vols
    with record_function("dense.wta_lr"):
        res = _wta_lr_depth(agg[0::2], agg[1::2], K_new[:, 0, 0] * baseline,
                            lr_max_diff)
        del agg
    with record_function("dense.unrectify"):
        depths, valids = unrectify_depth(res.depth, res.valid, H1,
                                         K_ref[None].expand(N, 3, 3), R_new,
                                         img_ref.shape[-2:])
    return depths, valids, baseline, K_new[0]


def stereo_depth_pairs_block(img_ref: torch.Tensor, imgs: torch.Tensor,
                             K_ref, K2s, Rs, ts, num_disparities: int = 64,
                             lr_max_diff: float = 1.5) -> Dict:
    """A BLOCK of pairs against one reference view, without fusion (large
    folders go through this in fixed-size chunks)."""
    depths, valids, baselines, K0 = _pairs_block(
        img_ref, imgs, _host(K_ref), _host(K2s), _host(Rs), _host(ts),
        num_disparities, lr_max_diff)
    return {"depths": depths, "valids": valids, "baselines": baselines,
            "K_rectified0": K0}


def stereo_depth_pairs_fused(img_ref: torch.Tensor, imgs: torch.Tensor,
                             K_ref, K2s, Rs, ts, num_disparities: int = 64,
                             fusion: str = "weighted",
                             lr_max_diff: float = 1.5) -> Dict:
    """ALL neighbour pairs of a dense folder + depth fusion. The fused
    depth lives in the ORIGINAL reference view. "meta" is (2, N)
    [baselines; valid_fractions] on the device, for one host pull."""
    depths, valids, baselines, K0 = _pairs_block(
        img_ref, imgs, _host(K_ref), _host(K2s), _host(Rs), _host(ts),
        num_disparities, lr_max_diff)
    with record_function("dense.fuse"):
        fused, fused_valid = fuse_depth_maps(depths, valids, baselines,
                                             method=fusion)
        fracs = torch.mean(valids.to(torch.float32), dim=(1, 2))
    return {"fused_depth": fused, "fused_valid": fused_valid,
            "depths": depths, "valids": valids, "baselines": baselines,
            "valid_fractions": fracs,
            "meta": torch.stack([to_device(baselines, fracs.device), fracs]),
            "K_rectified0": K0}


def fuse_depth_blocks(depths: torch.Tensor, valids: torch.Tensor, baselines,
                      fusion: str = "weighted") -> Dict:
    """Fusion over concatenated block outputs."""
    with record_function("dense.fuse"):
        fused, fused_valid = fuse_depth_maps(depths, valids, baselines,
                                             method=fusion)
        fracs = torch.mean(valids.to(torch.float32), dim=(1, 2))
    return {"fused_depth": fused, "fused_valid": fused_valid,
            "valid_fractions": fracs}


def _nanmedian_midpoint(x: torch.Tensor) -> torch.Tensor:
    """Median over axis 0 ignoring NaN, the two middle values averaged
    (`jnp.nanmedian`); NaN where every value is NaN."""
    s = torch.sort(x, dim=0).values                   # NaN sort last
    n = torch.sum(~torch.isnan(x), dim=0, dtype=torch.float32)
    q = 0.5 * (n - 1)
    hi_i = torch.clamp(torch.minimum(torch.ceil(q), n - 1), min=0)
    lo_i = torch.clamp(torch.minimum(torch.floor(q), n - 1), min=0)
    lo = torch.gather(s, 0, lo_i.to(torch.int64)[None])[0]
    hi = torch.gather(s, 0, hi_i.to(torch.int64)[None])[0]
    return (lo + hi) * 0.5


def fuse_depth_maps(depths: torch.Tensor, valids: torch.Tensor, baselines,
                    method: str = "weighted"):
    """Fuse (V, H, W) per-neighbour depth maps: 'weighted'
    (baseline-weighted average), 'median' or 'best' (widest valid
    baseline). Returns (fused (H, W), any_valid (H, W))."""
    b = to_device(torch.as_tensor(baselines).to(depths.dtype), depths.device)
    w = valids.to(depths.dtype)
    if method == "weighted":
        bw = b[:, None, None] * w
        fused = torch.sum(depths * bw, 0) / torch.clamp(torch.sum(bw, 0),
                                                        min=1e-9)
    elif method == "median":
        masked = torch.where(valids, depths, torch.nan)
        fused = torch.nan_to_num(_nanmedian_midpoint(masked))
    elif method == "best":
        best = torch.argmax(b[:, None, None] * w, dim=0)
        fused = torch.gather(depths, 0, best[None])[0]
    else:
        raise ValueError(f"unknown fusion method {method!r}")
    any_valid = torch.any(valids, dim=0)
    return torch.where(any_valid, fused, 0.0), any_valid


# ---------------------------------------------------------------------
# plane sweep for unrectified pairs
# ---------------------------------------------------------------------

def box_blur(img: torch.Tensor, size: int) -> torch.Tensor:
    """Separable mean filter of `(..., H, W)` (cost aggregation)."""
    if size <= 1:
        return img
    return box_filter(img, size)


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (the product of two float32 values
    is exact in float64; the sum is rounded twice, which moves the result
    only on a float32 tie)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def plane_inv_depths(min_depth: float, max_depth: float,
                     num_planes: int) -> torch.Tensor:
    """The plane sweep's inverse depths, 1/min_depth down to 1/max_depth,
    float32 on the host, bit-equal to the reference's
    `jnp.linspace(1 / min_depth, 1 / max_depth, n)` as XLA:CPU compiles
    it: the step division becomes a multiply by the float32 reciprocal of
    n - 1, `stop * step` is reassociated to `i * (stop * c)`, and the sum
    is contracted to a fused multiply-add on that product. Loops of up to
    33 steps are unrolled, which folds `1 * (stop * c)` at i = 1 and
    contracts the other product there."""
    one = np.float32(1.0)
    start = one / np.float32(min_depth)
    stop = one / np.float32(max_depth)
    n = int(num_planes)
    if n <= 1:
        return torch.from_numpy(np.full(max(n, 0), start, np.float32))
    div = n - 1
    c = one / np.float32(div)
    i = np.arange(div, dtype=np.float32)
    sub = one - i * c
    out = _fma32(i, stop * c, start * sub)
    if div > 1 and div <= 33:
        out[1] = _fma32(start, sub[1], stop * c)
    return torch.from_numpy(np.append(out, stop).astype(np.float32))


def _plane_costs(ref: torch.Tensor, other: torch.Tensor, K_ref, K_other, R,
                 t, inv_d: torch.Tensor, cost_window: int) -> torch.Tensor:
    """(S, H, W) window-aggregated |ref - warped other| for the planes at
    host inverse depths `inv_d` (S,): every plane's homography
    H_d = K_o (R + t n^T d^-1) K_ref^-1 in float32 on the host, all warps
    in one batched gather. As in the reference, H_d is inverted here and
    again inside the warp (out(p) = other(H_d p))."""
    h, w = ref.shape[-2:]
    K_ref, K_other, R, t = (_host(a) for a in (K_ref, K_other, R, t))
    n = torch.tensor([0.0, 0.0, 1.0])
    Hs = K_other @ (R + torch.outer(t, n) * inv_d[:, None, None]) \
        @ torch.linalg.inv(K_ref)
    warped = warp_perspective(other.expand(inv_d.shape[0], h, w),
                              torch.linalg.inv(Hs), (h, w))
    return box_blur(torch.abs(ref - warped), cost_window)


def plane_sweep_depth(ref: torch.Tensor, other: torch.Tensor, K_ref, K_other,
                      R, t, min_depth: float, max_depth: float,
                      num_planes: int = 64, cost_window: int = 5,
                      max_cost: float = 0.15,
                      uniqueness_ratio: float = 10.0) -> StereoResult:
    """Plane-sweep stereo for UNRECTIFIED (H, W) pairs: for each
    fronto-parallel depth plane the neighbour view is warped into the
    reference frame by the plane-induced homography, the cost is a
    window-aggregated absolute difference, and SGM aggregation + subpixel
    WTA pick the depth. Planes are uniform in inverse depth.

    (R, t): pose of `other` relative to `ref` (x_o = R x_r + t). Runs on
    the images' device; the (D, H, W) volume goes through `sgm`."""
    inv_depths = plane_inv_depths(min_depth, max_depth, num_planes)
    with record_function("dense.sweep_cost"):
        volume = _plane_costs(ref, other, K_ref, K_other, R, t, inv_depths,
                              cost_window)
    with record_function("dense.sgm"):
        agg = sgm_aggregate(volume)
    with record_function("dense.wta_lr"):
        idx, _ = winner_take_all(agg)
        inv_dev = to_device(inv_depths, ref.device)
        frac, depth = _interp_depth(idx, inv_dev, num_planes)
        # validity: the best RAW cost clears an absolute photometric
        # threshold, and the best aggregated cost beats every
        # non-neighbouring plane by uniqueness_ratio percent
        valid = _sweep_validity(volume, agg, max_cost, uniqueness_ratio)
    return StereoResult(disparity=frac, depth=torch.where(valid, depth, 0.0),
                        valid=valid)


def _interp_depth(idx: torch.Tensor, inv_depths: torch.Tensor,
                  num_planes: int):
    """Clipped fractional plane index and the depth at it, interpolated in
    inverse depth."""
    frac = torch.clamp(idx, 0, num_planes - 1)
    i0 = torch.clamp(torch.floor(frac).to(torch.int64), 0, num_planes - 2)
    f = frac - i0
    inv_depth = inv_depths[i0] * (1 - f) + inv_depths[i0 + 1] * f
    return frac, 1.0 / torch.clamp(inv_depth, min=1e-9)


def _sweep_validity(raw_vol: torch.Tensor, agg_vol: torch.Tensor, max_cost,
                    uniqueness_ratio, agg_floor: float = 0.2) -> torch.Tensor:
    """Absolute-threshold + uniqueness validity for plane sweeps (cv2
    SGBM's uniquenessRatio analogue): the best raw cost under `max_cost`,
    and the best aggregated cost beating every plane outside its +-1
    neighbours by `uniqueness_ratio` percent (floored at `agg_floor`)."""
    best_raw = torch.amin(raw_vol, dim=0)
    best_agg, bi = torch.min(agg_vol, dim=0)
    di = torch.arange(agg_vol.shape[0], device=agg_vol.device)[:, None, None]
    excl = torch.abs(di - bi[None]) <= 1
    second = torch.amin(torch.where(excl, 3.4e38, agg_vol), dim=0)
    margin = (uniqueness_ratio / 100.0) * torch.clamp(best_agg, min=agg_floor)
    return (best_raw < max_cost) & (second - best_agg >= margin)


def plane_sweep_depth_blockwise(ref: torch.Tensor, other: torch.Tensor, K_ref,
                                K_other, R, t, min_depth: float,
                                max_depth: float, num_planes: int = 64,
                                slab: int = 8, cost_window: int = 5,
                                max_cost: float = 0.15,
                                uniqueness_ratio: float = 10.0
                                ) -> StereoResult:
    """Blockwise plane sweep: the (D, H, W) cost volume never exists. The
    planes run in slabs of `slab` (each slab's warps batched) with an
    O(H W) carry on the device: the running best cost and plane, a
    streaming second best outside the winner's +-1 neighbours, and the
    costs of the planes before and after the winner (the previous plane's
    cost carried across slabs), so the parabolic subpixel step equals the
    full-volume WTA's. No SGM: it needs the whole volume."""
    if num_planes % slab:
        raise ValueError("num_planes must be a multiple of slab")
    h, w = ref.shape
    dev = ref.device
    inv_depths = plane_inv_depths(min_depth, max_depth, num_planes)
    big = 1e30
    best = torch.full((h, w), big, device=dev)
    best_i = torch.full((h, w), -1, dtype=torch.int32, device=dev)
    best2 = torch.full((h, w), big, device=dev)
    c_before = torch.full((h, w), big, device=dev)
    c_after = torch.full((h, w), big, device=dev)
    c_prev = torch.full((h, w), big, device=dev)
    for s in range(0, num_planes, slab):
        with record_function("dense.sweep_cost"):
            costs = _plane_costs(ref, other, K_ref, K_other, R, t,
                                 inv_depths[s:s + slab], cost_window)
        for k in range(slab):
            c, i = costs[k], s + k
            take = c < best
            # streaming second best EXCLUDING the winner's +-1
            # neighbours: when the winner moves here from a non-adjacent
            # plane the old winner becomes eligible; non-winning
            # non-adjacent planes compete directly
            old_nonadj = (i - best_i) > 1
            best2 = torch.where(
                take, torch.where(old_nonadj, torch.minimum(best2, best),
                                  best2),
                torch.where(old_nonadj, torch.minimum(best2, c), best2))
            # the plane right after the current best fills its c_after slot
            c_after = torch.where(~take & (best_i + 1 == i), c, c_after)
            c_before = torch.where(take, c_prev, c_before)
            c_after = torch.where(take, big, c_after)
            best_i = torch.where(take, i, best_i)
            best = torch.where(take, c, best)
            c_prev = c

    # parabolic subpixel around the winning plane (exact vs full volume)
    has_nb = ((best_i > 0) & (best_i < num_planes - 1)
              & (c_before < big / 2) & (c_after < big / 2))
    denom = c_before - 2.0 * best + c_after
    big_d = torch.abs(denom) > 1e-12
    delta = torch.where(has_nb & big_d, 0.5 * (c_before - c_after)
                        / torch.where(big_d, denom, 1.0), 0.0)
    frac, depth = _interp_depth(
        best_i.to(torch.float32) + torch.clamp(delta, -0.5, 0.5),
        to_device(inv_depths, dev), num_planes)
    # absolute photometric gate + streaming uniqueness (raw-cost units;
    # the floor is the raw-scale analogue of _sweep_validity's)
    margin = (uniqueness_ratio / 100.0) * torch.clamp(best, min=0.02)
    valid = (best < max_cost) & (best2 - best >= margin)
    return StereoResult(disparity=frac, depth=torch.where(valid, depth, 0.0),
                        valid=valid)
