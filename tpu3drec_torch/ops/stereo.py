"""Stereo depth on rectified pairs: rectification, cost volumes, SGM
aggregation, winner-take-all with left-right check, un-rectification and
multi-view depth fusion.

Port of the rectified path of `tpu3drec/ops/stereo.py`. The 3x3 camera
math (rectifying homographies, baselines, ray factors) is float32 work
on the host, in the reference's order of operations; grids, warps,
volumes and everything per pixel run on the images' device. Every pair
of a block goes through each stage together: one batched gather per
warp, one (N, D, H, W) cost volume, SGM over all 2N volumes in chunks
of `_SGM_MEGABATCH` (`ops/pallas_sgm.py`: the `sgm` kernel on the card,
its plain version on the CPU). Warps are the plain four-tap gather; the
reference's TPU band warp has no counterpart. Not ported yet: the plane
sweep, its validity test and the blockwise sweep.

The stages run under profiler ranges `dense.rectify`, `dense.cost`,
`dense.sgm`, `dense.wta_lr`, `dense.unrectify` and `dense.fuse`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch.profiler import record_function

from tpu3drec_torch.ops.image import (
    central_gradients, grid_in_bounds, homography_grid, sample_grid,
    to_device,
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
