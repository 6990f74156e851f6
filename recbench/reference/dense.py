"""Plain reference of the dense stage's depth and cloud: pairwise
rectified SGM stereo of every neighbour against the reference view,
un-rectification, baseline-weighted fusion, backprojection and the
statistical outlier filter.

A frozen copy of the plain PyTorch path of `tpu3drec_torch` as it stood
when the benchmark was written (`ops/stereo.py`, `ops/image.py`,
`ops/pallas_sgm.py:sgm_aggregate_batch_plain`, `ops/pointcloud.py`,
`pipelines/dense.py`'s first two stages), with no kernel and no
profiler range; the normals, the cloud's quality and the mesh follow in
`surface.py`. It imports nothing of the program. `precision=
"bfloat16"` rounds the rectified images, the cost volumes and the
aggregated volumes to bfloat16, and `surface.py` works from the cloud and
the depth rounded to bfloat16: that is the control, one precision below
the configuration's float32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from recbench.reference import surface

FUSED_MAX = 6   # neighbour views fused in one block up to here
CHUNK = 4       # block size beyond it

# ---- from ops/image.py

def central_gradients(img: torch.Tensor):
    """Central-difference dx, dy of `(..., H, W)`, wrapping at the
    borders (`jnp.roll`), as the reference computes them."""
    dx = 0.5 * (torch.roll(img, -1, dims=-1) - torch.roll(img, 1, dims=-1))
    dy = 0.5 * (torch.roll(img, -1, dims=-2) - torch.roll(img, 1, dims=-2))
    return dx, dy


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample `(..., H, W)` at `(..., N, 2)` float (x, y) coordinates,
    bilinear, clamped to the image (cv2.remap BORDER_REPLICATE)."""
    h, w = img.shape[-2:]
    x = torch.clamp(xy[..., 0], 0.0, w - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = x - x0
    fy = y - y0
    # one flat gather for all four taps
    idx = torch.cat([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1], -1)
    taps = torch.gather(img.reshape(*img.shape[:-2], h * w), -1, idx)
    v00, v01, v10, v11 = taps.chunk(4, -1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """Copy a small host tensor to `device` without waiting for the card:
    a copy from pageable memory would first drain the stream, so a CUDA
    copy goes through pinned memory, asynchronously."""
    device = torch.device(device)
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def homography_grid(H: torch.Tensor, out_shape, device=None):
    """Per-output-pixel source coordinates of the FORWARD map H.

    H is (..., 3, 3); returns (sx, sy), each (..., h, w) float32 on
    `device` (default: H's), with [sx, sy, 1] ~ H @ [x, y, 1] for every
    output pixel (x, y). Sampling an image at this grid computes
    out(p) = img(H p); pass H^-1 for the usual inverse warp. H may be
    made on the host: it is copied to `device` (values unchanged)."""
    h, w = out_shape
    dev = H.device if device is None else torch.device(device)
    H = to_device(H.to(torch.float32), dev)[..., None, None]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    # projective division with a sign-preserving |w| guard
    den = H[..., 2, 0, :, :] * xs + H[..., 2, 1, :, :] * ys + H[..., 2, 2, :, :]
    den = torch.sign(den) * torch.clamp(torch.abs(den), min=1e-12)
    sx = (H[..., 0, 0, :, :] * xs + H[..., 0, 1, :, :] * ys
          + H[..., 0, 2, :, :]) / den
    sy = (H[..., 1, 0, :, :] * xs + H[..., 1, 1, :, :] * ys
          + H[..., 1, 2, :, :]) / den
    return sx, sy


def sample_grid(img: torch.Tensor, sx: torch.Tensor,
                sy: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample `(..., H, W)` at `(..., h, w)` coordinate grids,
    clamped (the 2-D form of `bilinear_sample`)."""
    xy = torch.stack([sx.reshape(*sx.shape[:-2], -1),
                      sy.reshape(*sy.shape[:-2], -1)], -1)
    return bilinear_sample(img, xy).reshape(sx.shape)


def grid_in_bounds(shape, sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """Mask of grid positions whose bilinear footprint lies inside an
    (H, W) source image (no border replication involved)."""
    h, w = shape
    return (sx >= 0.0) & (sx <= w - 1.0) & (sy >= 0.0) & (sy <= h - 1.0)


# ---- from ops/pallas_sgm.py

def _dp_step(prev: torch.Tensor, c: torch.Tensor, p1: float,
             p2: float) -> torch.Tensor:
    """One SGM DP step on (..., D): out = c + best(prev) - min(prev)."""
    m = prev.amin(-1, keepdim=True)
    up = torch.cat([prev[..., :1], prev[..., :-1]], -1)
    dn = torch.cat([prev[..., 1:], prev[..., -1:]], -1)
    best = torch.minimum(torch.minimum(prev, up + p1),
                         torch.minimum(dn + p1, m + p2))
    return c + best - m


def _bidir_plain(v: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """Forward + backward DP over axis 0 of (X, ..., D)."""
    both = torch.stack([v, v.flip(0)], 1)            # (X, 2, ..., D)
    agg = torch.empty_like(both)
    prev = agg[0] = both[0]
    for x in range(1, both.shape[0]):
        prev = agg[x] = _dp_step(prev, both[x], p1, p2)
    return agg[:, 0] + agg[:, 1].flip(0)


def _penalties(p1x100: int, p2x100: int):
    # float32 rounding of the double quotient, as the kernel computes it
    return (float(torch.tensor(p1x100 / 100.0, dtype=torch.float32)),
            float(torch.tensor(p2x100 / 100.0, dtype=torch.float32)))


def sgm_aggregate_batch_plain(volumes: torch.Tensor, p1x100: int = 15,
                              p2x100: int = 90) -> torch.Tensor:
    """Plain PyTorch version: the reference's XLA scan, one step at a time."""
    p1, p2 = _penalties(p1x100, p2x100)
    agg_h = _bidir_plain(volumes.permute(3, 0, 2, 1), p1, p2)  # (W, B, H, D)
    agg_v = _bidir_plain(volumes.permute(2, 0, 3, 1), p1, p2)  # (H, B, W, D)
    return agg_h.permute(1, 3, 2, 0) + agg_v.permute(1, 3, 0, 2)


# ---- from ops/stereo.py

_SGM_MEGABATCH = 8


def _host(x) -> torch.Tensor:
    """Camera data as a float32 CPU tensor."""
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(v * v)) over the last axis, as `jnp.linalg.norm`."""
    return torch.sqrt(torch.sum(v * v, -1))


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
    valid: torch.Tensor


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


# ---- from ops/pointcloud.py

_INF = 3.4e38


def depth_map_to_point_cloud(depth: torch.Tensor, K, R=None, t=None,
                             image: Optional[torch.Tensor] = None,
                             valid: Optional[torch.Tensor] = None,
                             stride: int = 1):
    """Backproject an (H, W) depth map to world points (+ colors).

    Returns (points (N, 3), colors (N, 3) or None, mask (N,)) with
    N = ceil(H/stride) * ceil(W/stride). R, t: world -> cam pose; identity
    if None. K, R, t may be host tensors; the points are on depth's device."""
    dev = depth.device
    d = depth[::stride, ::stride]
    h, w = d.shape
    v = valid[::stride, ::stride] if valid is not None else d > 1e-6
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev) * stride,
        torch.arange(w, dtype=torch.float32, device=dev) * stride,
        indexing="ij")
    K = torch.as_tensor(K, dtype=torch.float32).to(dev)
    z = d.reshape(-1)
    x = (xs.reshape(-1) - K[0, 2]) / K[0, 0] * z
    y = (ys.reshape(-1) - K[1, 2]) / K[1, 1] * z
    Xc = torch.stack([x, y, z], 1)
    if R is not None:
        R = torch.as_tensor(R, dtype=torch.float32).to(dev)
        t = torch.as_tensor(t, dtype=torch.float32).to(dev)
        Xw = (Xc - t[None, :]) @ R   # inverse of x_c = R x_w + t
    else:
        Xw = Xc
    colors = None
    if image is not None:
        im = image[::stride, ::stride]
        if im.ndim == 2:
            c = im.reshape(-1)
            colors = torch.stack([c, c, c], 1)
        else:
            colors = im.reshape(-1, im.shape[-1])
    return Xw, colors, v.reshape(-1)


def _chunked_knn(points: torch.Tensor, mask: torch.Tensor, k: int,
                 self_d2: float, chunk: int = 2048):
    """The k smallest squared distances of every point to the valid points
    (masked columns = INF, a point's distance to itself = `self_d2`), in
    row chunks of the expanded |a|^2 + |b|^2 - 2ab form. Returns
    (values (N, k) smallest first, indices (N, k))."""
    n = points.shape[0]
    sq = torch.sum(points * points, 1)
    vals, idx = [], []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d2 = sq[s:e, None] + sq[None, :] - 2.0 * points[s:e] @ points.T
        d2 = torch.where(mask[None, :], d2, _INF)
        r = torch.arange(e - s, device=points.device)
        d2[r, r + s] = self_d2
        top = torch.topk(d2, k, dim=1, largest=False)
        vals.append(top.values)
        idx.append(top.indices)
    return torch.cat(vals), torch.cat(idx)


def _chunked_knn_dists(points: torch.Tensor, mask: torch.Tensor, k: int,
                       chunk: int = 2048) -> torch.Tensor:
    """(N, k) distances to the k nearest valid neighbours (self excluded),
    smallest first."""
    d2, _ = _chunked_knn(points, mask, k, _INF, chunk)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def statistical_outlier_mask(points: torch.Tensor, mask: torch.Tensor,
                             k: int = 20, std_ratio: float = 2.0
                             ) -> torch.Tensor:
    """Open3D remove_statistical_outlier equivalent: keep points whose mean
    kNN distance is within mean + std_ratio * std of the population."""
    d = _chunked_knn_dists(points, mask, k)
    mean_d = torch.mean(d, 1)
    w = mask.to(points.dtype)
    cnt = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(mean_d * w) / cnt
    var = torch.sum((mean_d - mu) ** 2 * w) / cnt
    thr = mu + std_ratio * torch.sqrt(var)
    return mask & (mean_d <= thr)


# ---- the dense stage's first two stages

def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return x
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def stereo_block(img_ref, imgs, K_ref, K2s, Rs, ts, num_disparities,
                 precision, lr_max_diff=1.5):
    """(depths (N, H, W), valids, baselines (N,)) of a block of pairs, each
    in the ORIGINAL reference view."""
    N = imgs.shape[0]
    K_ref, K2s, Rs, ts = (_host(a) for a in (K_ref, K2s, Rs, ts))
    r1, r2, K_new, baseline, (H1, _), R_new = rectify_pair(
        img_ref, imgs, K_ref[None].expand(N, 3, 3), K2s, Rs, ts)
    r1, r2 = _round(r1, precision), _round(r2, precision)
    vol = _round(cost_volume(r1, r2, num_disparities), precision)
    vols = torch.stack([vol, _right_view_volume(vol)], 1).flatten(0, 1)
    del vol
    agg = torch.cat([_round(sgm_aggregate_batch_plain(
        vols[s:s + _SGM_MEGABATCH]), precision)
        for s in range(0, 2 * N, _SGM_MEGABATCH)])
    del vols
    res = _wta_lr_depth(agg[0::2], agg[1::2], K_new[:, 0, 0] * baseline,
                        lr_max_diff)
    del agg
    depths, valids = unrectify_depth(res.depth, res.valid, H1,
                                     K_ref[None].expand(N, 3, 3), R_new,
                                     img_ref.shape[-2:])
    return depths, valids, baseline


def dense_depth_and_cloud(sparse: Dict, images: Dict[str, np.ndarray],
                          device, num_disparities: int = 64,
                          max_cloud_points: int = 200_000,
                          outlier_k: int = 20, outlier_std: float = 2.0,
                          tsdf_resolution: Optional[int] = None,
                          precision: str = "float32") -> Dict:
    """The fused depth (H, W), its valid mask, the number of neighbour
    views and the filtered cloud (P, 3), as numpy, for the dense stage's
    inputs (the sparse dict's `camera_poses`, gray float32 images); the
    reference view is the middle one, as the stage picks it. With
    `tsdf_resolution`, also the cloud's `normals`, `quality` and the mesh
    (`verts`, `faces`, the TSDF's `voxel`) of `surface.py`."""
    cams = sparse["camera_poses"]
    names = [n for n in cams if n in images]
    ref = names[len(names) // 2]
    others = [n for n in names if n != ref]

    def cam_of(n):
        c = cams[n]
        return (np.asarray(c["camera_matrix"], np.float64),
                np.asarray(c["rotation"], np.float64),
                np.asarray(c["translation"], np.float64).reshape(3))

    K_ref, R_ref, t_ref = cam_of(ref)
    K2l, Rl, tl = [], [], []
    for n in others:
        K2, R2, t2 = cam_of(n)
        R_rel = R2 @ R_ref.T
        K2l.append(K2.astype(np.float32))
        Rl.append(R_rel.astype(np.float32))
        tl.append((t2 - R_rel @ t_ref).astype(np.float32))
    K_ref32 = torch.from_numpy(K_ref.astype(np.float32))
    K2l, Rl, tl = (torch.from_numpy(np.stack(a)) for a in (K2l, Rl, tl))
    img_ref = torch.from_numpy(np.asarray(images[ref], np.float32)).to(device)
    im_dev = torch.from_numpy(np.stack(
        [np.asarray(images[n], np.float32) for n in others])).to(device)
    step = len(others) if len(others) <= FUSED_MAX else CHUNK
    d_blocks, v_blocks, b_blocks = [], [], []
    for s in range(0, len(others), step):
        d, v, b = stereo_block(img_ref, im_dev[s:s + step], K_ref32,
                               K2l[s:s + step], Rl[s:s + step],
                               tl[s:s + step], num_disparities, precision)
        d_blocks.append(d)
        v_blocks.append(v)
        b_blocks.append(b)
    fused, fused_valid = fuse_depth_maps(torch.cat(d_blocks),
                                         torch.cat(v_blocks),
                                         torch.cat(b_blocks))
    stride = max(1, int(np.ceil(np.sqrt(
        fused.shape[0] * fused.shape[1] / max_cloud_points))))
    pts, _, mask = depth_map_to_point_cloud(
        fused, K_ref.astype(np.float32), R_ref.astype(np.float32),
        t_ref.astype(np.float32), valid=fused_valid, stride=stride)
    mask = statistical_outlier_mask(pts, mask, k=outlier_k,
                                    std_ratio=outlier_std)
    out = {"depth": fused.cpu().numpy(), "valid": fused_valid.cpu().numpy(),
           "views": len(others), "points": pts[mask].cpu().numpy()}
    if tsdf_resolution is not None:
        out.update(surface.surface(
            pts[mask], fused, fused_valid, K_ref.astype(np.float32),
            R_ref.astype(np.float32), t_ref.astype(np.float32),
            tsdf_resolution, device, precision))
    return out
