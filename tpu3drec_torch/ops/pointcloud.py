"""Point-cloud processing on the dense pipeline's path: backprojection,
outlier filters, normals, voxel downsampling, quality analytics, PLY
export.

Port of the pipeline's subset of `tpu3drec/ops/pointcloud.py`. kNN
queries are chunked masked distance matrices on the device, in the
reference's expanded |a|^2 + |b|^2 - 2ab form; the voxel-hash kNN,
downsampling, clustering and analytics are host numpy (data-dependent
sizes), copied from the reference. Not ported yet: farthest-point
downsampling, ICP and cloud merging (multi-reference mode).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

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


def radius_outlier_mask(points: torch.Tensor, mask: torch.Tensor,
                        radius: float, min_neighbors: int = 5,
                        k: int = 32) -> torch.Tensor:
    """Open3D remove_radius_outlier equivalent (k caps the neighbour count
    actually inspected)."""
    d = _chunked_knn_dists(points, mask, k)
    return mask & (torch.sum(d <= radius, 1) >= min_neighbors)


def voxel_downsample(points: np.ndarray, voxel_size: float,
                     colors: Optional[np.ndarray] = None,
                     mask: Optional[np.ndarray] = None):
    """Voxel-hash average downsample (host-side; data-dependent sizes)."""
    pts = np.asarray(points)
    if mask is not None:
        pts = pts[np.asarray(mask)]
        if colors is not None:
            colors = np.asarray(colors)[np.asarray(mask)]
    if len(pts) == 0:
        return pts, colors
    keys = np.floor(pts / voxel_size).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    inv = inv.reshape(-1)
    acc = np.zeros((len(counts), 3))
    np.add.at(acc, inv, pts)
    out = acc / counts[:, None]
    out_c = None
    if colors is not None:
        accc = np.zeros((len(counts), colors.shape[1]))
        np.add.at(accc, inv, colors)
        out_c = accc / counts[:, None]
    return out.astype(np.float32), out_c


def _orient(normals: torch.Tensor, points: torch.Tensor,
            viewpoint) -> torch.Tensor:
    """Flip each normal to face `viewpoint` (origin if None)."""
    vp = (torch.zeros(3, device=points.device) if viewpoint is None
          else torch.as_tensor(viewpoint, dtype=torch.float32).to(points.device))
    sign = torch.sign(torch.sum(normals * (vp[None, :] - points), 1))
    sign = torch.where(sign == 0, 1.0, sign)
    return normals * sign[:, None]


def estimate_normals(points: torch.Tensor, mask: torch.Tensor, k: int = 16,
                     viewpoint=None) -> torch.Tensor:
    """PCA normals from kNN neighbourhoods (self included), oriented toward
    `viewpoint` (Open3D estimate_normals + orient_normals equivalent).
    O(N^2) distances, computed in row chunks; the pipeline takes this path
    up to 16,384 points."""
    _, idx = _chunked_knn(points, mask, k, 0.0)
    nbr = points[idx]                               # (N, k, 3)
    c = nbr - torch.mean(nbr, 1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", c, c) / k
    normals = torch.linalg.eigh(cov).eigenvectors[:, :, 0]
    return _orient(normals, points, viewpoint)


def _smallest_eigvec_sym3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of each (N, 3, 3)
    SYMMETRIC matrix, closed form: eigenvalues by the trigonometric
    (Smith) method, the eigenvector as the largest cross product of rows
    of (A - lam_min I)."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    I = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * I
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    detB = (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                            - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                              - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                              - B[..., 1, 1] * B[..., 2, 0]))
    r = torch.clamp(detB / (2.0 * (p * p * p)), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    M = A - lam_min[..., None, None] * I
    cands = torch.stack([torch.linalg.cross(M[..., 0, :], M[..., 1, :]),
                         torch.linalg.cross(M[..., 0, :], M[..., 2, :]),
                         torch.linalg.cross(M[..., 1, :], M[..., 2, :])], -2)
    best = torch.argmax(torch.sum(cands * cands, -1), -1)
    v = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 3))[..., 0, :]
    nv = torch.sqrt(torch.sum(v * v, -1, keepdim=True))
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype,
                            device=A.device).expand_as(v)
    degenerate = (nv[..., 0] < 1e-20) | (p2 < 1e-24)
    return torch.where(degenerate[..., None], fallback,
                       v / torch.clamp(nv, min=1e-30))


def normals_from_indices(points: torch.Tensor, idx: torch.Tensor,
                         nbr_mask: torch.Tensor, viewpoint=None
                         ) -> torch.Tensor:
    """PCA normals from precomputed kNN index sets (the at-scale path,
    paired with `voxel_knn_indices`): points (N, 3), idx (N, k), nbr_mask
    (N, k). Masked covariance per point, closed-form smallest
    eigenvector, oriented toward `viewpoint`."""
    nbr = points[idx.to(torch.int64)]                     # (N, k, 3)
    w = nbr_mask.to(points.dtype)[..., None]
    cnt = torch.clamp(torch.sum(w, 1), min=1.0)
    mu = torch.sum(nbr * w, 1, keepdim=True) / cnt[:, None]
    c = (nbr - mu) * w
    cov = torch.einsum("nki,nkj->nij", c, c) / cnt[:, None]
    return _orient(_smallest_eigvec_sym3(cov), points, viewpoint)


def estimate_normals_scaled(points: torch.Tensor, mask: torch.Tensor,
                            k: int = 16, viewpoint=None) -> torch.Tensor:
    """`estimate_normals` for clouds past the O(N^2) ceiling: host
    voxel-hash kNN + masked-PCA normals on points' device."""
    idx, nm = voxel_knn_indices(points.cpu().numpy(), k, mask.cpu().numpy())
    return normals_from_indices(points, torch.from_numpy(idx).to(points.device),
                                torch.from_numpy(nm).to(points.device),
                                viewpoint)


def voxel_knn_indices(points: np.ndarray, k: int,
                      mask: Optional[np.ndarray] = None,
                      max_grow: int = 6):
    """Near-exact kNN indices at scale, host-side: each point's k nearest
    neighbours among the points of its 3x3x3 voxel neighbourhood, self
    included, with the voxel grown until a probe sample sees enough
    candidates (Open3D KDTreeSearchParamHybrid's trade).

    Returns (idx (N, k) int32 into `points`, nbr_mask (N, k) bool)."""
    pts_all = np.asarray(points, np.float64)
    n_all = len(pts_all)
    m = (np.ones(n_all, bool) if mask is None
         else np.asarray(mask, bool).copy())
    idx_out = np.tile(np.arange(n_all, dtype=np.int32)[:, None], (1, k))
    mask_out = np.zeros((n_all, k), bool)
    orig = np.nonzero(m)[0].astype(np.int32)
    pts = pts_all[orig]
    n = len(pts)
    if n == 0:
        return idx_out, mask_out
    if n <= k:
        idx_out[orig[:, None], np.arange(min(n, k))[None, :]] = \
            orig[None, :min(n, k)]
        mask_out[orig, :min(n, k)] = True
        return idx_out, mask_out

    lo, hi = pts.min(0), pts.max(0)
    extent = np.maximum(hi - lo, 1e-12)
    # initial guess: ~4 points per voxel under a uniform-volume model
    voxel = float(np.cbrt(extent.prod() / n * 4.0)) or 1.0
    per_off_cap = max(6, int(np.ceil(0.75 * (k + 2))))
    offs = np.array([(dx + (dy << 21) + (dz << 42))
                     for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                     for dz in (-1, 0, 1)], np.int64)
    probe = pts[:: max(1, n // 1024)]
    for _ in range(max_grow):
        keys3 = np.floor((pts - lo) / voxel).astype(np.int64)
        keys = (keys3[:, 0] + (keys3[:, 1] << 21) + (keys3[:, 2] << 42))
        order = np.argsort(keys, kind="stable").astype(np.int32)
        skeys = keys[order]
        ukeys, ustart, ucount = np.unique(skeys, return_index=True,
                                          return_counts=True)
        # grow the voxel until a probe sample SEES > k candidates in its
        # 3x3x3 neighbourhood (flat clouds populate a 2-D slice only)
        pk3 = np.floor((probe - lo) / voxel).astype(np.int64)
        pkeys = (pk3[:, 0] + (pk3[:, 1] << 21) + (pk3[:, 2] << 42))
        cand_n = np.zeros(len(probe))
        for off in offs:
            q = np.searchsorted(ukeys, pkeys + off)
            qc = np.minimum(q, len(ukeys) - 1)
            cand_n += np.where(ukeys[qc] == pkeys + off, ucount[qc], 0)
        enough = (cand_n.mean() >= (k + 1) * 3.0
                  and np.percentile(cand_n, 10) >= (k + 1) * 1.5)
        if enough or voxel > extent.max():
            break
        voxel *= 1.6
    cap = 27 * per_off_cap
    cand = np.zeros((n, cap), np.int32)
    cand_ok = np.zeros((n, cap), bool)
    take = np.arange(per_off_cap)
    for o, off in enumerate(offs):
        q = np.searchsorted(ukeys, keys + off)
        q_ok = (q < len(ukeys)) & (ukeys[np.minimum(q, len(ukeys) - 1)]
                                   == keys + off)
        start = ustart[np.minimum(q, len(ukeys) - 1)]
        count = np.where(q_ok, ucount[np.minimum(q, len(ukeys) - 1)], 0)
        pos = start[:, None] + take[None, :]
        ok = take[None, :] < np.minimum(count, per_off_cap)[:, None]
        sl = slice(o * per_off_cap, (o + 1) * per_off_cap)
        cand[:, sl] = order[np.minimum(pos, n - 1)]
        cand_ok[:, sl] = ok
    d2 = np.sum((pts[cand] - pts[:, None, :]) ** 2, axis=2)
    d2[~cand_ok] = np.inf
    kk = min(k, cap)
    sel = np.argpartition(d2, kk - 1, axis=1)[:, :kk]
    rows = np.arange(n)[:, None]
    sel_ok = np.isfinite(d2[rows, sel])
    # order by distance within the k set (stable small sort)
    sub = np.argsort(d2[rows, sel], axis=1, kind="stable")
    sel = sel[rows, sub]
    sel_ok = sel_ok[rows, sub]
    idx_local = cand[rows, sel]
    idx_out[orig[:, None], np.arange(kk)[None, :]] = orig[idx_local]
    mask_out[orig[:, None], np.arange(kk)[None, :]] = sel_ok
    # invalid slots point at self so downstream gathers stay in range
    self_idx = np.broadcast_to(
        np.arange(n_all, dtype=np.int32)[:, None], (n_all, k))
    idx_out = np.where(mask_out, idx_out, self_idx)
    return idx_out, mask_out


def nearest_neighbor_stats(points: np.ndarray, sample: int = 1000) -> Dict:
    """Nearest-neighbour density statistics on a subsample, via the
    voxel-hash kNN."""
    pts = np.asarray(points, np.float64)
    if len(pts) < 2:
        return {}
    if len(pts) > sample:
        sel = np.random.default_rng(0).choice(len(pts), sample,
                                              replace=False)
        pts = pts[sel]
    idx, nm = voxel_knn_indices(pts, 2)     # self + nearest
    nn = np.where(nm[:, 1], idx[:, 1], idx[:, 0])
    d = np.linalg.norm(pts - pts[nn], axis=1)
    d = d[nm[:, 1]]
    if len(d) == 0:
        return {}
    return {
        "mean_nearest_distance": float(np.mean(d)),
        "median_nearest_distance": float(np.median(d)),
        "std_nearest_distance": float(np.std(d)),
    }


def cluster_point_cloud(points: np.ndarray, eps: Optional[float] = None,
                        min_samples: int = 5):
    """Voxel-hash connected-component clustering (the DBSCAN stand-in):
    occupied eps-voxels within a 3x3x3 neighbourhood are connected (scipy
    csgraph); components smaller than `min_samples` points are outliers
    (label -1). Returns (labels (N,), num_clusters, num_outliers)."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
    if n == 0:
        return np.zeros(0, np.int64), 0, 0
    if eps is None:
        nnstats = nearest_neighbor_stats(pts)
        eps = 3.0 * nnstats.get("median_nearest_distance", 0.1) or 0.1
    lo = pts.min(0)
    k3 = np.floor((pts - lo) / eps).astype(np.int64)
    keys = k3[:, 0] + (k3[:, 1] << 21) + (k3[:, 2] << 42)
    ukeys, inv = np.unique(keys, return_inverse=True)
    inv = inv.reshape(-1)
    nv = len(ukeys)
    offs = np.array([(dx + (dy << 21) + (dz << 42))
                     for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                     for dz in (-1, 0, 1) if (dx, dy, dz) != (0, 0, 0)],
                    np.int64)
    rows, cols = [], []
    for off in offs:
        q = np.searchsorted(ukeys, ukeys + off)
        qc = np.minimum(q, nv - 1)
        hit = ukeys[qc] == ukeys + off
        rows.append(np.nonzero(hit)[0])
        cols.append(qc[hit])
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    r = np.concatenate(rows + [np.arange(nv)])
    c = np.concatenate(cols + [np.arange(nv)])
    g = coo_matrix((np.ones(len(r), np.int8), (r, c)), shape=(nv, nv))
    _, vlabel = connected_components(g, directed=False)
    labels = vlabel[inv]
    sizes = np.bincount(labels)
    small = sizes[labels] < min_samples
    out = labels.astype(np.int64)
    out[small] = -1
    # compact the surviving labels
    keep = np.unique(out[out >= 0])
    remap = np.full(len(sizes), -1, np.int64)
    remap[keep] = np.arange(len(keep))
    out[out >= 0] = remap[out[out >= 0]]
    return out, len(keep), int(small.sum())


def point_cloud_quality(points: np.ndarray,
                        mask: Optional[np.ndarray] = None,
                        colors: Optional[np.ndarray] = None,
                        cluster: bool = True) -> Dict:
    """Analytics with the reference's field families: bounds, kNN density
    statistics, cluster/outlier counts and color statistics."""
    pts = np.asarray(points)
    if mask is not None:
        pts = pts[np.asarray(mask)]
        if colors is not None:
            colors = np.asarray(colors)[np.asarray(mask)]
    if len(pts) == 0:
        return {"num_points": 0}
    extent = pts.max(0) - pts.min(0)
    centroid = pts.mean(0)
    metrics = {
        "num_points": int(len(pts)),
        "extent": extent.tolist(),
        "centroid": centroid.tolist(),
        "rms_radius": float(np.sqrt(((pts - centroid) ** 2).sum(1).mean())),
        "bounds": {"min": pts.min(0).tolist(), "max": pts.max(0).tolist(),
                   "range": extent.tolist()},
    }
    if len(pts) > 100:
        d = nearest_neighbor_stats(pts)
        if d:
            metrics["density"] = d
    if cluster and len(pts) > 50:
        _, n_clusters, n_out = cluster_point_cloud(pts)
        metrics["clustering"] = {
            "num_clusters": int(n_clusters),
            "num_outliers": int(n_out),
            "outlier_ratio": float(n_out / len(pts)),
        }
    if colors is not None and len(colors) == len(pts):
        c = np.asarray(colors, np.float64)
        metrics["color"] = {
            "mean_rgb": c.mean(0).tolist(),
            "std_rgb": c.std(0).tolist(),
            "brightness_range": [float(c.min()), float(c.max())],
        }
    return metrics


def save_ply(path, points: np.ndarray, colors: Optional[np.ndarray] = None,
             normals: Optional[np.ndarray] = None) -> None:
    """ASCII PLY export."""
    pts = np.asarray(points)
    n = len(pts)
    header = ["ply", "format ascii 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if normals is not None:
        header += ["property float nx", "property float ny",
                   "property float nz"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += ["end_header"]
    if colors is not None:
        colors = np.asarray(colors)
        rgb = np.clip(colors * 255 if colors.max() <= 1.0 else colors,
                      0, 255).astype(int)
    with open(path, "w") as f:
        f.write("\n".join(header) + "\n")
        for i in range(n):
            row = [f"{pts[i, 0]:.6f}", f"{pts[i, 1]:.6f}", f"{pts[i, 2]:.6f}"]
            if normals is not None:
                row += [f"{normals[i, j]:.4f}" for j in range(3)]
            if colors is not None:
                row += [str(c) for c in rgb[i, :3]]
            f.write(" ".join(row) + "\n")
