"""Plain reference of the dense stage after its cloud: per-point normals,
the cloud's quality statistics and the TSDF mesh with its repair and
smoothing, worked out from the reference's own fused depth and filtered
cloud (`dense.py`).

Normals are the plain form: each point's exact 16 nearest neighbours
(itself included) among the filtered cloud, the smallest eigenvector of
their covariance in float64, turned to face the reference camera. The
program takes a voxel-hash approximation of the neighbours past 16,384
points. The quality statistics keep `ops/pointcloud.py:
point_cloud_quality`'s fields and sampling rule with exact nearest
neighbours; the clustering, the TSDF fusion, marching tetrahedra and
the mesh's repair and smoothing are frozen copies of `ops/pointcloud.py`,
`ops/tsdf.py` and `ops/mesh.py` as they stood when the benchmark was
written. The texture's colours are not worked out. It imports nothing
of the program.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

NORMAL_K = 16          # the dense stage's neighbours per normal
SMOOTH_ITERATIONS = 2  # its Laplacian passes over the mesh


# ---- normals

def knn_indices(points: torch.Tensor, k: int, chunk: int = 2048
                ) -> torch.Tensor:
    """(N, k) indices of each point's k nearest points, itself first,
    from distances taken as differences of centred coordinates."""
    n = points.shape[0]
    k = min(k, n)
    c = points - points.mean(0, keepdim=True)
    out = []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d = torch.cdist(c[s:e], c,
                        compute_mode="donot_use_mm_for_euclid_dist")
        r = torch.arange(e - s, device=points.device)
        d[r, r + s] = -1.0
        out.append(torch.topk(d, k, dim=1, largest=False).indices)
    return torch.cat(out) if out else torch.zeros((0, k), dtype=torch.long)


def normals(points: torch.Tensor, viewpoint: np.ndarray,
            k: int = NORMAL_K) -> torch.Tensor:
    """(N, 3) unit normals of a cloud (N, 3), each facing `viewpoint`."""
    if points.shape[0] == 0:
        return points.new_zeros((0, 3))
    idx = knn_indices(points, k)
    p = points.to(torch.float64)
    nbr = p[idx]
    c = nbr - nbr.mean(1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", c, c) / idx.shape[1]
    # on the host: the card's batched eigensolver refuses batches this large
    nrm = torch.from_numpy(np.linalg.eigh(cov.cpu().numpy())[1][:, :, 0]).to(
        p.device)
    vp = torch.as_tensor(viewpoint, dtype=torch.float64, device=p.device)
    sign = torch.sign(torch.sum(nrm * (vp[None] - p), 1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return (nrm * sign[:, None]).to(torch.float32)


# ---- the cloud's quality statistics

def nearest_stats(points: np.ndarray, sample: int = 1000) -> Dict:
    """Nearest-neighbour distances within a sample of the cloud (the
    program's rule: 1,000 points drawn by `default_rng(0)`), exact."""
    pts = np.asarray(points, np.float64)
    if len(pts) < 2:
        return {}
    if len(pts) > sample:
        sel = np.random.default_rng(0).choice(len(pts), sample,
                                              replace=False)
        pts = pts[sel]
    d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, -1)
    np.fill_diagonal(d2, np.inf)
    d = np.sqrt(d2.min(1))
    return {"mean_nearest_distance": float(np.mean(d)),
            "median_nearest_distance": float(np.median(d)),
            "std_nearest_distance": float(np.std(d))}


def cluster_counts(points: np.ndarray, min_samples: int = 5
                   ) -> Tuple[int, int]:
    """(clusters, outliers) of `ops/pointcloud.py:cluster_point_cloud`:
    occupied eps-voxels joined within their 3x3x3 neighbourhood, eps
    three times the median nearest distance; components under
    `min_samples` points are outliers."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    pts = np.asarray(points, np.float64)
    if len(pts) == 0:
        return 0, 0
    eps = 3.0 * nearest_stats(pts).get("median_nearest_distance", 0.1) \
        or 0.1
    k3 = np.floor((pts - pts.min(0)) / eps).astype(np.int64)
    keys = k3[:, 0] + (k3[:, 1] << 21) + (k3[:, 2] << 42)
    ukeys, inv = np.unique(keys, return_inverse=True)
    inv = inv.reshape(-1)
    nv = len(ukeys)
    rows, cols = [np.arange(nv)], [np.arange(nv)]
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if (dx, dy, dz) == (0, 0, 0):
                    continue
                off = dx + (dy << 21) + (dz << 42)
                q = np.minimum(np.searchsorted(ukeys, ukeys + off), nv - 1)
                hit = ukeys[q] == ukeys + off
                rows.append(np.nonzero(hit)[0])
                cols.append(q[hit])
    r, c = np.concatenate(rows), np.concatenate(cols)
    g = coo_matrix((np.ones(len(r), np.int8), (r, c)), shape=(nv, nv))
    _, label = connected_components(g, directed=False)
    sizes = np.bincount(label[inv])
    small = sizes[label[inv]] < min_samples
    return int(np.sum(sizes >= min_samples)), int(small.sum())


def cloud_quality(points: np.ndarray) -> Dict:
    """The program's quality fields that the cloud decides: its size,
    RMS radius, nearest-neighbour statistics and clusters."""
    pts = np.asarray(points, np.float64)
    if len(pts) == 0:
        return {"num_points": 0}
    centroid = pts.mean(0)
    out = {"num_points": int(len(pts)),
           "rms_radius": float(np.sqrt(((pts - centroid) ** 2)
                                       .sum(1).mean()))}
    if len(pts) > 100:
        out["density"] = nearest_stats(pts)
    if len(pts) > 50:
        n_clusters, n_out = cluster_counts(pts)
        out["clustering"] = {"num_clusters": n_clusters,
                             "num_outliers": n_out}
    return out


# ---- TSDF fusion and marching tetrahedra (from ops/tsdf.py)

def tsdf_fuse(depths: torch.Tensor, valids: torch.Tensor, Ks, Rs, ts,
              origin, voxel: float, dims: Tuple[int, int, int],
              trunc: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integrate V depth maps (V, H, W) into a TSDF grid on their device:
    (tsdf (X, Y, Z) in [-1, 1], weight (X, Y, Z))."""
    dev = depths.device
    f32 = dict(dtype=torch.float32, device=dev)
    X, Y, Z = dims
    V, H, W = depths.shape
    Ks, Rs, ts, origin = (torch.as_tensor(a, dtype=torch.float32).to(dev)
                          for a in (Ks, Rs, ts, origin))
    voxel = torch.tensor(voxel, **f32)
    trunc = torch.tensor(trunc, **f32)
    g = torch.meshgrid(torch.arange(X, **f32), torch.arange(Y, **f32),
                       torch.arange(Z, **f32), indexing="ij")
    pts = torch.stack(g, -1).reshape(-1, 3) * voxel + origin[None]
    tsdf_sum = torch.zeros(pts.shape[0], **f32)
    w_sum = torch.zeros(pts.shape[0], **f32)
    for i in range(V):
        K = Ks[i]
        Xc = pts @ Rs[i].T + ts[i][None]
        z = Xc[:, 2]
        zsafe = torch.clamp(z, min=1e-6)
        u = Xc[:, 0] / zsafe * K[0, 0] + K[0, 2]
        v = Xc[:, 1] / zsafe * K[1, 1] + K[1, 2]
        ui = torch.clamp(torch.round(u).to(torch.int64), 0, W - 1)
        vi = torch.clamp(torch.round(v).to(torch.int64), 0, H - 1)
        lin = vi * W + ui
        d = depths[i].reshape(-1)[lin]
        dv = valids[i].reshape(-1)[lin]
        in_img = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) & (z > 1e-4)
        sdf = d - z
        w = (in_img & dv & (sdf > -trunc)).to(torch.float32)
        tsdf_sum = tsdf_sum + w * torch.clamp(sdf / trunc, -1.0, 1.0)
        w_sum = w_sum + w
    tsdf = torch.where(w_sum > 0, tsdf_sum / torch.clamp(w_sum, min=1e-6), 1.0)
    return tsdf.reshape(dims), w_sum.reshape(dims)


# Kuhn's 6 tetrahedra of the unit cube (corner c at (c>>2&1, c>>1&1, c&1))
_TETS = np.array([[0, 4, 6, 7], [0, 4, 5, 7], [0, 2, 6, 7], [0, 2, 3, 7],
                  [0, 1, 5, 7], [0, 1, 3, 7]], np.int64)
_CORNER_OFF = np.array([[c >> 2 & 1, c >> 1 & 1, c & 1] for c in range(8)],
                       np.int64)


def _tet_case_tables():
    """For each of the 16 sign cases of a tetrahedron (bit i: corner i
    inside), its triangles as triples of cut (inside, outside) edges."""
    tables = []
    for case in range(16):
        inside = [i for i in range(4) if case >> i & 1]
        outside = [i for i in range(4) if not (case >> i & 1)]
        tris = []
        if len(inside) == 1:
            e = [(inside[0], o) for o in outside]
            tris.append((e[0], e[1], e[2]))
        elif len(inside) == 3:
            e = [(i, outside[0]) for i in inside]
            tris.append((e[0], e[1], e[2]))
        elif len(inside) == 2:
            a, b = inside
            c, d = outside
            tris.append(((a, c), (a, d), (b, d)))
            tris.append(((a, c), (b, d), (b, c)))
        tables.append(tris)
    return tables


_TET_TRIS = _tet_case_tables()


def marching_tetrahedra(tsdf: np.ndarray, weight: np.ndarray,
                        origin: np.ndarray, voxel: float, iso: float = 0.0,
                        min_weight: float = 1.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The iso-surface of a TSDF grid: (verts (Nv, 3) in world
    coordinates, faces (Nf, 3)), faces turned along the TSDF's gradient."""
    tsdf = np.asarray(tsdf, np.float32)
    weight = np.asarray(weight, np.float32)
    X, Y, Z = tsdf.shape
    obs = weight >= min_weight
    val = tsdf - iso
    cx, cy, cz = X - 1, Y - 1, Z - 1
    corner_vals = np.empty((8, cx, cy, cz), np.float32)
    corner_obs = np.ones((cx, cy, cz), bool)
    for c in range(8):
        ox, oy, oz = _CORNER_OFF[c]
        corner_vals[c] = val[ox:ox + cx, oy:oy + cy, oz:oz + cz]
        corner_obs &= obs[ox:ox + cx, oy:oy + cy, oz:oz + cz]
    neg = corner_vals < 0
    active = corner_obs & neg.any(axis=0) & (~neg).any(axis=0)
    idx = np.argwhere(active)
    if len(idx) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    cube_vals = corner_vals[:, active].T
    base = idx.astype(np.float32)
    verts_list = []
    for tet in _TETS:
        tv = cube_vals[:, tet]
        case = ((tv < 0) * (1 << np.arange(4))).sum(axis=1)
        for c in range(1, 15):
            rows = np.where(case == c)[0]
            if len(rows) == 0:
                continue
            for tri in _TET_TRIS[c]:
                tri_pts = []
                for (i_in, i_out) in tri:
                    ci, co = tet[i_in], tet[i_out]
                    v1 = cube_vals[rows, ci]
                    v2 = cube_vals[rows, co]
                    t = v1 / np.minimum(v1 - v2, -1e-12)
                    p1 = base[rows] + _CORNER_OFF[ci]
                    p2 = base[rows] + _CORNER_OFF[co]
                    tri_pts.append(p1 + t[:, None] * (p2 - p1))
                verts_list.append(np.stack(tri_pts, axis=1))
    flat = np.concatenate(verts_list, axis=0).reshape(-1, 3)
    # weld by quantised keys; each vertex at its first occurrence
    keys = np.round(flat * 256.0).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    first = np.full(len(uniq), len(flat), np.int64)
    np.minimum.at(first, inv, np.arange(len(flat)))
    verts = flat[first]
    faces = inv.reshape(-1, 3)
    faces = faces[(faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                  & (faces[:, 0] != faces[:, 2])]
    cent = verts[faces].mean(axis=1)
    ci = np.clip(np.round(cent).astype(np.int64), 0,
                 np.array([X - 1, Y - 1, Z - 1]))
    gx, gy, gz = np.gradient(val)
    grad = np.stack([gx[ci[:, 0], ci[:, 1], ci[:, 2]],
                     gy[ci[:, 0], ci[:, 1], ci[:, 2]],
                     gz[ci[:, 0], ci[:, 1], ci[:, 2]]], axis=1)
    n = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                 verts[faces[:, 2]] - verts[faces[:, 0]])
    flip = (n * grad).sum(axis=1) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    verts_world = verts * voxel + np.asarray(origin, np.float32)[None]
    return verts_world.astype(np.float32), faces.astype(np.int64)


def tsdf_mesh(depth: np.ndarray, valid: np.ndarray, K: np.ndarray,
              R: np.ndarray, t: np.ndarray, resolution: int, device,
              trunc_voxels: float = 3.0, min_weight: float = 1.0) -> Dict:
    """One depth map fused and its surface extracted: {verts, faces,
    voxel}. The grid spans the 2nd to 98th percentile box of a sample of
    the back-projected depth, padded by the truncation band."""
    depths = np.asarray(depth, np.float32)[None]
    valids = np.asarray(valid, bool)[None]
    Ks, Rs, ts = (np.asarray(a, np.float32)[None] for a in (K, R, t))
    vv, uu = np.nonzero(valids[0])
    sel = np.random.default_rng(0).choice(len(vv), size=min(len(vv), 20000),
                                          replace=False)
    vv, uu = vv[sel], uu[sel]
    z = depths[0, vv, uu]
    x = (uu - Ks[0, 0, 2]) / Ks[0, 0, 0] * z
    y = (vv - Ks[0, 1, 2]) / Ks[0, 1, 1] * z
    allp = (np.stack([x, y, z], axis=1) - ts[0][None]) @ Rs[0]
    lo = np.percentile(allp, 2, axis=0)
    hi = np.percentile(allp, 98, axis=0)
    voxel = max(float(np.max(hi - lo)) / (resolution - 1), 1e-6)
    trunc = trunc_voxels * voxel
    lo = lo - trunc
    dims = tuple(int(d) for d in np.minimum(
        np.ceil((hi + trunc - lo) / voxel).astype(int) + 1,
        resolution + 2 * int(trunc_voxels) + 2))
    tsdf, weight = tsdf_fuse(
        torch.from_numpy(depths).to(device), torch.from_numpy(valids).to(
            device), torch.from_numpy(Ks), torch.from_numpy(Rs),
        torch.from_numpy(ts), torch.from_numpy(lo.astype(np.float32)),
        np.float32(voxel), dims, np.float32(trunc))
    verts, faces = marching_tetrahedra(tsdf.cpu().numpy(),
                                       weight.cpu().numpy(), lo, voxel,
                                       min_weight=min_weight)
    return {"verts": verts, "faces": faces, "voxel": voxel}


# ---- repair and smoothing (from ops/mesh.py)

def _compact_mesh(verts: np.ndarray, faces: np.ndarray):
    if len(faces) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), int)
    used = np.unique(faces)
    remap = -np.ones(len(verts), int)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces]


def repair_mesh(verts: np.ndarray, faces: np.ndarray):
    """Degenerate, duplicate and zero-area faces and unreferenced
    vertices removed."""
    f = np.asarray(faces)
    if len(f) == 0:
        return verts, f
    f = f[(f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])]
    _, uniq = np.unique(np.sort(f, axis=1), axis=0, return_index=True)
    f = f[np.sort(uniq)]
    v = np.asarray(verts)
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    f = f[np.linalg.norm(n, axis=1) > 1e-12]
    return _compact_mesh(v, f)


def smooth_mesh(verts: np.ndarray, faces: np.ndarray, iterations: int,
                lam: float = 0.5):
    """Laplacian smoothing over the faces' edges, in float64."""
    v = np.asarray(verts, np.float64).copy()
    f = np.asarray(faces)
    if len(f) == 0:
        return v, f
    nbr_sum = np.zeros_like(v)
    nbr_cnt = np.zeros(len(v))
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    for _ in range(iterations):
        nbr_sum[:] = 0
        nbr_cnt[:] = 0
        np.add.at(nbr_sum, edges[:, 0], v[edges[:, 1]])
        np.add.at(nbr_cnt, edges[:, 0], 1)
        np.add.at(nbr_sum, edges[:, 1], v[edges[:, 0]])
        np.add.at(nbr_cnt, edges[:, 1], 1)
        target = nbr_sum / np.maximum(nbr_cnt, 1)[:, None]
        has = nbr_cnt > 0
        v[has] = (1 - lam) * v[has] + lam * target[has]
    return v, f


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return x
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(x.dtype)
    raise ValueError(f"unknown precision {precision!r}")


def surface(points: torch.Tensor, depth: torch.Tensor, valid: torch.Tensor,
            K: np.ndarray, R: np.ndarray, t: np.ndarray, resolution: int,
            device, precision: str = "float32") -> Dict:
    """Normals, quality, mesh (`verts`, `faces`) and the TSDF's `voxel`
    of a filtered cloud (P, 3) and the fused depth it came from, seen
    from the reference camera (K, R, t). `precision="bfloat16"` works
    from the cloud and the depth rounded to bfloat16 (the control)."""
    points, depth = _round(points, precision), _round(depth, precision)
    viewpoint = -np.asarray(R, np.float64).T @ np.asarray(t, np.float64)
    out = {"normals": normals(points, viewpoint).cpu().numpy(),
           "quality": cloud_quality(points.cpu().numpy())}
    valid_np = valid.cpu().numpy()
    mesh: Optional[Dict] = None
    if valid_np.any():
        mesh = tsdf_mesh(depth.cpu().numpy(), valid_np, K, R, t,
                         resolution, device)
    verts, faces = ((mesh["verts"], mesh["faces"]) if mesh else
                    (np.zeros((0, 3)), np.zeros((0, 3), np.int64)))
    verts, faces = repair_mesh(verts, faces)
    out["verts"], out["faces"] = smooth_mesh(verts, faces, SMOOTH_ITERATIONS)
    out["voxel"] = mesh["voxel"] if mesh else 0.0
    return out
