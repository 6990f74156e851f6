"""Mesh generation: depth-map meshing, 2.5D Delaunay, vertex-clustering
simplification, repair, Laplacian smoothing, texture projection, quality
metrics, signed volume, mesh comparison and OBJ export.

Host numpy, copied from `tpu3drec/ops/mesh.py` (meshing is data-dependent
combinatorial work). Poisson, ball pivoting and alpha shapes are the
implicit-surface reconstructions of `ops/implicit.py` (their fields on
`device`, None meaning CUDA), re-exported here under the reference's
names.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def depth_map_to_mesh(depth: np.ndarray, K: np.ndarray,
                      R: Optional[np.ndarray] = None,
                      t: Optional[np.ndarray] = None,
                      valid: Optional[np.ndarray] = None,
                      stride: int = 2,
                      max_depth_jump: float = 0.1):
    """Regular-grid triangulation of a depth map
    (mesh_generation.py:622-720). Returns (vertices (V,3), faces (F,3)).

    Triangles spanning relative depth jumps > max_depth_jump are dropped
    (occlusion boundaries).
    """
    d = depth[::stride, ::stride]
    v = (valid[::stride, ::stride] if valid is not None else d > 1e-6)
    h, w = d.shape
    ys, xs = np.mgrid[0:h, 0:w]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = d.astype(np.float64)
    X = (xs * stride - cx) / fx * z
    Y = (ys * stride - cy) / fy * z
    pts_cam = np.stack([X, Y, z], axis=-1).reshape(-1, 3)
    if R is not None:
        pts = (pts_cam - t[None, :]) @ R
    else:
        pts = pts_cam

    idx = np.arange(h * w).reshape(h, w)
    faces = []
    # two triangles per grid cell where all corners valid + depth-coherent
    va = v[:-1, :-1] & v[:-1, 1:] & v[1:, :-1] & v[1:, 1:]
    dmax = np.stack([d[:-1, :-1], d[:-1, 1:], d[1:, :-1], d[1:, 1:]])
    rel_jump = (dmax.max(0) - dmax.min(0)) / np.maximum(dmax.mean(0), 1e-9)
    ok = va & (rel_jump <= max_depth_jump)
    ii, jj = np.where(ok)
    a = idx[ii, jj]
    b = idx[ii, jj + 1]
    c = idx[ii + 1, jj]
    e = idx[ii + 1, jj + 1]
    faces = np.concatenate([np.stack([a, b, c], 1),
                            np.stack([b, e, c], 1)], axis=0)
    return _compact_mesh(pts, faces)


def delaunay_mesh(points: np.ndarray, max_edge: Optional[float] = None):
    """2.5D Delaunay over the dominant plane (mesh_generation.py:181-228)."""
    from scipy.spatial import Delaunay
    pts = np.asarray(points, np.float64)
    if len(pts) < 4:
        return pts, np.zeros((0, 3), int)
    centered = pts - pts.mean(0)
    _, _, Vt = np.linalg.svd(centered, full_matrices=False)
    uv = centered @ Vt[:2].T
    tri = Delaunay(uv)
    faces = tri.simplices
    if max_edge is not None:
        e = np.stack([
            np.linalg.norm(pts[faces[:, 0]] - pts[faces[:, 1]], axis=1),
            np.linalg.norm(pts[faces[:, 1]] - pts[faces[:, 2]], axis=1),
            np.linalg.norm(pts[faces[:, 2]] - pts[faces[:, 0]], axis=1),
        ]).max(0)
        faces = faces[e <= max_edge]
    return pts, faces


def _compact_mesh(verts: np.ndarray, faces: np.ndarray):
    """Drop unreferenced vertices, reindex faces."""
    if len(faces) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), int)
    used = np.unique(faces)
    remap = -np.ones(len(verts), int)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces]


def repair_mesh(verts: np.ndarray, faces: np.ndarray):
    """Remove degenerate + duplicate faces, unreferenced vertices
    (mesh_generation.py:277-304)."""
    f = np.asarray(faces)
    if len(f) == 0:
        return verts, f
    good = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    f = f[good]
    key = np.sort(f, axis=1)
    _, uniq = np.unique(key, axis=0, return_index=True)
    f = f[np.sort(uniq)]
    # drop zero-area faces
    v = np.asarray(verts)
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    f = f[np.linalg.norm(n, axis=1) > 1e-12]
    return _compact_mesh(v, f)


def smooth_mesh(verts: np.ndarray, faces: np.ndarray,
                iterations: int = 3, lam: float = 0.5):
    """Laplacian smoothing (mesh_generation.py:253-276)."""
    v = np.asarray(verts, np.float64).copy()
    f = np.asarray(faces)
    if len(f) == 0:
        return v, f
    n = len(v)
    # adjacency accumulation
    nbr_sum = np.zeros_like(v)
    nbr_cnt = np.zeros(n)
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


def simplify_mesh(verts: np.ndarray, faces: np.ndarray,
                  target_faces: int):
    """Vertex-clustering simplification (mesh_generation.py:229-252)."""
    v = np.asarray(verts)
    f = np.asarray(faces)
    if len(f) <= target_faces or len(f) == 0:
        return v, f
    # shrink the cluster grid until the face budget is met
    extent = v.max(0) - v.min(0)
    n_cells = 64
    new_v, new_f = v, f
    for _ in range(8):
        size = extent / n_cells
        size[size <= 0] = 1.0
        keys = np.floor((v - v.min(0)) / size).astype(np.int64)
        uniq, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                                      return_counts=True)
        acc = np.zeros((len(uniq), 3))
        np.add.at(acc, inv, v)
        new_v, new_f = repair_mesh(acc / counts[:, None], inv[f])
        if len(new_f) <= target_faces or n_cells <= 2:
            break
        n_cells //= 2
    return new_v, new_f


def project_texture(verts: np.ndarray, cameras: Dict,
                    images: Dict[str, np.ndarray]) -> np.ndarray:
    """Per-vertex colors from the best-facing calibrated view
    (mesh_generation.py:305-415). cameras: {name: {K, R, t}};
    images: {name: (H, W) or (H, W, 3) float [0,1]}."""
    v = np.asarray(verts)
    colors = np.full((len(v), 3), 0.5)
    best_score = np.full(len(v), -np.inf)
    for name, cam in cameras.items():
        if name not in images:
            continue
        img = np.asarray(images[name])
        K = np.asarray(cam["K"])
        R = np.asarray(cam["R"])
        t = np.asarray(cam["t"])
        Xc = v @ R.T + t
        z = Xc[:, 2]
        front = z > 1e-6
        uv = (Xc / np.maximum(z, 1e-9)[:, None]) @ K.T
        h, w = img.shape[:2]
        x = uv[:, 0]
        y = uv[:, 1]
        inb = front & (x >= 0) & (x < w - 1) & (y >= 0) & (y < h - 1)
        score = np.where(inb, -z, -np.inf)  # prefer closest view
        upd = score > best_score
        xi = np.clip(x.astype(int), 0, w - 1)
        yi = np.clip(y.astype(int), 0, h - 1)
        px = img[yi, xi]
        if px.ndim == 1:
            px = np.stack([px] * 3, axis=1)
        colors[upd] = px[upd][:, :3]
        best_score = np.where(upd, score, best_score)
    return colors


def mesh_quality(verts: np.ndarray, faces: np.ndarray) -> Dict:
    """Watertightness/area/edge stats (mesh_generation.py:416-503)."""
    v = np.asarray(verts)
    f = np.asarray(faces)
    if len(f) == 0:
        return {"num_vertices": len(v), "num_faces": 0,
                "surface_area": 0.0, "is_watertight": False}
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    area = 0.5 * np.linalg.norm(n, axis=1).sum()
    edges = np.sort(np.concatenate(
        [f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    watertight = bool(np.all(counts == 2))
    return {
        "num_vertices": int(len(v)),
        "num_faces": int(len(f)),
        "surface_area": float(area),
        "is_watertight": watertight,
        "boundary_edges": int((counts == 1).sum()),
        "nonmanifold_edges": int((counts > 2).sum()),
    }


def create_mesh_poisson(points: np.ndarray,
                        normals: Optional[np.ndarray] = None,
                        resolution: int = 96, device=None, **kw):
    """Poisson surface reconstruction (mesh_generation.py:29-86).
    Returns (vertices, faces). Spectral solve: see ops/implicit.py."""
    from tpu3drec_torch.ops.implicit import poisson_mesh
    m = poisson_mesh(points, normals, resolution=resolution, device=device,
                     **kw)
    return m["verts"], m["faces"]


def create_mesh_ball_pivoting(points: np.ndarray,
                              normals: Optional[np.ndarray] = None,
                              radius: Optional[float] = None,
                              resolution: int = 96, device=None, **kw):
    """Ball-pivoting equivalent (mesh_generation.py:87-143).
    Returns (vertices, faces): see ops/implicit.py."""
    from tpu3drec_torch.ops.implicit import ball_pivot_mesh
    m = ball_pivot_mesh(points, normals, radius=radius,
                        resolution=resolution, device=device, **kw)
    return m["verts"], m["faces"]


def create_mesh_alpha_shape(points: np.ndarray, alpha: float = 0.03,
                            resolution: int = 96, device=None):
    """Alpha-shape-equivalent surface (mesh_generation.py:144-180).
    Returns (vertices, faces): see ops/implicit.py."""
    from tpu3drec_torch.ops.implicit import alpha_surface_mesh
    m = alpha_surface_mesh(points, alpha, resolution=resolution,
                           device=device)
    return m["verts"], m["faces"]


def mesh_volume(verts: np.ndarray, faces: np.ndarray) -> float:
    """SIGNED volume via the divergence theorem (sum of signed
    tetrahedra to the origin); meaningful for closed oriented meshes.
    Negative for inward-oriented (flipped) meshes; callers wanting the
    enclosed volume take abs()."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces)
    if len(f) == 0:
        return 0.0
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    return float(np.einsum("ij,ij->i", a, np.cross(b, c)).sum() / 6.0)


def compare_meshes(verts1: np.ndarray, faces1: np.ndarray,
                   verts2: np.ndarray, faces2: np.ndarray) -> Dict:
    """Pairwise mesh comparison (mesh_generation.py:721-772): vertex /
    face counts, volume, surface area, extents, each with mesh2/mesh1
    ratios, same keys as the reference."""
    if verts1 is None or verts2 is None:
        return {"error": "One or both meshes are None"}
    q1 = mesh_quality(verts1, faces1)
    q2 = mesh_quality(verts2, faces2)
    vol1 = abs(mesh_volume(verts1, faces1)) if q1.get("is_watertight") else 0.0
    vol2 = abs(mesh_volume(verts2, faces2)) if q2.get("is_watertight") else 0.0
    e1 = (np.asarray(verts1).max(0) - np.asarray(verts1).min(0)
          if len(verts1) else np.zeros(3))
    e2 = (np.asarray(verts2).max(0) - np.asarray(verts2).min(0)
          if len(verts2) else np.zeros(3))
    return {
        "vertex_count": {"mesh1": len(verts1), "mesh2": len(verts2),
                         "ratio": len(verts2) / max(1, len(verts1))},
        "face_count": {"mesh1": len(faces1), "mesh2": len(faces2),
                       "ratio": len(faces2) / max(1, len(faces1))},
        "volume": {"mesh1": vol1, "mesh2": vol2,
                   "ratio": vol2 / max(1e-10, vol1)},
        "surface_area": {"mesh1": q1["surface_area"],
                         "mesh2": q2["surface_area"],
                         "ratio": q2["surface_area"]
                         / max(1e-10, q1["surface_area"])},
        "bounds": {"mesh1_extents": e1.tolist(),
                   "mesh2_extents": e2.tolist(),
                   "extents_ratio": (e2 / np.maximum(e1, 1e-10)).tolist()},
    }


def save_obj(path, verts: np.ndarray, faces: np.ndarray,
             colors: Optional[np.ndarray] = None) -> None:
    """OBJ export (mesh_generation.py:598-621)."""
    with open(path, "w") as fh:
        for i, p in enumerate(np.asarray(verts)):
            if colors is not None:
                c = np.asarray(colors)[i]
                fh.write(f"v {p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                fh.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for tri in np.asarray(faces):
            fh.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")
