"""Visualization: keypoint and match plotting, method comparisons.

Port of `tpu3drec/viz.py` on matplotlib: side-by-side match rendering
with score-coloured lines, keypoint overlays, multi-method comparison
grids, mesh, point-cloud and reconstruction figures, and figure export.
The functions take the port's Features / Matches / MethodResult
containers, whose tensors may lie on any device (they are copied to the
host to draw).

Host only. matplotlib (Agg backend, headless) is imported inside the
functions, so this module imports where matplotlib is not installed:
`compat` and `cli` import it on a machine without it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from tpu3drec_torch.io.converters import _host


def _plt():
    """matplotlib's pyplot on the Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _to_img(image) -> np.ndarray:
    img = _host(image)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    return np.clip(img, 0, 1)


def _side_by_side(img1: np.ndarray, img2: np.ndarray):
    h = max(img1.shape[0], img2.shape[0])
    w1, w2 = img1.shape[1], img2.shape[1]
    canvas = np.zeros((h, w1 + w2), np.float32)
    canvas[:img1.shape[0], :w1] = img1
    canvas[:img2.shape[0], w1:] = img2
    return canvas, w1


def visualize_matches(image1, image2, result, use_filtered: bool = True,
                      max_draw: int = 200, ax=None,
                      title: Optional[str] = None):
    """Side-by-side match lines colored by match quality
    (visualization.py:210-335, result_converters.py:117-189)."""
    from matplotlib import cm
    plt = _plt()
    img1, img2 = _to_img(image1), _to_img(image2)
    canvas, off = _side_by_side(img1, img2)
    if ax is None:
        _, ax = plt.subplots(figsize=(12, 6))
    ax.imshow(canvas, cmap="gray")
    m = result.best_matches if use_filtered else result.matches
    got = m.to_numpy()
    xy1 = _host(result.features1.xy)
    xy2 = _host(result.features2.xy)
    q = _host(m.quality())[_host(m.mask)]
    order = np.argsort(-q)[:max_draw]
    colors = cm.viridis(q[order] / max(q.max(), 1e-9)) if len(q) else []
    for rank, i in enumerate(order):
        p1 = xy1[got["idx1"][i]]
        p2 = xy2[got["idx2"][i]]
        ax.plot([p1[0], p2[0] + off], [p1[1], p2[1]],
                color=colors[rank], linewidth=0.6, alpha=0.8)
    ax.set_title(title or f"{result.method}: {len(got['idx1'])} matches")
    ax.axis("off")
    return ax


def visualize_keypoints_only(image, features, max_draw: int = 1000,
                             ax=None, title: Optional[str] = None):
    """Keypoint overlay sized by scale, colored by response
    (visualization.py:406-456)."""
    img = _to_img(image)
    if ax is None:
        _, ax = _plt().subplots(figsize=(8, 6))
    ax.imshow(img, cmap="gray")
    d = features.to_numpy()
    n = min(len(d["xy"]), max_draw)
    if n:
        resp = d["response"][:n]
        ax.scatter(d["xy"][:n, 0], d["xy"][:n, 1],
                   s=np.clip(d["scale"][:n], 2, 40),
                   c=resp, cmap="plasma", alpha=0.7, linewidths=0)
    ax.set_title(title or f"{features.method}: {len(d['xy'])} keypoints")
    ax.axis("off")
    return ax


def plot_method_comparison(image1, image2, matching_result,
                           use_filtered: bool = True):
    """Grid of per-method match plots + quality bars
    (visualization.py:122-208)."""
    methods = list(matching_result.keys())
    n = len(methods)
    fig, axes = _plt().subplots(n + 1, 1, figsize=(12, 5 * (n + 1)))
    if n == 0:
        return fig
    axes = np.atleast_1d(axes)
    for ax, m in zip(axes[:-1], methods):
        visualize_matches(image1, image2, matching_result[m],
                          use_filtered=use_filtered, ax=ax)
    names, scores = zip(*[(m, matching_result[m].get_quality_score())
                          for m in methods])
    axes[-1].bar(names, scores, color="tab:blue")
    axes[-1].set_ylabel("quality score")
    axes[-1].set_title("method comparison "
                       f"(best: {matching_result.get_best_method_name()})")
    fig.tight_layout()
    return fig


def save_visualization(fig_or_ax, path, dpi: int = 120) -> Path:
    """Save a figure (or an axis's figure) as an image; returns the path
    (visualization.py:337-404)."""
    fig = fig_or_ax.figure if hasattr(fig_or_ax, "figure") else fig_or_ax
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    _plt().close(fig)
    return path


def visualize_matches_quick(image1, image2, method: str = "SIFT",
                            save_to=None, **kw):
    """One-call detect+match+plot (visualization.py:210-246)."""
    from tpu3drec_torch.api import match_images
    r = match_images(image1, image2, method=method, **kw)
    ax = visualize_matches(image1, image2, r)
    if save_to:
        return save_visualization(ax, save_to)
    return ax


def show_matches(image1, image2, result, **kw):
    """Reference-API alias (visualization.py:247-263)."""
    return visualize_matches(image1, image2, result, **kw)


def visualize_matches_with_scores(image1, image2, result, **kw):
    """Reference-API alias (visualization.py:265-335) — the score coloring
    is the default in visualize_matches here."""
    return visualize_matches(image1, image2, result, **kw)


def plot_visualization_data(image1, image2, matching_result, **kw):
    """Reference-API alias (visualization.py:19-120): multi-method plot."""
    return plot_method_comparison(image1, image2, matching_result, **kw)


def visualize_mesh(verts, faces, title: str = "Mesh Visualization",
                   max_faces: int = 1000, save_to=None):
    """Mesh wireframe + face-area / edge-length / quality panels
    (mesh_generation.py:504-597)."""
    from tpu3drec_torch.ops.mesh import mesh_quality
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    if len(verts) == 0 or len(faces) == 0:
        print("No mesh to visualize")
        return None
    fig = _plt().figure(figsize=(15, 10))
    ax1 = fig.add_subplot(221, projection="3d")
    step = max(1, len(faces) // max_faces)
    sub = faces[::step]
    tri = verts[sub]                                   # (F, 3, 3)
    closed = np.concatenate([tri, tri[:, :1]], axis=1)  # (F, 4, 3)
    for t in closed:
        ax1.plot3D(*t.T, "b-", alpha=0.3, linewidth=0.5)
    ax1.set_title("Mesh Wireframe")

    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    ax2 = fig.add_subplot(222)
    ax2.hist(areas, bins=40, color="steelblue")
    ax2.set_title("Face area distribution")

    edges = np.concatenate([b - a, c - b, a - c])
    ax3 = fig.add_subplot(223)
    ax3.hist(np.linalg.norm(edges, axis=1), bins=40, color="darkorange")
    ax3.set_title("Edge length distribution")

    ax4 = fig.add_subplot(224)
    ax4.axis("off")
    q = mesh_quality(verts, faces)
    ax4.text(0.02, 0.95, "\n".join(f"{k}: {v}" for k, v in q.items()),
             va="top", family="monospace", fontsize=10)
    ax4.set_title("Quality")
    fig.suptitle(title)
    if save_to:
        return save_visualization(fig, save_to)
    return fig


def plot_point_cloud(points, colors=None, normals=None,
                     title: str = "Point Cloud", max_points: int = 10000,
                     save_to=None):
    """Dedicated colored point-cloud figure (reference
    visualize_point_cloud, point_cloud_processing.py:378-481): a 3-D
    scatter colored by RGB (or by depth when no colors), optional
    normal quivers on a subsample, plus per-axis distribution panels."""
    pts = np.asarray(points).reshape(-1, 3)
    if len(pts) == 0:
        print("No points to visualize")
        return None
    sel = np.arange(len(pts))
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
    p = pts[sel]
    c = None
    if colors is not None and len(np.asarray(colors)) == len(pts):
        c = np.asarray(colors)[sel]
        if c.max() > 1.0:
            c = c / 255.0
        c = np.clip(c, 0.0, 1.0)
    fig = _plt().figure(figsize=(12, 8))
    ax = fig.add_subplot(121, projection="3d")
    ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=1,
               c=(c if c is not None else p[:, 2]),
               cmap=None if c is not None else "viridis")
    if normals is not None and len(np.asarray(normals)) == len(pts):
        nsub = sel[:: max(1, len(sel) // 200)]
        n = np.asarray(normals)[nsub]
        q = pts[nsub]
        scale = 0.03 * float(np.linalg.norm(pts.max(0) - pts.min(0)) + 1e-9)
        ax.quiver(q[:, 0], q[:, 1], q[:, 2], n[:, 0], n[:, 1], n[:, 2],
                  length=scale, color="red", alpha=0.5, linewidth=0.5)
    ax.set_title(title)
    for i, (axis, name) in enumerate(zip(range(3), "XYZ")):
        axh = fig.add_subplot(3, 2, 2 * i + 2)
        axh.hist(pts[:, axis], bins=50, color="steelblue")
        axh.set_ylabel(name)
    fig.suptitle(f"{title} — {len(pts)} points")
    if save_to:
        return save_visualization(fig, save_to)
    return fig


def plot_reconstruction_3d(recon, max_points: int = 5000, save_to=None):
    """3-D scatter of the sparse cloud + camera frusta (the SfM-stage
    analogue of the reference's matplotlib cloud views,
    point_cloud_processing.py:378-481)."""
    fig = _plt().figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    pts = recon.points_array()
    if len(pts) > max_points:
        idx = np.random.default_rng(0).permutation(len(pts))[:max_points]
        pts = pts[idx]
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1, c=pts[:, 2],
                   cmap="viridis", alpha=0.5)
    for cam in recon.cameras.values():
        c = cam.center
        z = cam.R.T @ np.array([0, 0, 1.0])
        ax.quiver(c[0], c[1], c[2], z[0], z[1], z[2], length=0.5,
                  color="red")
    ax.set_title(f"{recon.num_cameras} cameras, {recon.num_points} points")
    if save_to:
        return save_visualization(fig, save_to)
    return fig
