"""Synthetic benchmark inputs.

Port of `tpu3drec/bench/synthetic.py:make_sfm_scene`, the input of the
incremental-SfM benchmark. The rotations come from the port's own
Rodrigues (`exp_so3_np`) instead of OpenCV's, and the generator is drawn
in the reference's order, so the scene equals the reference's to float64
rounding.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from tpu3drec_torch.ops.lie import exp_so3_np


def make_sfm_scene(n_views: int = 50, n_pts: int = 15000,
                   width: int = 640, height: int = 480,
                   pair_window: int = 2, noise_px: float = 0.4,
                   visibility: float = 0.85, seed: int = 0
                   ) -> Tuple[Dict, Dict, Dict]:
    """Synthetic SfM folder at the reference's benchmark scale.

    Cameras sweep an arc facing a structured point cloud (a broad slab
    plus a few dense clusters); each point is independently dropped from
    each view with probability 1-`visibility` so tracks are partial, and
    image-plane noise is added per observation. Pairs within
    `pair_window` get their co-visible projections as correspondences.

    Returns (matches_data, image_info, gt) where gt carries the true
    X/K/poses for accuracy assertions.
    """
    rng = np.random.default_rng(seed)
    K = np.array([[700.0, 0, width / 2], [0, 700.0, height / 2],
                  [0, 0, 1.0]])
    n_cl = max(1, n_pts // 5000)
    base = rng.uniform((-5, -3.5, 9.0), (5, 3.5, 15.0),
                       (n_pts - n_cl * (n_pts // (2 * (n_cl + 1))), 3))
    clusters = []
    for _ in range(n_cl):
        c = rng.uniform((-4, -2.5, 10.0), (4, 2.5, 14.0), 3)
        clusters.append(c + 0.6 * rng.standard_normal(
            (n_pts // (2 * (n_cl + 1)), 3)))
    X = np.concatenate([base] + clusters)[:n_pts]

    views = []
    for i in range(n_views):
        ang = (i / max(n_views - 1, 1) - 0.5) * 0.9
        R = exp_so3_np(np.array([0.0, ang, 0.0]))
        c = np.array([8 * np.sin(ang), 0.08 * i, 12 - 8 * np.cos(ang)])
        views.append((R, -R @ c))

    names = [f"img_{i:03d}.png" for i in range(n_views)]
    uv_all, vis_all = [], []
    for R, t in views:
        Xc = (R @ X.T + t[:, None]).T
        z = Xc[:, 2]
        uv = (K @ Xc.T).T
        uv = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-9)
        vis = ((z > 0.5) & (uv[:, 0] > 0) & (uv[:, 0] < width)
               & (uv[:, 1] > 0) & (uv[:, 1] < height)
               & (rng.random(n_pts) < visibility))
        uv_all.append(uv)
        vis_all.append(vis)

    matches_data = {}
    for i in range(n_views):
        for j in range(i + 1, min(i + 1 + pair_window, n_views)):
            vis = vis_all[i] & vis_all[j]
            n_vis = int(vis.sum())
            if n_vis < 8:
                continue
            corr = np.concatenate(
                [uv_all[i][vis] + noise_px * rng.standard_normal((n_vis, 2)),
                 uv_all[j][vis] + noise_px * rng.standard_normal((n_vis, 2))],
                axis=1)
            matches_data[(names[i], names[j])] = {
                "correspondences": corr,
                "num_matches": n_vis, "quality_score": 0.8}
    info = {n: {"name": n, "width": width, "height": height}
            for n in names}
    gt = {"X": X, "K": K, "views": views, "names": names}
    return matches_data, info, gt
