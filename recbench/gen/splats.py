"""The folder scene: textured splats seen by a camera on an arc.

A copy of `chip_smoke.py:render_splat_views` (itself
`tests/test_end_to_end.py`'s renderer at focal `f`), returning the views
and the scene's truth instead of writing files: each 3-D point is a
unique random 6x6 texture patch, scaled with 1/depth and painted far to
near, in 8-bit grey levels as a folder of images would hold them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def render_splat_views(n_views: int, n_pts: int, scene_seed: int,
                       seed: int, noise: float, f: float = 544.0,
                       width: int = 640, height: int = 480) -> Dict:
    """`names`, `images` (name -> (H, W) float32 in [0, 1], 8-bit levels),
    `K` (3, 3), `R` and `t` (name -> world-to-camera pose, x_c = R x_w + t)
    and `points` (n_pts, 3). The scene (the splats' places, sizes and
    textures) comes from `scene_seed`; `seed` draws the sensor's Gaussian
    noise, `noise` 8-bit levels in standard deviation, added to every
    view before it is quantised."""
    rng = np.random.default_rng(scene_seed)
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]])
    X = rng.uniform(-4, 4, (n_pts, 3)) + np.array([0, 0, 12.0])
    base_size = rng.uniform(10.0, 18.0, n_pts) * (f / 544.0)
    patches = rng.uniform(0.15, 1.0, (n_pts, 6, 6)).astype(np.float32)
    sensor = np.random.default_rng(seed)
    names, images, Rs, ts = [], {}, {}, {}
    for i in range(n_views):
        ang = (i - n_views / 2) * 0.09
        R = np.array([[np.cos(ang), 0, np.sin(ang)],
                      [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        c = np.array([6 * np.sin(ang), 0.1 * i, 12 - 6 * np.cos(ang)])
        Xc = (R @ X.T + (-R @ c)[:, None]).T
        z = Xc[:, 2]
        uv = (K @ Xc.T).T
        uv = uv[:, :2] / uv[:, 2:3]
        img = np.zeros((height, width), np.float32)
        for j in np.argsort(-z):            # far splats first
            if z[j] < 1:
                continue
            s = int(round(base_size[j] * 12.0 / z[j]))
            if s < 4:
                continue
            idx = (np.arange(s) * 6 // s)
            patch = patches[j][np.ix_(idx, idx)]
            x0 = int(round(uv[j, 0])) - s // 2
            y0 = int(round(uv[j, 1])) - s // 2
            xa, ya = max(0, x0), max(0, y0)
            xb, yb = min(width, x0 + s), min(height, y0 + s)
            if xa >= xb or ya >= yb:
                continue
            img[ya:yb, xa:xb] = patch[ya - y0:yb - y0, xa - x0:xb - x0]
        name = f"view_{i:02d}.png"
        img = img + sensor.normal(0.0, noise / 255.0,
                                  img.shape).astype(np.float32)
        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        images[name] = u8.astype(np.float32) / 255.0
        names.append(name)
        Rs[name] = R
        ts[name] = -R @ c
    return {"names": names, "images": images, "K": K, "R": Rs, "t": ts,
            "points": X}


def sparse_input(scene: Dict) -> Dict:
    """The dense stage's sparse input in the legacy format
    (`camera_poses` with camera_matrix / rotation / translation, and
    `points_3d`), built from the scene's own cameras and points."""
    poses = {n: {"camera_matrix": scene["K"].tolist(),
                 "rotation": scene["R"][n].tolist(),
                 "translation": scene["t"][n].tolist()}
             for n in scene["names"]}
    return {"camera_poses": poses, "points_3d": scene["points"].tolist()}
