"""Synthetic benchmark inputs.

Port of `tpu3drec/bench/synthetic.py`: `SyntheticImageGenerator` (seeded
images with texture, shapes and noise), `create_transform_pair` (a known
homography and the image warped by it) and `make_sfm_scene`, the input of
the incremental-SfM benchmark. All numpy, drawn in the reference's order:
the images are bit-equal to the reference's. The scene's rotations come
from the port's own Rodrigues (`exp_so3_np`) instead of OpenCV's, so the
scene equals the reference's to float64 rounding.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from tpu3drec_torch.ops.lie import exp_so3_np


class SyntheticImageGenerator:
    """Seeded images: gradient background, octave noise, shapes, curves,
    gaussian and salt-and-pepper noise."""

    def __init__(self, width: int = 640, height: int = 480, seed: int = 42):
        self.width = width
        self.height = height
        self.seed = seed

    def _gradient_background(self, rng) -> np.ndarray:
        h, w = self.height, self.width
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        a, b = rng.uniform(-1, 1, 2)
        g = (a * xs / w + b * ys / h)
        g = (g - g.min()) / max(g.max() - g.min(), 1e-9)
        return 0.3 + 0.4 * g

    def _octave_noise(self, rng, octaves: int = 4) -> np.ndarray:
        h, w = self.height, self.width
        out = np.zeros((h, w), np.float32)
        amp = 1.0
        for o in range(octaves):
            sh, sw = max(h >> (octaves - o), 2), max(w >> (octaves - o), 2)
            coarse = rng.standard_normal((sh, sw)).astype(np.float32)
            # bilinear upsample to full size
            yi = np.linspace(0, sh - 1, h)
            xi = np.linspace(0, sw - 1, w)
            y0 = np.clip(yi.astype(int), 0, sh - 2)
            x0 = np.clip(xi.astype(int), 0, sw - 2)
            fy = (yi - y0)[:, None]
            fx = (xi - x0)[None, :]
            up = ((1 - fy) * (1 - fx) * coarse[y0][:, x0]
                  + (1 - fy) * fx * coarse[y0][:, x0 + 1]
                  + fy * (1 - fx) * coarse[y0 + 1][:, x0]
                  + fy * fx * coarse[y0 + 1][:, x0 + 1])
            out += amp * up
            amp *= 0.5
        out -= out.min()
        out /= max(out.max(), 1e-9)
        return out

    def _draw_shapes(self, img: np.ndarray, rng, n_shapes: int = 25) -> None:
        h, w = img.shape
        ys, xs = np.mgrid[0:h, 0:w]
        for _ in range(n_shapes):
            kind = rng.integers(0, 3)
            v = rng.uniform(-0.5, 0.5)
            if kind == 0:  # rectangle
                y, x = rng.integers(0, h - 20), rng.integers(0, w - 20)
                hh, ww = rng.integers(10, h // 3), rng.integers(10, w // 3)
                img[y:y + hh, x:x + ww] += v
            elif kind == 1:  # circle
                cy, cx = rng.integers(10, h - 10), rng.integers(10, w - 10)
                r = rng.integers(5, min(h, w) // 6)
                img[(ys - cy) ** 2 + (xs - cx) ** 2 < r * r] += v
            else:  # triangle (half-plane intersection)
                cy, cx = rng.integers(20, h - 20), rng.integers(20, w - 20)
                r = rng.integers(10, min(h, w) // 6)
                band = (np.abs(ys - cy) + np.abs(xs - cx)) < r
                img[band & (ys >= cy)] += v

    def _draw_curves(self, img: np.ndarray, rng, n_curves: int = 6) -> None:
        h, w = img.shape
        for _ in range(n_curves):
            x = np.arange(w)
            a = rng.uniform(-0.002, 0.002)
            b = rng.uniform(-0.5, 0.5)
            c = rng.integers(10, h - 10)
            y = (a * (x - w / 2) ** 2 + b * (x - w / 2) + c).astype(int)
            ok = (y >= 1) & (y < h - 1)
            v = rng.uniform(-0.4, 0.4)
            for dy in (-1, 0, 1):
                img[y[ok] + dy, x[ok]] += v

    def generate(self, noise_level: float = 0.02,
                 salt_pepper: float = 0.002,
                 seed: Optional[int] = None) -> np.ndarray:
        """(H, W) float32 image in [0, 1], fully seeded."""
        rng = np.random.default_rng(self.seed if seed is None else seed)
        img = self._gradient_background(rng)
        img += 0.25 * self._octave_noise(rng)
        self._draw_shapes(img, rng)
        self._draw_curves(img, rng)
        img += noise_level * rng.standard_normal(img.shape).astype(np.float32)
        if salt_pepper > 0:
            m = rng.random(img.shape)
            img[m < salt_pepper / 2] = 0.0
            img[m > 1 - salt_pepper / 2] = 1.0
        img -= img.min()
        img /= max(img.max(), 1e-9)
        return img.astype(np.float32)


def _warp(img: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Inverse bilinear warp by homography H (src -> dst)."""
    h, w = img.shape
    Hinv = np.linalg.inv(H)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])
    src = Hinv @ pts
    sx = src[0] / src[2]
    sy = src[1] / src[2]
    sx = np.clip(sx, 0, w - 1.001)
    sy = np.clip(sy, 0, h - 1.001)
    x0 = sx.astype(int)
    y0 = sy.astype(int)
    fx = sx - x0
    fy = sy - y0
    flat = img
    v = ((1 - fy) * (1 - fx) * flat[y0, x0]
         + (1 - fy) * fx * flat[y0, x0 + 1]
         + fy * (1 - fx) * flat[y0 + 1, x0]
         + fy * fx * flat[y0 + 1, x0 + 1])
    return v.reshape(h, w).astype(np.float32)


def create_transform_pair(img: np.ndarray, transform_type: str = "perspective",
                          magnitude: float = 0.3, seed: int = 0
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(warped, H_gt) for the perspective, affine, rotation and scale
    families, H_gt about the image centre."""
    rng = np.random.default_rng(seed)
    h, w = img.shape
    cx, cy = w / 2.0, h / 2.0
    if transform_type == "rotation":
        a = magnitude * rng.uniform(0.3, 1.0) * 0.6  # radians
        H = np.array([[math.cos(a), -math.sin(a), 0],
                      [math.sin(a), math.cos(a), 0],
                      [0, 0, 1.0]])
    elif transform_type == "scale":
        s = 1.0 + magnitude * rng.uniform(-0.5, 0.5)
        H = np.diag([s, s, 1.0])
    elif transform_type == "affine":
        A = np.eye(2) + magnitude * 0.3 * rng.uniform(-1, 1, (2, 2))
        H = np.eye(3)
        H[:2, :2] = A
        H[:2, 2] = magnitude * 20 * rng.uniform(-1, 1, 2)
    elif transform_type == "perspective":
        H = np.eye(3)
        H[:2, :2] += magnitude * 0.2 * rng.uniform(-1, 1, (2, 2))
        H[:2, 2] = magnitude * 25 * rng.uniform(-1, 1, 2)
        H[2, :2] = magnitude * 2e-4 * rng.uniform(-1, 1, 2)
    else:
        raise ValueError(f"unknown transform {transform_type!r}")
    # re-center: warp around the image center
    T = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    Ti = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1.0]])
    H = Ti @ H @ T
    return _warp(img, H), H


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
