"""COLMAP export.

Port of `tpu3drec/io/colmap.py` (numpy only, copied): the per-pair
keypoints/matches text files of the matching stage, and the COLMAP 3.x
sparse-model text export (cameras.txt / images.txt / points3D.txt) of a
reconstruction, byte for byte the reference's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np


def export_pair_matches(output_dir, image1_id: str, image2_id: str,
                        kpts1: np.ndarray, kpts2: np.ndarray,
                        matches: np.ndarray) -> None:
    """Per-pair export: `<image>_keypoints.txt` for both images and
    `matches.txt`."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    for fname, kpts in ((f"{image1_id}_keypoints.txt", kpts1),
                        (f"{image2_id}_keypoints.txt", kpts2)):
        with open(out / fname, "w") as f:
            for x, y in np.asarray(kpts):
                f.write(f"{x} {y}\n")
    with open(out / "matches.txt", "w") as f:
        for i1, i2 in np.asarray(matches):
            f.write(f"{int(i1)} {int(i2)}\n")


def _rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> COLMAP quaternion (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        w = np.sqrt(1.0 + t) / 2.0
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2.0
        q = np.zeros(4)
        q[1 + i] = s / 4.0
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        w, x, y, z = q
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def export_sparse_model(output_dir,
                        cameras: Dict[int, Dict],
                        points3d: np.ndarray,
                        point_colors: Optional[np.ndarray] = None,
                        observations: Optional[Sequence] = None) -> None:
    """Write a COLMAP 3.x sparse text model.

    cameras: {image_id: {"K": (3,3), "R": (3,3), "t": (3,), "name": str,
                         "width": int, "height": int}}
    points3d: (P, 3); point_colors: (P, 3) uint8 optional.
    observations: optional list of (image_id, point_id, x, y) tuples for
    the 2D track entries.
    """
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)

    obs_by_img: Dict[int, list] = {i: [] for i in cameras}
    obs_by_pt: Dict[int, list] = {}
    if observations:
        for img_id, pt_id, x, y in observations:
            local_idx = len(obs_by_img.setdefault(img_id, []))
            obs_by_img[img_id].append((x, y, pt_id, local_idx))
            obs_by_pt.setdefault(pt_id, []).append((img_id, local_idx))

    with open(out / "cameras.txt", "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for img_id, cam in sorted(cameras.items()):
            K = np.asarray(cam["K"])
            w = cam.get("width", int(K[0, 2] * 2))
            h = cam.get("height", int(K[1, 2] * 2))
            f.write(f"{img_id} PINHOLE {w} {h} "
                    f"{K[0, 0]} {K[1, 1]} {K[0, 2]} {K[1, 2]}\n")

    with open(out / "images.txt", "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for img_id, cam in sorted(cameras.items()):
            q = _rotmat_to_qvec(np.asarray(cam["R"], np.float64))
            t = np.asarray(cam["t"], np.float64)
            name = cam.get("name", f"image_{img_id}")
            f.write(f"{img_id} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{t[0]} {t[1]} {t[2]} {img_id} {name}\n")
            row = " ".join(f"{x} {y} {pt}" for x, y, pt, _ in
                           obs_by_img.get(img_id, []))
            f.write(row + "\n")

    pts = np.asarray(points3d)
    if point_colors is None:
        point_colors = np.full((len(pts), 3), 128, np.uint8)
    with open(out / "points3D.txt", "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for pid, (p, c) in enumerate(zip(pts, np.asarray(point_colors))):
            track = " ".join(f"{img} {li}" for img, li in
                             obs_by_pt.get(pid, []))
            f.write(f"{pid} {p[0]} {p[1]} {p[2]} "
                    f"{int(c[0])} {int(c[1])} {int(c[2])} 0.0 {track}\n")
