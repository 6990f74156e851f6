"""Checkerboard camera calibration (Zhang's method).

Port of `tpu3drec/sfm/calibration.py`: per-view homographies from the
port's DLT (`ops/geometry.py:solve_homography_dlt`) on `device`, the
closed-form intrinsics from the absolute-conic constraints and the plane
pose of each view on the host (numpy, as in the reference), then a joint
polish of the intrinsics and poses through the port's bundle adjustment
(`ops/ba.py`) with the target points held fixed.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from tpu3drec_torch.core.device import resolve_device


def checkerboard_object_points(cols: int, rows: int,
                               square_size: float = 1.0) -> np.ndarray:
    """(N, 2) planar target points (z = 0 plane)."""
    xs, ys = np.meshgrid(np.arange(cols), np.arange(rows))
    return (np.stack([xs.ravel(), ys.ravel()], 1) * square_size
            ).astype(np.float64)


def _zhang_K_from_homographies(Hs: Sequence[np.ndarray]) -> np.ndarray:
    """Closed-form intrinsics from >=3 plane homographies (Zhang 2000)."""
    def v(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ])
    V = []
    for H in Hs:
        V.append(v(H, 0, 1))
        V.append(v(H, 0, 0) - v(H, 1, 1))
    V = np.stack(V)
    _, _, Vt = np.linalg.svd(V)
    b11, b12, b22, b13, b23, b33 = Vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 ** 2)
    lam = b33 - (b13 ** 2 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 ** 2)))
    cx = -b13 * fx ** 2 / lam
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def _pose_from_homography(H: np.ndarray, K: np.ndarray):
    """Plane pose from H = K [r1 r2 t]."""
    A = np.linalg.inv(K) @ H
    s = 1.0 / max(np.linalg.norm(A[:, 0]), 1e-12)
    if A[2, 2] < 0:
        s = -s
    r1 = A[:, 0] * s
    r2 = A[:, 1] * s
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1, 1, -1]) @ Vt
    return R, A[:, 2] * s


class CameraCalibration:
    """Checkerboard calibration on `device` (None means CUDA)."""

    def __init__(self, board_cols: int = 9, board_rows: int = 6,
                 square_size: float = 1.0, device=None):
        self.cols = board_cols
        self.rows = board_rows
        self.square = square_size
        self.obj = checkerboard_object_points(board_cols, board_rows,
                                              square_size)
        self.device = resolve_device(device)

    def calibrate(self, corner_sets: Sequence[np.ndarray],
                  image_size: Tuple[int, int],
                  refine: bool = True) -> Dict:
        """Intrinsics from >=3 views' ordered corner detections
        (each (N, 2), N = cols*rows). Returns {K, poses, mean_reproj_px}."""
        from tpu3drec_torch.ops.geometry import solve_homography_dlt
        if len(corner_sets) < 3:
            raise ValueError("need >= 3 checkerboard views")
        dev = self.device
        obj = torch.as_tensor(self.obj.astype(np.float32), device=dev)
        corners = torch.as_tensor(
            np.stack([np.asarray(c, np.float32) for c in corner_sets]),
            device=dev)
        H, ok = solve_homography_dlt(obj.expand(len(corner_sets), -1, -1),
                                     corners)
        H, ok = H.cpu().numpy().astype(np.float64), ok.cpu().numpy()
        # a view whose DLT fails is dropped with its corners, so each
        # pose below stays paired with its own view
        Hs = [H[i] for i in range(len(corner_sets)) if ok[i]]
        corner_sets = [c for c, keep in zip(corner_sets, ok) if keep]
        K = _zhang_K_from_homographies(Hs)
        poses = [_pose_from_homography(Hv, K) for Hv in Hs]

        if refine:
            from tpu3drec_torch.ops.ba import (
                BAConfig, BAProblem, bundle_adjust, make_cam_params,
                unpack_cam_params,
            )
            from tpu3drec_torch.ops.lie import exp_so3, log_so3
            n = len(self.obj)
            obj3 = np.concatenate([self.obj, np.zeros((n, 1))], 1)
            cams, oc, op, uv = [], [], [], []
            for vi, ((R, t), c) in enumerate(zip(poses, corner_sets)):
                rv = log_so3(torch.as_tensor(R.astype(np.float32)))
                cams.append(make_cam_params(rv.numpy(), t.astype(np.float32),
                                            K.astype(np.float32)))
                oc.extend([vi] * n)
                op.extend(range(n))
                uv.extend(np.asarray(c, np.float32))
            # shared intrinsics: each view's float, then their mean (poses
            # free); the target geometry is known, so no point moves
            prob = BAProblem.from_numpy(
                np.stack(cams), obj3, np.asarray(oc), np.asarray(op),
                np.stack(uv), param_mask=np.ones((len(poses), 10), np.float32),
                point_mask=np.zeros(n, bool), device=dev)
            res = bundle_adjust(prob, BAConfig(max_iters=25,
                                               optimize_intrinsics=True))
            rv, tv, Kj = unpack_cam_params(res.cam_params)
            Rj = exp_so3(rv)
            K = np.mean(Kj.cpu().numpy().astype(np.float64), axis=0)
            poses = [(Rj[vi].cpu().numpy().astype(np.float64),
                      tv[vi].cpu().numpy().astype(np.float64))
                     for vi in range(len(poses))]
            reproj = float(res.mean_reproj_px)
        else:
            reproj = self._reproj_error(K, poses, corner_sets)
        return {"K": K, "poses": poses, "mean_reproj_px": reproj,
                "num_views": len(poses), "image_size": image_size}

    def _reproj_error(self, K, poses, corner_sets) -> float:
        n = len(self.obj)
        obj3 = np.concatenate([self.obj, np.zeros((n, 1))], 1)
        errs = []
        for (R, t), corners in zip(poses, corner_sets):
            Xc = obj3 @ R.T + t
            uv = (Xc / Xc[:, 2:3]) @ K.T
            errs.append(np.linalg.norm(uv[:, :2] - corners, axis=1))
        return float(np.concatenate(errs).mean())
