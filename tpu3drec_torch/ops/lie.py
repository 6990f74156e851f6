"""SO(3)/SE(3) utilities: axis-angle <-> rotation matrix, projection.

Port of `tpu3drec/ops/lie.py`. The functions are branch-free (the Taylor
fallbacks near theta = 0 are `torch.where` selects, so forward-mode
derivatives take the chosen branch's derivative, as `jax.jacfwd` does)
and work over any leading batch dimensions. The numpy twins
`log_so3_np` / `exp_so3_np` are the host-side bookkeeping versions.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def exp_so3(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (cv2.Rodrigues)."""
    theta2 = (rvec * rvec).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < _EPS
    K = hat(rvec)
    K2 = K @ K
    sin_t = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cos_t = torch.where(small, 0.5 - theta2 / 24.0,
                        (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-24))
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + sin_t * K + cos_t * K2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3)."""
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    cos_theta = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    sin_theta = torch.sin(theta)
    small = sin_theta.abs() < 1e-6
    scale = torch.where(small, 0.5 + theta ** 2 / 12.0,
                        theta / torch.clamp(2.0 * sin_theta, min=1e-24))
    # near theta = pi the formula degrades; BA and PnP work in the
    # small-update regime (the reference's documented limitation)
    return w * scale[..., None]


def project_points(X: torch.Tensor, rvec: torch.Tensor, tvec: torch.Tensor,
                   K: torch.Tensor) -> torch.Tensor:
    """cv2.projectPoints with zero distortion: X (..., N, 3) world points,
    rvec / tvec (..., 3) world -> camera, K (..., 3, 3). Returns (..., N, 2)
    pixels."""
    R = exp_so3(rvec)
    Xc = X @ R.transpose(-1, -2) + tvec[..., None, :]
    zc = Xc[..., 2:3]
    z = torch.clamp(zc.abs(), min=1e-9) * torch.sign(
        torch.where(zc == 0, torch.ones_like(zc), zc))
    xn = Xc[..., :2] / z
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    return torch.stack([xn[..., 0] * fx + cx, xn[..., 1] * fy + cy], -1)


def transform_points(X: torch.Tensor, R: torch.Tensor, t: torch.Tensor
                     ) -> torch.Tensor:
    """World -> camera frame: R X + t for X (..., N, 3)."""
    return X @ R.transpose(-1, -2) + t[..., None, :]


def camera_center(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Camera centre in world coordinates: -R^T t."""
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


def compose_projection(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor
                       ) -> torch.Tensor:
    """P = K [R | t] (..., 3, 4)."""
    return K @ torch.cat([R, t[..., None]], dim=-1)


# -- numpy twins (host-side bookkeeping) --------------------------------

def log_so3_np(R: np.ndarray) -> np.ndarray:
    """Batched (..., 3, 3) rotation matrices -> (..., 3) axis-angle."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R, axis1=-2, axis2=-1)
    cos = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(cos)
    w = np.stack([R[..., 2, 1] - R[..., 1, 2],
                  R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    small = th < 1e-6
    sin_th = np.where(small, 1.0, np.sin(th))
    scale = np.where(small, 0.5 + th * th / 12.0, th / (2.0 * sin_th))
    out = w * scale[..., None]
    # at theta ~= pi the off-diagonal difference vanishes: recover the
    # axis from a a^T = (R + I) / 2 with signs pinned by the largest
    # component, where 1/sin(theta) truly degenerates in float64
    near = np.argwhere(th > np.pi - 1e-6)
    flat_R = R.reshape(-1, 3, 3)
    flat_out = out.reshape(-1, 3)
    flat_th = th.reshape(-1)
    for (i,) in near.reshape(-1, 1):
        Ri = flat_R[i]
        a2 = np.clip(np.diag((Ri + np.eye(3)) / 2.0), 0.0, 1.0)
        k = int(np.argmax(a2))
        a = np.sqrt(a2)
        for j in range(3):
            if j != k and Ri[k, j] + Ri[j, k] < 0:
                a[j] = -a[j]
        flat_out[i] = a / max(np.linalg.norm(a), 1e-12) * flat_th[i]
    return flat_out.reshape(out.shape)


def exp_so3_np(rvec: np.ndarray) -> np.ndarray:
    """Batched (..., 3) axis-angle -> (..., 3, 3) (Rodrigues)."""
    w = np.asarray(rvec, np.float64)
    th = np.linalg.norm(w, axis=-1)
    small = th < 1e-8
    th_safe = np.where(small, 1.0, th)
    a = w / th_safe[..., None]
    zeros = np.zeros_like(th)
    K = np.stack([
        np.stack([zeros, -a[..., 2], a[..., 1]], -1),
        np.stack([a[..., 2], zeros, -a[..., 0]], -1),
        np.stack([-a[..., 1], a[..., 0], zeros], -1)], axis=-2)
    I = np.broadcast_to(np.eye(3), K.shape)
    s = np.where(small, 0.0, np.sin(th))[..., None, None]
    c = np.where(small, 0.0, 1.0 - np.cos(th))[..., None, None]
    R = I + s * K + c * (K @ K)
    # first-order fallback for tiny angles
    Ksmall = np.stack([
        np.stack([zeros, -w[..., 2], w[..., 1]], -1),
        np.stack([w[..., 2], zeros, -w[..., 0]], -1),
        np.stack([-w[..., 1], w[..., 0], zeros], -1)], axis=-2)
    return np.where(small[..., None, None], I + Ksmall, R)
