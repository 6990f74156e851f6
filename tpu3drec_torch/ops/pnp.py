"""PnP: camera pose from 2D-3D correspondences.

Port of `tpu3drec/ops/pnp.py` with a leading batch axis. The minimal
solver is a 12-point DLT on K-normalised rays with an SO(3) projection
and 3 Gauss-Newton steps (an eigh solve each) per hypothesis; the winner
is refined by Gauss-Newton on (rvec, tvec). Jacobians are forward-mode
(`torch.func.jacfwd`), which takes the chosen branch's derivative at
every `where`, as `jax.jacfwd` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from tpu3drec_torch.ops.epipolar import normalize_with_K
from tpu3drec_torch.ops.geometry import eigh, svd
from tpu3drec_torch.ops.lie import exp_so3, log_so3, project_points
from tpu3drec_torch.ops.ransac import ransac


def solve_pnp_dlt(X: torch.Tensor, xn: torch.Tensor,
                  w: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DLT pose from >= 6 points: X (..., N, 3) world, xn (..., N, 2)
    K-normalised. Returns (R, t, valid). Solves x ~ [R|t] X as a 12-dof
    homogeneous system, fixes the sign so most points have positive depth,
    then projects the 3x3 block onto SO(3)."""
    u, v = xn[..., 0:1], xn[..., 1:2]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)            # (..., N, 4)
    zero = torch.zeros_like(Xh)
    rows_a = torch.cat([Xh, zero, -u * Xh], -1)                      # (..., N, 12)
    rows_b = torch.cat([zero, Xh, -v * Xh], -1)
    A = torch.cat([rows_a, rows_b], -2)                              # (..., 2N, 12)
    if w is not None:
        A = A * torch.sqrt(torch.cat([w, w], -1).to(A.dtype))[..., None]
    _, vecs = eigh(A.transpose(-1, -2) @ A)
    p = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 4))
    # the sign that puts most points in front of the camera, chosen before
    # the orthogonalisation (negating R alone would leave SO(3))
    z_raw = (X @ p[..., :3].transpose(-1, -2) + p[..., None, :, 3])[..., 2]
    s = torch.where(torch.sign(z_raw).sum(-1) < 0, -1.0, 1.0)
    p = p * s[..., None, None]
    U, S, Vt = svd(p[..., :3])
    scale = S.mean(-1)
    R = U @ Vt
    det = torch.linalg.det(R)
    t = p[..., 3] / torch.clamp(scale, min=1e-12)[..., None]
    # a det = -1 projection after the sign fix means a degenerate sample
    valid = ((det > 0) & (scale > 1e-9) & torch.isfinite(R).flatten(-2).all(-1)
             & torch.isfinite(t).all(-1))
    return R, t, valid


def _reproj_residual(p, X, uv, K, w):
    """(2N,) masked reprojection residual of pose p = [rvec, tvec]."""
    proj = project_points(X, p[:3], p[3:], K)
    return ((proj - uv) * w[:, None]).reshape(-1)


_reproj_residuals = vmap(_reproj_residual)
_reproj_jacobians = vmap(jacfwd(_reproj_residual))


def refine_pnp_gn(R: torch.Tensor, t: torch.Tensor, X: torch.Tensor,
                  uv: torch.Tensor, K: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  iters: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton on (rvec, tvec) minimising the masked reprojection
    error (cv2.solvePnP ITERATIVE): R (..., 3, 3), t (..., 3), X (..., N, 3),
    uv (..., N, 2), K (..., 3, 3). A step is kept only where it lowers the
    cost."""
    lead = R.shape[:-2]
    if mask is None:
        mask = torch.ones(X.shape[:-1], dtype=torch.bool, device=X.device)
    n = X.shape[-2]
    args = (X.expand(lead + (n, 3)).reshape(-1, n, 3),
            uv.expand(lead + (n, 2)).reshape(-1, n, 2),
            K.expand(lead + (3, 3)).reshape(-1, 3, 3),
            mask.to(X.dtype).expand(lead + (n,)).reshape(-1, n))
    p = torch.cat([log_so3(R), t], -1).reshape(-1, 6)
    eye = 1e-8 * torch.eye(6, dtype=p.dtype, device=p.device)
    for _ in range(iters):
        r = _reproj_residuals(p, *args)
        J = _reproj_jacobians(p, *args)                                 # (B, 2N, 6)
        JtJ = J.transpose(-1, -2) @ J + eye
        dp = torch.linalg.solve_ex(JtJ, -(J.transpose(-1, -2)
                                          @ r[..., None])[..., 0])[0]
        p_new = p + dp
        better = (_reproj_residuals(p_new, *args) ** 2).sum(-1) < (r ** 2).sum(-1)
        p = torch.where(better[:, None], p_new, p)
    p = p.reshape(lead + (6,))
    return exp_so3(p[..., :3]), p[..., 3:]


class PnPResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor
    inlier_ratio: torch.Tensor
    success: torch.Tensor
    mean_reproj_px: torch.Tensor
    # (..., 16 + N): [success, num_inliers, inlier_ratio, mean_reproj_px,
    # R.ravel(), t, inliers], the reference's layout
    packed: Optional[torch.Tensor] = None


def _ray_residual(pp, Xs, xns):
    """(2s,) residual of normalised rays for pose pp = [rvec, tvec]."""
    Xc = Xs @ exp_so3(pp[:3]).T + pp[3:]
    z = torch.where(Xc[:, 2].abs() > 1e-9, Xc[:, 2],
                    torch.full_like(Xc[:, 2], 1e-9))
    return (Xc[:, :2] / z[:, None] - xns).reshape(-1)


_ray_residuals = vmap(_ray_residual)
_ray_jacobians = vmap(jacfwd(_ray_residual))


def _pnp_hypotheses(Xs: torch.Tensor, uvs: torch.Tensor, K: torch.Tensor):
    """RANSAC solver: (B, H, s, 3), (B, H, s, 2) -> ((B, H, 12) models
    [R.ravel(), t], valid). A 12-point DLT plus 3 Gauss-Newton steps on the
    sample, each solved through eigh (LO-RANSAC style): a clean sample
    lands within ~0.1 deg of the true pose."""
    B, Hn, s, _ = Xs.shape
    xns = normalize_with_K(uvs, K[:, None])
    R, t, ok = solve_pnp_dlt(Xs, xns)
    p = torch.cat([log_so3(R), t], -1).reshape(-1, 6)
    Xf, xf = Xs.reshape(-1, s, 3), xns.reshape(-1, s, 2)
    eye = 1e-8 * torch.eye(6, dtype=p.dtype, device=p.device)
    for _ in range(3):
        r = _ray_residuals(p, Xf, xf)
        J = _ray_jacobians(p, Xf, xf)
        JtJ = J.transpose(-1, -2) @ J + eye
        lam, V = eigh(JtJ)
        b = -(J.transpose(-1, -2) @ r[..., None])
        pn = p + (V @ ((V.transpose(-1, -2) @ b)
                       / torch.clamp(lam, min=1e-10)[..., None]))[..., 0]
        better = (_ray_residuals(pn, Xf, xf) ** 2).sum(-1) < (r ** 2).sum(-1)
        p = torch.where(better[:, None], pn, p)
    model = torch.cat([exp_so3(p[:, :3]).reshape(-1, 9), p[:, 3:]], -1)
    return model.reshape(B, Hn, 12), ok


def _pnp_residuals(model, Xall, uvall, K):
    """(B, H, N) squared reprojection errors of (B, H, 12) models; points
    behind the camera score 1e12."""
    R = model[..., :9].reshape(model.shape[:-1] + (3, 3))
    t = model[..., 9:]
    proj = project_points(Xall[:, None], log_so3(R), t, K[:, None])
    z = (Xall[:, None] @ R.transpose(-1, -2) + t[..., None, :])[..., 2]
    err = ((proj - uvall[:, None]) ** 2).sum(-1)
    return torch.where(z > 1e-6, err, torch.full_like(err, 1e12))


def solve_pnp_ransac(X: torch.Tensor, uv: torch.Tensor, K: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     threshold_px: float = 4.0,
                     num_hypotheses: int = 512,
                     refine_iters: int = 8,
                     min_inliers: int = 6,
                     generator: Optional[torch.Generator] = None,
                     u: Optional[torch.Tensor] = None) -> PnPResult:
    """cv2.solvePnPRansac: X (B, N, 3) or (N, 3), uv pixels, K (B, 3, 3) or
    (3, 3). `u` ((num_hypotheses, 12) uniforms) replays given samples,
    else they come from `generator` (seed 0 when None)."""
    single = X.ndim == 2
    if single:
        X, uv = X[None], uv[None]
        mask = None if mask is None else mask[None]
    B, n = X.shape[:2]
    K = K.expand(B, 3, 3)
    if mask is None:
        mask = torch.ones((B, n), dtype=torch.bool, device=X.device)
    res = ransac(X, uv, mask,
                 solver=lambda Xs, uvs: _pnp_hypotheses(Xs, uvs, K),
                 residual_fn=lambda m, a, b: _pnp_residuals(m, a, b, K),
                 sample_size=12, num_hypotheses=num_hypotheses,
                 threshold=threshold_px, min_inliers=min_inliers,
                 generator=generator, u=u)
    R = res.model[:, :9].reshape(B, 3, 3)
    t = res.model[:, 9:]
    R, t = refine_pnp_gn(R, t, X, uv, K, mask=res.inliers, iters=refine_iters)
    # inliers again after the refinement
    proj = project_points(X, log_so3(R), t, K)
    err = torch.linalg.vector_norm(proj - uv, dim=-1)
    z = (X @ R.transpose(-1, -2) + t[:, None, :])[..., 2]
    inl = (err <= threshold_px) & (z > 1e-6) & mask & res.success[:, None]
    num = inl.sum(-1, dtype=torch.int32)
    n_valid = torch.clamp(mask.sum(-1, dtype=torch.int32), min=1)
    w = inl.to(err.dtype)
    mean_err = (err * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0)
    success = res.success & (num >= min_inliers)
    ratio = num / n_valid
    packed = torch.cat([
        torch.stack([success.float(), num.float(), ratio.float(), mean_err], -1),
        R.reshape(B, 9), t, inl.float()], -1)
    out = PnPResult(R=R, t=t, inliers=inl, num_inliers=num,
                    inlier_ratio=ratio, success=success,
                    mean_reproj_px=mean_err, packed=packed)
    return PnPResult(*(v[0] for v in out)) if single else out
