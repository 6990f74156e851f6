"""Two-view projective geometry: homography estimation (the closed-form
4-point solver inside RANSAC and the weighted DLT refit on the inliers)
and the normalised 8-point fundamental matrix with Sampson residuals.

Port of `tpu3drec/ops/geometry.py`. Points are
`(..., N, 2)` float32 pixel coordinates; every function works over any
leading batch dimensions. All arithmetic stays in float32, as in the
reference (TF32 is off, package import).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from tpu3drec_torch.ops.ransac import RansacResult, ransac

_SQRT2 = math.sqrt(2.0)


def to_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def normalize_points(pts: torch.Tensor, mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hartley normalization over the N axis: zero mean, mean distance
    sqrt(2). Returns (pts_n (..., N, 2), T (..., 3, 3))."""
    w = (torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
         if mask is None else mask.to(pts.dtype))
    wsum = torch.clamp(w.sum(-1), min=1e-9)                       # (...)
    mean = (pts * w[..., None]).sum(-2) / wsum[..., None]         # (..., 2)
    centered = pts - mean[..., None, :]
    d = torch.sqrt((centered ** 2).sum(-1))
    mean_d = (d * w).sum(-1) / wsum
    s = _SQRT2 / torch.clamp(mean_d, min=1e-9)
    T = torch.zeros(pts.shape[:-2] + (3, 3), dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 2, 2] = 1.0
    T[..., 0, 2] = -s * mean[..., 0]
    T[..., 1, 2] = -s * mean[..., 1]
    return centered * s[..., None, None], T


def finite_or_zero(M: torch.Tensor) -> torch.Tensor:
    """(..., m, n) matrices with every non-finite matrix replaced by zeros.

    torch's `eigh` and `svd` raise on a non-finite input where the
    reference's return NaN; a degenerate RANSAC sample inside a batch must
    not stop the batch, so each decomposition's input passes through here
    and the caller's validity mask rejects the model."""
    ok = torch.isfinite(M).flatten(-2).all(-1)
    return torch.where(ok[..., None, None], M, torch.zeros_like(M))


def eigh(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`torch.linalg.eigh` (ascending) of `finite_or_zero(M)`."""
    return torch.linalg.eigh(finite_or_zero(M))


def svd(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`torch.linalg.svd` of `finite_or_zero(M)`."""
    return torch.linalg.svd(finite_or_zero(M))


def _nullvec_minimal_qr(A: torch.Tensor) -> torch.Tensor:
    """Exact unit right null vector of (..., n-1, n) matrices by Householder
    QR of A^T (the last column of Q)."""
    m, n = A.shape[-2:]
    R = A.transpose(-1, -2).clone()                               # (..., n, m)
    vs = []
    for k in range(m):
        x = R[..., k:, k]
        nx = torch.linalg.vector_norm(x, dim=-1)
        e1 = torch.zeros_like(x)
        e1[..., 0] = 1.0
        sgn = torch.where(x[..., 0] >= 0, 1.0, -1.0)
        v = x + (sgn * nx)[..., None] * e1
        nv = torch.linalg.vector_norm(v, dim=-1)
        safe = nv > 1e-30
        v = torch.where(safe[..., None],
                        v / torch.where(safe, nv, torch.ones_like(nv))[..., None],
                        e1)
        vs.append(v)
        proj = (v[..., None, :] @ R[..., k:, :])                  # (..., 1, m)
        R = R.clone()
        R[..., k:, :] = R[..., k:, :] - 2.0 * v[..., :, None] * proj
    q = torch.zeros(A.shape[:-2] + (n,), dtype=A.dtype, device=A.device)
    q[..., n - 1] = 1.0
    for k in range(m - 1, -1, -1):
        coef = (vs[k] * q[..., k:]).sum(-1)
        q = q.clone()
        q[..., k:] = q[..., k:] - 2.0 * coef[..., None] * vs[k]
    return q


def _smallest_singular_vector(A: torch.Tensor, refine: bool = True
                              ) -> torch.Tensor:
    """Right singular vector of the smallest singular value of (..., m, n)
    A: exact null vector for m == n - 1, else eigh of A^T A refined by two
    inverse-iteration steps."""
    m, n = A.shape[-2:]
    if m == n - 1:
        return _nullvec_minimal_qr(A)
    AtA = A.transpose(-1, -2) @ A
    _, vecs = eigh(AtA)                                           # ascending
    v = vecs[..., :, 0]
    if not refine:
        return v
    ridge = 1e-7 * torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1) / n
    M = AtA + ridge[..., None, None] * torch.eye(n, dtype=A.dtype, device=A.device)
    for _ in range(2):
        # solve_ex: a singular system gives non-finite values that the
        # caller's validity mask rejects, where solve would raise (and sync)
        v = torch.linalg.solve_ex(M, v)[0]
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            min=1e-30)
    return v


def _similarity_inv(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a normalize_points similarity."""
    inv_s = 1.0 / T[..., 0, 0]
    out = torch.zeros_like(T)
    out[..., 0, 0] = inv_s
    out[..., 1, 1] = inv_s
    out[..., 2, 2] = 1.0
    out[..., 0, 2] = -T[..., 0, 2] * inv_s
    out[..., 1, 2] = -T[..., 1, 2] * inv_s
    return out


def solve_homography_dlt(p1: torch.Tensor, p2: torch.Tensor,
                         w: Optional[torch.Tensor] = None,
                         fast: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DLT homography p1 -> p2 from >= 4 (optionally weighted)
    correspondences. Returns (H (..., 3, 3), valid (...))."""
    p1n, T1 = normalize_points(p1, w)
    p2n, T2 = normalize_points(p2, w)
    x, y = p1n[..., 0], p1n[..., 1]
    u, v = p2n[..., 0], p2n[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    rows_a = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], -1)
    rows_b = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    A = torch.cat([rows_a, rows_b], dim=-2)                        # (..., 2n, 9)
    if w is not None:
        ww = torch.sqrt(torch.cat([w, w], dim=-1).to(A.dtype))
        A = A * ww[..., None]
    h = _smallest_singular_vector(A, refine=not fast)
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    H = _similarity_inv(T2) @ Hn @ T1
    scale = H[..., 2, 2]
    valid = scale.abs() > 1e-10
    H = H / torch.where(valid, scale, torch.ones_like(scale))[..., None, None]
    return H, valid & torch.isfinite(H).flatten(-2).all(-1)


def homography_transfer_error(H: torch.Tensor, pts1: torch.Tensor,
                              pts2: torch.Tensor) -> torch.Tensor:
    """(..., N) squared forward transfer error |H p1 - p2|^2."""
    p = to_homogeneous(pts1) @ H.transpose(-1, -2)
    z = p[..., 2]
    bad = z.abs() < 1e-10
    proj = p[..., :2] / torch.where(bad, torch.ones_like(z), z)[..., None]
    err = ((proj - pts2) ** 2).sum(-1)
    return torch.where(bad, torch.full_like(err, 1e12), err)


def _adj3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate of (..., 3, 3) matrices (the inverse up to
    1/det, which is all a projective quantity needs)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], -2)


def _homography_4pt_closed(p1: torch.Tensor, p2: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact minimal 4-point homography by the projective-basis method in
    matrix form: B maps e1, e2, e3, e1+e2+e3 to the 4 points (columns
    lambda_i p_i, lambda = adj(M) p4), so H = B2 adj(B1). p1, p2
    (..., 4, 2) -> (H (..., 3, 3), valid). `_homography_4pt_flat` is the
    same math written out as scalar formulas."""
    p1n, T1 = normalize_points(p1)
    p2n, T2 = normalize_points(p2)

    def basis(p):
        ph = to_homogeneous(p)
        M = ph[..., :3, :].transpose(-1, -2)                  # columns p1..p3
        lam = (_adj3(M) @ ph[..., 3, :, None])[..., 0]        # ~ det(M) M^-1 p4
        return M * lam[..., None, :], lam

    B1, lam1 = basis(p1n)
    B2, lam2 = basis(p2n)
    H = _similarity_inv(T2) @ (B2 @ _adj3(B1)) @ T1
    scale = H[..., 2, 2]
    ok = ((lam1.abs().amin(-1) > 1e-12) & (lam2.abs().amin(-1) > 1e-12)
          & (scale.abs() > 1e-12))
    H = H / torch.where(ok, scale, torch.ones_like(scale))[..., None, None]
    return H, ok & torch.isfinite(H).flatten(-2).all(-1)


def _homography_4pt_flat(p1: torch.Tensor, p2: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact minimal 4-point homography (projective-basis method, written
    out as scalar formulas): p1, p2 (..., 4, 2) -> (h (..., 9), valid)."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]

    def norm4(x, y):
        mx = 0.25 * x.sum(-1, keepdim=True)
        my = 0.25 * y.sum(-1, keepdim=True)
        cx = x - mx
        cy = y - my
        md = 0.25 * torch.sqrt(cx * cx + cy * cy).sum(-1, keepdim=True)
        s = _SQRT2 / torch.clamp(md, min=1e-9)
        return cx * s, cy * s, s[..., 0], mx[..., 0], my[..., 0]

    x, y, s1, mx1, my1 = norm4(x, y)
    u, v, s2, mx2, my2 = norm4(u, v)

    def basis(px, py):
        x1, x2, x3, x4 = px.unbind(-1)
        y1, y2, y3, y4 = py.unbind(-1)
        l1 = (y2 - y3) * x4 + (x3 - x2) * y4 + (x2 * y3 - x3 * y2)
        l2 = (y3 - y1) * x4 + (x1 - x3) * y4 + (x3 * y1 - x1 * y3)
        l3 = (y1 - y2) * x4 + (x2 - x1) * y4 + (x1 * y2 - x2 * y1)
        return (l1 * x1, l2 * x2, l3 * x3,
                l1 * y1, l2 * y2, l3 * y3,
                l1, l2, l3), (l1, l2, l3)

    B1, lam1 = basis(x, y)
    B2, lam2 = basis(u, v)
    a, b, c, d, e, f, g, h_, i = B1
    A00 = e * i - f * h_
    A01 = c * h_ - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h_ - e * g
    A21 = b * g - a * h_
    A22 = a * e - b * d
    p, q, r, t, w, z, m, n, o = B2
    H00 = p * A00 + q * A10 + r * A20
    H01 = p * A01 + q * A11 + r * A21
    H02 = p * A02 + q * A12 + r * A22
    H10 = t * A00 + w * A10 + z * A20
    H11 = t * A01 + w * A11 + z * A21
    H12 = t * A02 + w * A12 + z * A22
    H20 = m * A00 + n * A10 + o * A20
    H21 = m * A01 + n * A11 + o * A21
    H22 = m * A02 + n * A12 + o * A22
    inv_s2 = 1.0 / s2
    G00 = H00 * inv_s2 + mx2 * H20
    G01 = H01 * inv_s2 + mx2 * H21
    G02 = H02 * inv_s2 + mx2 * H22
    G10 = H10 * inv_s2 + my2 * H20
    G11 = H11 * inv_s2 + my2 * H21
    G12 = H12 * inv_s2 + my2 * H22
    t02 = -s1 * mx1
    t12 = -s1 * my1
    F00 = G00 * s1
    F01 = G01 * s1
    F02 = G00 * t02 + G01 * t12 + G02
    F10 = G10 * s1
    F11 = G11 * s1
    F12 = G10 * t02 + G11 * t12 + G12
    F20 = H20 * s1
    F21 = H21 * s1
    F22 = H20 * t02 + H21 * t12 + H22

    lam_min = torch.stack([lam1[0].abs(), lam1[1].abs(), lam1[2].abs(),
                           lam2[0].abs(), lam2[1].abs(), lam2[2].abs()],
                          -1).amin(-1)
    ok = (lam_min > 1e-12) & (F22.abs() > 1e-12)
    inv = torch.where(ok, 1.0 / torch.where(ok, F22, torch.ones_like(F22)),
                      torch.ones_like(F22))
    hv = torch.stack([F00, F01, F02, F10, F11, F12, F20, F21, F22], -1) \
        * inv[..., None]
    return hv, ok & torch.isfinite(hv).all(-1)


def _homography_transfer_error_flat(hv: torch.Tensor, pts1: torch.Tensor,
                                    pts2: torch.Tensor) -> torch.Tensor:
    """Transfer error of flat models: hv (B, K, 9), pts (B, N, 2) ->
    (B, K, N)."""
    x = pts1[..., None, :, 0]
    y = pts1[..., None, :, 1]
    h = [hv[..., j, None] for j in range(9)]
    px = h[0] * x + h[1] * y + h[2]
    py = h[3] * x + h[4] * y + h[5]
    z = h[6] * x + h[7] * y + h[8]
    bad = z.abs() < 1e-10
    zi = 1.0 / torch.where(bad, torch.ones_like(z), z)
    ex = px * zi - pts2[..., None, :, 0]
    ey = py * zi - pts2[..., None, :, 1]
    return torch.where(bad, torch.full_like(z, 1e12), ex * ex + ey * ey)


def find_homography(pts1: torch.Tensor, pts2: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    threshold: float = 4.0,
                    num_hypotheses: int = 512,
                    generator: Optional[torch.Generator] = None,
                    refit: bool = True,
                    u: Optional[torch.Tensor] = None) -> RansacResult:
    """RANSAC homography (cv2.findHomography(RANSAC) equivalent) over
    (N, 2) or (B, N, 2) points; `u` injects the (K, 4) uniforms."""
    single = pts1.ndim == 2
    if single:
        pts1, pts2 = pts1[None], pts2[None]
        mask = None if mask is None else mask[None]
    if mask is None:
        mask = torch.ones(pts1.shape[:2], dtype=torch.bool, device=pts1.device)
    result = ransac(pts1, pts2, mask, solver=_homography_4pt_flat,
                    residual_fn=_homography_transfer_error_flat,
                    sample_size=4, num_hypotheses=num_hypotheses,
                    threshold=threshold, generator=generator, u=u)
    result = result._replace(model=result.model.reshape(-1, 3, 3))
    if refit:
        H2, ok = solve_homography_dlt(pts1, pts2,
                                      result.inliers.to(pts1.dtype))
        res2 = homography_transfer_error(H2, pts1, pts2)
        inl2 = (res2 <= threshold ** 2) & mask
        better = ok & (inl2.sum(-1) >= result.num_inliers) & result.success
        model = torch.where(better[:, None, None], H2, result.model)
        inliers = torch.where(better[:, None], inl2, result.inliers)
        n_valid = torch.clamp(mask.sum(-1, dtype=torch.int32), min=1)
        num = inliers.sum(-1, dtype=torch.int32)
        result = result._replace(
            model=model, inliers=inliers, num_inliers=num,
            inlier_ratio=num / n_valid,
            residuals=torch.where(better[:, None], res2, result.residuals))
    if single:
        result = RansacResult(*(t[0] for t in result))
    return result


def solve_fundamental_8pt(p1: torch.Tensor, p2: torch.Tensor,
                          w: Optional[torch.Tensor] = None,
                          fast: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalised 8-point fundamental matrix (p2^T F p1 = 0) from (..., N, 2)
    points, optionally weighted. Returns (F (..., 3, 3), valid (...)).

    fast=True (the RANSAC hypothesis path) skips the eigenvector polish
    and the rank-2 projection: minimal-sample solutions only score
    inliers, and the refit enforces both."""
    p1n, T1 = normalize_points(p1, w)
    p2n, T2 = normalize_points(p2, w)
    x, y = p1n[..., 0], p1n[..., 1]
    u, v = p2n[..., 0], p2n[..., 1]
    one = torch.ones_like(x)
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, one], -1)
    if w is not None:
        A = A * torch.sqrt(w.to(A.dtype))[..., None]
    f = _smallest_singular_vector(A, refine=not fast)
    Fn = f.reshape(f.shape[:-1] + (3, 3))
    if not fast:
        U, S, Vt = svd(Fn)
        S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
        Fn = (U * S[..., None, :]) @ Vt
    F = T2.transpose(-1, -2) @ Fn @ T1
    norm = torch.linalg.matrix_norm(F)
    valid = norm > 1e-12
    F = F / torch.where(valid, norm, torch.ones_like(norm))[..., None, None]
    return F, valid & torch.isfinite(F).flatten(-2).all(-1)


def sampson_error(F: torch.Tensor, pts1: torch.Tensor,
                  pts2: torch.Tensor) -> torch.Tensor:
    """(..., N) first-order (Sampson) squared epipolar error: F (..., 3, 3)
    and pts (..., N, 2) broadcast over their leading dimensions."""
    x1 = to_homogeneous(pts1)
    x2 = to_homogeneous(pts2)
    Fx1 = x1 @ F.transpose(-1, -2)        # F @ x1
    Ftx2 = x2 @ F                         # F^T @ x2
    num = (x2 * Fx1).sum(-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 \
        + Ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _f_solver(p1, p2):
    return solve_fundamental_8pt(p1, p2, fast=True)


def _sampson_residuals(F: torch.Tensor, pts1: torch.Tensor,
                       pts2: torch.Tensor) -> torch.Tensor:
    """RANSAC residual_fn: models (B, K, 3, 3), points (B, N, 2) ->
    (B, K, N)."""
    return sampson_error(F, pts1[:, None], pts2[:, None])


def find_fundamental(pts1: torch.Tensor, pts2: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     threshold: float = 3.0,
                     num_hypotheses: int = 512,
                     generator: Optional[torch.Generator] = None,
                     refit: bool = True,
                     u: Optional[torch.Tensor] = None) -> RansacResult:
    """RANSAC fundamental matrix (cv2.findFundamentalMat equivalent) over
    (N, 2) or (B, N, 2) points; `u` injects the (K, 8) uniforms."""
    single = pts1.ndim == 2
    if single:
        pts1, pts2 = pts1[None], pts2[None]
        mask = None if mask is None else mask[None]
    if mask is None:
        mask = torch.ones(pts1.shape[:2], dtype=torch.bool, device=pts1.device)
    result = ransac(pts1, pts2, mask, solver=_f_solver,
                    residual_fn=_sampson_residuals, sample_size=8,
                    num_hypotheses=num_hypotheses, threshold=threshold,
                    generator=generator, u=u)
    if refit:
        F2, ok = solve_fundamental_8pt(pts1, pts2,
                                       result.inliers.to(pts1.dtype))
        res2 = sampson_error(F2, pts1, pts2)
        inl2 = (res2 <= threshold ** 2) & mask
        better = ok & (inl2.sum(-1) >= result.num_inliers) & result.success
        n_valid = torch.clamp(mask.sum(-1, dtype=torch.int32), min=1)
        inliers = torch.where(better[:, None], inl2, result.inliers)
        num = inliers.sum(-1, dtype=torch.int32)
        result = result._replace(
            model=torch.where(better[:, None, None], F2, result.model),
            inliers=inliers, num_inliers=num, inlier_ratio=num / n_valid,
            residuals=torch.where(better[:, None], res2, result.residuals))
    if single:
        result = RansacResult(*(t[0] for t in result))
    return result


def reprojection_error_homography(H: torch.Tensor, pts1: torch.Tensor,
                                  pts2: torch.Tensor,
                                  mask: torch.Tensor) -> torch.Tensor:
    """Mean reprojection error over valid matches."""
    err = torch.sqrt(homography_transfer_error(H, pts1, pts2))
    w = mask.to(err.dtype)
    return (err * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0)
