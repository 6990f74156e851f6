"""Triangulation: batched DLT, epipolar (Sampson / exact Hartley-Sturm)
correction, the 4-stage quality filter and per-point Gauss-Newton.

Port of `tpu3drec/ops/triangulate.py`. Points are (..., N, 2) and cameras
(..., 3, 3) / (..., 3) / (..., 3, 4) with matching leading dimensions,
so a batch of pairs runs in one call. The Hartley-Sturm degree-6
polynomial is rooted with the reference's tan-grid bracketing and a fixed
number of bisection steps, not a companion-matrix eigensolver.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from tpu3drec_torch.ops.geometry import eigh, to_homogeneous
from tpu3drec_torch.ops.lie import compose_projection, hat


class TriangulationConfig(NamedTuple):
    """The reference's TriangulationConfig defaults."""
    min_angle_deg: float = 2.0
    max_reproj_px: float = 2.0
    min_depth: float = 1e-3
    max_depth: float = 1e4
    # "hartley_sturm" = exact optimal correction; "sampson" = first-order
    # step; "none"
    correction: str = "hartley_sturm"
    use_sampson_correction: bool = True  # master switch
    refine_iters: int = 3


def sampson_correct(pts1: torch.Tensor, pts2: torch.Tensor,
                    F: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-order optimal correction of (..., N, 2) correspondences onto
    x2' F x1 = 0, F (..., 3, 3)."""
    x1 = to_homogeneous(pts1)
    x2 = to_homogeneous(pts2)
    Fx1 = x1 @ F.transpose(-1, -2)
    Ftx2 = x2 @ F
    err = (x2 * Fx1).sum(-1)
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 \
        + Ftx2[..., 1] ** 2
    lam = (err / torch.clamp(den, min=1e-12))[..., None]
    return pts1 - lam * Ftx2[..., :2], pts2 - lam * Fx1[..., :2]


def _null3(A: torch.Tensor) -> torch.Tensor:
    """Null direction of rank-2 (..., 3, 3) A refined to float32 accuracy
    by 3 inverse-iteration steps with the closed-form adjugate."""
    M = A.transpose(-1, -2) @ A
    _, vecs = eigh(M)
    v = vecs[..., :, 0]
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    B = M + (1e-12 + 1e-6 * tr)[..., None, None] * torch.eye(
        3, dtype=M.dtype, device=M.device)
    c0 = torch.linalg.cross(B[..., :, 1], B[..., :, 2])
    c1 = torch.linalg.cross(B[..., :, 2], B[..., :, 0])
    c2 = torch.linalg.cross(B[..., :, 0], B[..., :, 1])
    adj = torch.stack([c0, c1, c2], -2)                         # adj(B) rows
    for _ in range(3):
        v = (adj @ v[..., None])[..., 0]
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            min=1e-30)
    return v


def _hs_points(p1, p2, F, e1g, e2g, n_grid: int = 64, n_bisect: int = 30):
    """Exact Hartley-Sturm correction (Hartley & Zisserman 12.5.2) of
    (..., N, 2) points given the pair's epipoles e1g = null(F),
    e2g = null(F^T) (..., 3). Every point's degree-6 polynomial g(t) is
    bracketed on a tan grid and bisected; the root of least cost wins
    unless t -> inf costs less."""
    F = F[..., None, :, :]
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    # Fm = T2^-T F T1^-1, T = [[1,0,-p],[0,1,-q],[0,0,1]], closed form
    inv_T1 = torch.stack([torch.stack([one, zero, x], -1),
                          torch.stack([zero, one, y], -1),
                          torch.stack([zero, zero, one], -1)], -2)
    inv_T2t = torch.stack([torch.stack([one, zero, zero], -1),
                           torch.stack([zero, one, zero], -1),
                           torch.stack([u, v, one], -1)], -2)
    Fm = inv_T2t @ F @ inv_T1

    def epipole(eg, px, py):
        e = torch.stack([eg[..., None, 0] - px * eg[..., None, 2],
                         eg[..., None, 1] - py * eg[..., None, 2],
                         eg[..., None, 2].expand_as(px)], -1)
        return e / torch.clamp(torch.sqrt(e[..., 0] ** 2 + e[..., 1] ** 2),
                               min=1e-12)[..., None]

    def rot(e):
        return torch.stack([torch.stack([e[..., 0], e[..., 1], zero], -1),
                            torch.stack([-e[..., 1], e[..., 0], zero], -1),
                            torch.stack([zero, zero, one], -1)], -2)

    e1 = epipole(e1g, x, y)
    e2 = epipole(e2g, u, v)
    R1, R2 = rot(e1), rot(e2)
    Fr = R2 @ Fm @ R1.transpose(-1, -2)
    f1, f2 = e1[..., 2:3], e2[..., 2:3]
    a, b = Fr[..., 1, 1, None], Fr[..., 1, 2, None]
    c, d = Fr[..., 2, 1, None], Fr[..., 2, 2, None]

    def g(t):
        return (t * ((a * t + b) ** 2 + f2 ** 2 * (c * t + d) ** 2) ** 2
                - (a * d - b * c) * (1 + f1 ** 2 * t ** 2) ** 2
                * (a * t + b) * (c * t + d))

    def s_cost(t):
        return (t ** 2 / (1 + f1 ** 2 * t ** 2)
                + (c * t + d) ** 2
                / torch.clamp((a * t + b) ** 2 + f2 ** 2 * (c * t + d) ** 2,
                              min=1e-30))

    theta = torch.linspace(-math.pi / 2 + 1e-3, math.pi / 2 - 1e-3, n_grid,
                           dtype=p1.dtype, device=p1.device)
    ts = torch.tan(theta)
    gs = g(ts)
    sign_change = gs[..., :-1] * gs[..., 1:] <= 0
    lo = ts[:-1].expand(gs.shape[:-1] + (n_grid - 1,))
    hi = ts[1:].expand_as(lo)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        left = g(lo) * g(mid) <= 0
        lo, hi = torch.where(left, lo, mid), torch.where(left, mid, hi)
    roots = 0.5 * (lo + hi)
    costs = torch.where(sign_change, s_cost(roots),
                        torch.full_like(roots, math.inf))
    best = torch.argmin(costs, dim=-1, keepdim=True)
    t_best = roots.gather(-1, best)[..., 0]
    a, b, c, d = a[..., 0], b[..., 0], c[..., 0], d[..., 0]
    f1, f2 = f1[..., 0], f2[..., 0]
    cost_inf = 1.0 / f1 ** 2 + c ** 2 / torch.clamp(a ** 2 + f2 ** 2 * c ** 2,
                                                    min=1e-30)
    use_inf = (cost_inf < costs.amin(-1))[..., None]

    def closest_on_line(lam, mu, nu):
        return torch.stack([-lam * nu, -mu * nu, lam ** 2 + mu ** 2], -1)

    x1h = torch.where(use_inf, closest_on_line(f1, zero, -one),
                      closest_on_line(t_best * f1, one, -t_best))
    x2h = torch.where(use_inf, closest_on_line(-f2 * c, a, c),
                      closest_on_line(-f2 * (c * t_best + d), a * t_best + b,
                                      c * t_best + d))
    # undo the rotations and translations
    x1h = (inv_T1 @ (R1.transpose(-1, -2) @ x1h[..., None]))[..., 0]
    x2h = (inv_T2t.transpose(-1, -2) @ (R2.transpose(-1, -2)
                                        @ x2h[..., None]))[..., 0]

    def dehom(h):
        w = torch.where(h[..., 2].abs() > 1e-12, h[..., 2], one)
        return h[..., :2] / w[..., None]

    return dehom(x1h), dehom(x2h)


def hartley_sturm_correct(pts1: torch.Tensor, pts2: torch.Tensor,
                          F: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact optimal correction of (..., N, 2) correspondences onto
    x2' F x1 = 0, F (..., 3, 3). A point whose correction is not finite
    (degenerate geometry) keeps its input."""
    e1g = _null3(F)
    e2g = _null3(F.transpose(-1, -2))
    c1, c2 = _hs_points(pts1, pts2, F, e1g, e2g)
    bad = (~torch.isfinite(c1).all(-1)) | (~torch.isfinite(c2).all(-1))
    return (torch.where(bad[..., None], pts1, c1),
            torch.where(bad[..., None], pts2, c2))


def _dlt_rows(pts: torch.Tensor, Ps: torch.Tensor) -> torch.Tensor:
    """(..., 2V, 4) DLT rows of points (..., V, 2) in cameras (..., V, 3, 4)."""
    a = pts[..., 0:1] * Ps[..., 2, :] - Ps[..., 0, :]
    b = pts[..., 1:2] * Ps[..., 2, :] - Ps[..., 1, :]
    return torch.cat([a, b], -2)


def _dehomogenize(Xh: torch.Tensor) -> torch.Tensor:
    w = Xh[..., 3:4]
    return Xh[..., :3] / torch.where(w.abs() > 1e-12, w, torch.ones_like(w))


def triangulate_points(pts1: torch.Tensor, pts2: torch.Tensor,
                       P1: torch.Tensor, P2: torch.Tensor) -> torch.Tensor:
    """Two-view DLT: (..., N, 2) points, (..., 3, 4) cameras -> (..., N, 3)
    world points, one 4x4 symmetric eigensolve a point."""
    pts = torch.stack([pts1, pts2], -2)                         # (..., N, 2, 2)
    Ps = torch.stack([P1, P2], -3)[..., None, :, :, :]          # (..., 1, 2, 3, 4)
    A = _dlt_rows(pts, Ps)
    rows = torch.stack([A[..., 0, :], A[..., 2, :], A[..., 1, :], A[..., 3, :]], -2)
    _, v = eigh(rows.transpose(-1, -2) @ rows)
    return _dehomogenize(v[..., :, 0])


def triangulate_multiview(pts: torch.Tensor, Ps: torch.Tensor,
                          view_mask: torch.Tensor) -> torch.Tensor:
    """Points from V >= 2 masked views: (..., V, 2), (..., V, 3, 4),
    (..., V) -> (..., 3). Masked views contribute zero rows."""
    A = _dlt_rows(pts, Ps)                                      # (..., 2V, 4)
    m = torch.cat([view_mask, view_mask], -1).to(A.dtype)[..., None]
    A = A * m
    _, v = eigh(A.transpose(-1, -2) @ A)
    return _dehomogenize(v[..., :, 0])


class TriangulationResult(NamedTuple):
    points: torch.Tensor       # (..., N, 3)
    mask: torch.Tensor         # (..., N) passed all filters
    reproj_err: torch.Tensor   # (..., N) mean two-view reprojection error (px)
    angles_deg: torch.Tensor   # (..., N) triangulation angle
    depths1: torch.Tensor      # (..., N)
    depths2: torch.Tensor      # (..., N)


def _depths(X, R, t):
    return (X @ R.transpose(-1, -2) + t[..., None, :])[..., 2]


def _reproject(X, P):
    p = to_homogeneous(X) @ P.transpose(-1, -2)
    z = p[..., 2:3]
    return p[..., :2] / torch.where(z.abs() > 1e-12, z, torch.ones_like(z))


def triangulation_angles(X: torch.Tensor, c1: torch.Tensor,
                         c2: torch.Tensor) -> torch.Tensor:
    """(..., N) angle between the two viewing rays in degrees; camera
    centres (..., 3)."""
    r1 = X - c1[..., None, :]
    r2 = X - c2[..., None, :]
    cos = (r1 * r2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(r1, dim=-1)
        * torch.linalg.vector_norm(r2, dim=-1), min=1e-12)
    return torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))


def triangulate_two_view(pts1: torch.Tensor, pts2: torch.Tensor,
                         K1: torch.Tensor, K2: torch.Tensor,
                         R1: torch.Tensor, t1: torch.Tensor,
                         R2: torch.Tensor, t2: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         config: TriangulationConfig = TriangulationConfig(),
                         depth_bounds: Optional[Tuple[torch.Tensor,
                                                      torch.Tensor]] = None,
                         ) -> TriangulationResult:
    """Two-view triangulation with the reference's 4-stage filter
    (cheirality, parallax angle, reprojection, depth bounds). Cameras may
    carry leading batch dimensions matching the points'. `depth_bounds`
    optionally replaces (config.min_depth, config.max_depth)."""
    if mask is None:
        mask = torch.ones(pts1.shape[:-1], dtype=torch.bool, device=pts1.device)
    P1 = compose_projection(K1, R1, t1)
    P2 = compose_projection(K2, R2, t2)

    p1c, p2c = pts1, pts2
    if config.use_sampson_correction and config.correction != "none":
        # F = K2^-T [t]x R K1^-1 of the relative pose camera 1 -> camera 2
        R_rel = R2 @ R1.transpose(-1, -2)
        t_rel = t2 - (R_rel @ t1[..., None])[..., 0]
        F = (torch.linalg.inv_ex(K2)[0].transpose(-1, -2) @ hat(t_rel)
             @ R_rel @ torch.linalg.inv_ex(K1)[0])
        if config.correction == "hartley_sturm":
            p1c, p2c = hartley_sturm_correct(pts1, pts2, F)
        else:
            p1c, p2c = sampson_correct(pts1, pts2, F)

    X = triangulate_points(p1c, p2c, P1, P2)
    if config.refine_iters > 0:
        X = refine_points_gn(X, p1c, p2c, P1, P2, iters=config.refine_iters)

    d1 = _depths(X, R1, t1)
    d2 = _depths(X, R2, t2)
    e1 = torch.linalg.vector_norm(_reproject(X, P1) - pts1, dim=-1)
    e2 = torch.linalg.vector_norm(_reproject(X, P2) - pts2, dim=-1)
    c1 = -(R1.transpose(-1, -2) @ t1[..., None])[..., 0]
    c2 = -(R2.transpose(-1, -2) @ t2[..., None])[..., 0]
    ang = triangulation_angles(X, c1, c2)

    if depth_bounds is None:
        lo = torch.tensor(config.min_depth, dtype=torch.float32)
        hi = torch.tensor(config.max_depth, dtype=torch.float32)
    else:
        lo, hi = (torch.as_tensor(b, dtype=torch.float32) for b in depth_bounds)
    lo, hi = lo.to(X.device), hi.to(X.device)
    if lo.ndim:
        lo, hi = lo[..., None], hi[..., None]
    ok = mask & (d1 > lo) & (d2 > lo)                             # cheirality
    ok = ok & (ang >= config.min_angle_deg)                       # parallax
    ok = ok & (torch.maximum(e1, e2) <= config.max_reproj_px)     # reprojection
    ok = ok & (d1 < hi) & (d2 < hi)                               # bounds
    ok = ok & torch.isfinite(X).all(-1)
    return TriangulationResult(points=X, mask=ok, reproj_err=0.5 * (e1 + e2),
                               angles_deg=ang, depths1=d1, depths2=d2)


def _two_view_residual(x, p1, p2, P1, P2):
    """(4,) reprojection residual of one point x (3,) in two cameras."""
    xh = torch.cat([x, torch.ones_like(x[:1])])
    a = P1 @ xh
    b = P2 @ xh
    ra = a[:2] / torch.where(a[2].abs() > 1e-12, a[2], torch.ones_like(a[2])) - p1
    rb = b[:2] / torch.where(b[2].abs() > 1e-12, b[2], torch.ones_like(b[2])) - p2
    return torch.cat([ra, rb])


_point_residuals = vmap(_two_view_residual)
_point_jacobians = vmap(jacfwd(_two_view_residual))


def refine_points_gn(X: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor,
                     P1: torch.Tensor, P2: torch.Tensor,
                     iters: int = 3) -> torch.Tensor:
    """Fixed-iteration Gauss-Newton on each point's two-view reprojection
    error: X (..., N, 3), pts (..., N, 2), cameras (..., 3, 4). A step is
    kept only where it lowers the point's cost."""
    lead = X.shape[:-1]
    cams = [P[..., None, :, :].expand(lead + (3, 4)).reshape(-1, 3, 4)
            for P in (P1, P2)]
    x = X.reshape(-1, 3)
    p1 = pts1.reshape(-1, 2)
    p2 = pts2.reshape(-1, 2)
    eye = 1e-6 * torch.eye(3, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        r = _point_residuals(x, p1, p2, *cams)                   # (M, 4)
        J = _point_jacobians(x, p1, p2, *cams)                   # (M, 4, 3)
        JtJ = J.transpose(-1, -2) @ J + eye
        dx = torch.linalg.solve_ex(JtJ, -(J.transpose(-1, -2)
                                          @ r[..., None])[..., 0])[0]
        x_new = x + dx
        better = ((_point_residuals(x_new, p1, p2, *cams) ** 2).sum(-1)
                  < (r ** 2).sum(-1))
        x = torch.where(better[:, None], x_new, x)
    return x.reshape(lead + (3,))
