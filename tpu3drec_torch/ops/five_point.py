"""Nister/Stewenius 5-point essential-matrix minimal solver.

Port of `tpu3drec/ops/five_point.py`, batched over any leading
dimensions. The algorithm is the reference's, not a general eigensolver:

1. Null space of the 5x9 epipolar constraint matrix from `eigh` (the 4
   smallest eigenvectors) -> E(x, y, z) = x X + y Y + z Z + W.
2. The ten cubic constraints (det E = 0, 2 E E^T E - tr(E E^T) E = 0)
   expanded over the 20 monomials of degree <= 3 numerically: evaluated
   at 20 fixed generic points and multiplied by the inverse Vandermonde
   matrix (numpy constants built at import, as in the reference).
3. A linear solve against the 10 leading monomials gives the 10x10 action
   matrix A of multiplication by z on the quotient basis
   [x^2, xy, xz, y^2, yz, z^2, x, y, z, 1].
4. Real eigenvalues of A (the solutions' z) as sign changes of
   p(z) = det(A - z I) on a tan-spaced grid over all of R: A is reduced
   once to Hessenberg form and p's sign comes from Hyman's recurrence;
   48 bisection steps, then 2 Newton steps with
   p'(z) / p(z) = -tr((A - z I)^-1).
5. Eigenvectors by shifted inverse iteration; x, y read off the vector;
   E assembled and projected onto the essential manifold.

Every linear solve is a `_ex` variant: a degenerate sample gives
non-finite values that the validity mask rejects instead of raising.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from tpu3drec_torch.ops.geometry import eigh, svd, to_homogeneous

# exponents (i, j, k) of x^i y^j z^k: the leading block L (the degree-3
# monomials eliminated), then the quotient basis B
_L_MONOMIALS = [(3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0),
                (2, 0, 1), (1, 1, 1), (1, 0, 2), (0, 2, 1),
                (0, 1, 2), (0, 0, 3)]
_B_MONOMIALS = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
                (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_MONOMIALS = _L_MONOMIALS + _B_MONOMIALS  # 20

_rng = np.random.default_rng(561)
_GEN_PTS = _rng.normal(0.0, 1.0, size=(20, 3))
_VAND = np.stack([[pt[0] ** i * pt[1] ** j * pt[2] ** k
                   for (i, j, k) in _MONOMIALS] for pt in _GEN_PTS])
_VAND_INV = np.linalg.inv(_VAND)  # cond ~1e4 at this seed, fine in float64
GEN_PTS = _GEN_PTS.astype(np.float32)
VAND_INV_T = _VAND_INV.T.astype(np.float32).copy()

# index of x, y, 1 within the B basis (solution extraction)
_BX, _BY, _B1 = 6, 7, 9
# z * B[i] for i in 0..5 lands on the leading monomial L[_ZB_TO_L[i]]
_ZB_TO_L = [4, 5, 6, 7, 8, 9]
# z * B[i] for i in 6..9 lands back inside B at these indices
_ZB_TO_B = {6: 2, 7: 4, 8: 5, 9: 8}

N_ROOTS = 10
_GRID_N = 1024
_BISECT_ITERS = 48


def _constraints_at(E: torch.Tensor) -> torch.Tensor:
    """(..., 10) constraint values of (..., 3, 3) E candidates."""
    det = torch.linalg.det(E)
    EEt = E @ E.transpose(-1, -2)
    tr = torch.diagonal(EEt, dim1=-2, dim2=-1).sum(-1)
    C = 2.0 * (EEt @ E) - tr[..., None, None] * E
    return torch.cat([det[..., None], C.flatten(-2)], -1)


def _hessenberg(A: torch.Tensor) -> torch.Tensor:
    """Orthogonal reduction of (..., n, n) to upper Hessenberg form
    (unrolled Householder steps; a similarity, so det(H - zI) equals
    det(A - zI))."""
    n = A.shape[-1]
    H = A.clone()
    for k in range(n - 2):
        x = H[..., k + 1:, k]
        nx = torch.linalg.vector_norm(x, dim=-1)
        e1 = torch.zeros_like(x)
        e1[..., 0] = 1.0
        sgn = torch.where(x[..., 0] >= 0, 1.0, -1.0)
        v = x + (sgn * nx)[..., None] * e1
        nv = torch.linalg.vector_norm(v, dim=-1)
        safe = nv > 1e-30
        v = torch.where(safe[..., None],
                        v / torch.where(safe, nv, torch.ones_like(nv))[..., None],
                        torch.zeros_like(v))
        rows = H[..., k + 1:, :]
        H[..., k + 1:, :] = rows - 2.0 * v[..., :, None] * (
            v[..., None, :] @ rows)
        cols = H[..., :, k + 1:]
        H[..., :, k + 1:] = cols - 2.0 * (cols @ v[..., :, None]) * v[..., None, :]
    return H


def _hyman_signvals(H: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Sign-faithful det(H - z I) of upper-Hessenberg H (..., n, n) at the
    shifts z (..., G) by Hyman's method: fix x_{n-1} = 1, solve rows
    n-1..1 backward for x_{i-1} (one unknown times the subdiagonal b_i),
    then row 0 gives alpha with det = (-1)^(n-1) alpha prod(b_i). The
    positive per-shift rescaling (overflow guard) and the constant factors
    keep every sign, which is all bracketing and bisection use."""
    n = H.shape[-1]
    b = torch.diagonal(H, offset=-1, dim1=-2, dim2=-1)            # (..., n-1)
    bsafe = torch.where(b.abs() > 1e-25, b,
                        torch.where(b >= 0, 1e-25, -1e-25))
    xs = torch.zeros(z.shape[:-1] + (n,) + z.shape[-1:], dtype=z.dtype,
                     device=z.device)
    xs[..., n - 1, :] = 1.0
    for i in range(n - 1, 0, -1):
        s = -z * xs[..., i, :] + (H[..., i, i:, None] * xs[..., i:, :]).sum(-2)
        xi = -s / bsafe[..., i - 1, None]
        inv_m = 1.0 / torch.clamp(xi.abs(), min=1.0)
        xs = xs * inv_m[..., None, :]
        xs[..., i - 1, :] = xi * inv_m
    alpha = -z * xs[..., 0, :] + (H[..., 0, :, None] * xs).sum(-2)
    sign_b = torch.sign(torch.where(b.abs() > 1e-25, b,
                                    torch.ones_like(b))).prod(-1)
    return alpha * sign_b[..., None] * ((-1.0) ** (n - 1))


def _real_roots(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to N_ROOTS real eigenvalues of (..., n, n) A as sign-change roots
    of p(z) = det(A - z I) on a tan-spaced grid covering all of R (fine
    near 0, where eigenvalues cluster), bisected with a fixed number of
    steps. Returns (roots (..., N_ROOTS), valid). Two roots inside one grid
    cell are an accepted per-sample miss that RANSAC's redundancy absorbs."""
    H = _hessenberg(A)
    dev, dt = A.device, A.dtype

    def p(z):
        return _hyman_signvals(H, z)

    eps = 1.0 / _GRID_N
    thetas = torch.linspace(-math.pi / 2 + eps, math.pi / 2 - eps, _GRID_N,
                            dtype=dt, device=dev)
    vals = p(torch.tan(thetas).expand(A.shape[:-2] + (_GRID_N,)))
    sign = torch.sign(vals)
    change = (sign[..., :-1] * sign[..., 1:]) < 0               # (..., G-1)
    scores = change.to(dt) * 2.0 + torch.linspace(0, 1, _GRID_N - 1, dtype=dt,
                                                  device=dev)
    top, idx = torch.topk(scores, N_ROOTS, dim=-1)
    valid = top >= 2.0
    ta = thetas[idx]
    tb = thetas[idx + 1]
    fa = p(torch.tan(ta))
    for _ in range(_BISECT_ITERS):
        tm = 0.5 * (ta + tb)
        fm = p(torch.tan(tm))
        left = (fa * fm) <= 0
        ta, tb, fa = (torch.where(left, ta, tm), torch.where(left, tm, tb),
                      torch.where(left, fa, fm))
    roots = torch.tan(0.5 * (ta + tb))

    # Newton polish against the true determinant:
    # p'(z) = -p(z) tr((A - zI)^-1)  =>  step = 1 / tr((A - zI)^-1)
    eye = torch.eye(A.shape[-1], dtype=dt, device=dev)
    for _ in range(2):
        inv = torch.linalg.inv_ex(A[..., None, :, :]
                                  - roots[..., None, None] * eye)[0]
        inv_tr = torch.diagonal(inv, dim1=-2, dim2=-1).sum(-1)
        step = 1.0 / torch.where(inv_tr.abs() > 1e-12, inv_tr,
                                 torch.full_like(inv_tr, 1e12))
        lim = 0.1 * (1 + roots.abs())
        roots = roots + torch.clamp(step, -lim, lim)
    return roots, valid


def solve_essential_5pt(p1n: torch.Tensor, p2n: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """5 normalised correspondences (..., 5, 2) -> (E (..., 10, 3, 3),
    valid (..., 10)).

    Up to 10 essential matrices satisfying all constraints; invalid slots
    (complex roots, degenerate samples) are False."""
    x1, x2 = to_homogeneous(p1n), to_homogeneous(p2n)
    return essentials_from_basis(null_basis(x1, x2), x1, x2)


def null_basis(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(..., 9, 4): the eigenvectors of Q^T Q for its 4 smallest
    eigenvalues, Q the (..., 5, 9) epipolar constraint rows of homogeneous
    x1, x2 (..., 5, 3). The basis of this nearly degenerate eigenspace is
    any rotation of it (LAPACK and cuSOLVER pick different ones); the
    solutions E do not depend on that choice beyond float32 rounding."""
    # rows kron(x2, x1), so that row . vec(E) = x2^T E x1
    Q = (x2[..., :, None] * x1[..., None, :]).flatten(-2)       # (..., 5, 9)
    _, vecs = eigh(Q.transpose(-1, -2) @ Q)
    return vecs[..., :4]


def essentials_from_basis(basis: torch.Tensor, x1: torch.Tensor,
                          x2: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steps 2-5 of the solver from a null-space basis (..., 9, 4) and the
    sample's homogeneous points (..., 5, 3): (E (..., 10, 3, 3), valid)."""
    dev, dt = basis.device, basis.dtype
    shape = basis.shape[:-2] + (3, 3)
    X, Y, Z, W = (basis[..., :, i].reshape(shape) for i in range(4))

    # numeric polynomial expansion at the generic points
    g = torch.as_tensor(GEN_PTS, dtype=dt, device=dev)[:, :, None, None]
    E_at = (g[:, 0] * X[..., None, :, :] + g[:, 1] * Y[..., None, :, :]
            + g[:, 2] * Z[..., None, :, :] + W[..., None, :, :])  # (..., 20, 3, 3)
    vals = _constraints_at(E_at)                                  # (..., 20, 10)
    Cfull = vals.transpose(-1, -2) @ torch.as_tensor(VAND_INV_T, dtype=dt,
                                                     device=dev)
    CL = Cfull[..., :10]
    CB = Cfull[..., 10:]
    ok_lin = torch.linalg.det(CL).abs() > 1e-20
    okf = ok_lin.to(dt)[..., None, None]
    eye10 = torch.eye(10, dtype=dt, device=dev)
    CLs = okf * CL + (1.0 - okf) * eye10
    M = torch.linalg.solve_ex(CLs, CB)[0]                         # L = -M B

    A = torch.zeros(M.shape, dtype=dt, device=dev)
    A[..., :len(_ZB_TO_L), :] = -M[..., _ZB_TO_L, :]
    for bi, bj in _ZB_TO_B.items():
        A[..., bi, bj] = 1.0

    roots, valid = _real_roots(A)
    valid = valid & ok_lin[..., None]

    # eigenvectors by shifted inverse iteration (3 steps)
    Mz = A[..., None, :, :] - (roots + 1e-6)[..., None, None] * eye10
    v = torch.ones(roots.shape + (10,), dtype=dt, device=dev)
    for _ in range(3):
        v = torch.linalg.solve_ex(Mz, v)[0]
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            min=1e-30)
    w1 = v[..., _B1]
    safe = w1.abs() > 1e-12
    w1s = torch.where(safe, w1, torch.ones_like(w1))
    xs = torch.where(safe, v[..., _BX] / w1s, torch.zeros_like(w1))
    ys = torch.where(safe, v[..., _BY] / w1s, torch.zeros_like(w1))

    E = (xs[..., None, None] * X[..., None, :, :]
         + ys[..., None, None] * Y[..., None, :, :]
         + roots[..., None, None] * Z[..., None, :, :] + W[..., None, :, :])
    finite_in = torch.isfinite(E).flatten(-2).all(-1)
    U, _, Vt = svd(E)
    Ep = (U * torch.tensor([1.0, 1.0, 0.0], dtype=dt, device=dev)) @ Vt
    n = torch.linalg.matrix_norm(Ep)
    Es = Ep / torch.clamp(n, min=1e-12)[..., None, None]
    finite = finite_in & torch.isfinite(Es).flatten(-2).all(-1)

    # self-check: a genuine solution reproduces the 5 sample constraints;
    # spurious brackets and failed eigenvector extractions are masked here
    resid = torch.einsum("...ni,...rij,...nj->...rn", x2, Es, x1)
    fits = resid.abs().amax(-1) < 1e-4
    return Es, valid & safe & finite & fits
