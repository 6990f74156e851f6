"""Essential-matrix estimation and pose recovery.

Port of `tpu3drec/ops/epipolar.py` with a leading batch axis: points are
(B, N, 2) (or (N, 2) for one pair), intrinsics (B, 3, 3) or one (3, 3)
shared by the batch. Pixel points are normalised by K, the 8-point or
5-point solver runs inside the batched RANSAC engine with Sampson
residuals, and the best E is decomposed into the four (R, t) candidates,
the cheirality vote picking the winner (cv2.recoverPose's rule).

Random draws come from a `torch.Generator`; `sub=` (the subsample
indices) and `u=` (the RANSAC uniforms) replay given draws instead, so a
test can feed the reference's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tpu3drec_torch.ops.five_point import N_ROOTS, solve_essential_5pt
from tpu3drec_torch.ops.geometry import (
    _sampson_residuals, _smallest_singular_vector, finite_or_zero,
    normalize_points, sampson_error, svd, to_homogeneous,
)
from tpu3drec_torch.ops.ransac import ransac

# RANSAC runs on at most this many correspondences (a Gumbel subsample);
# the winning model is scored and refit on the full set
SAMPLE_CAP = 512


def normalize_with_K(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel -> normalised camera coordinates (zero distortion): pts
    (..., N, 2), K (..., 3, 3)."""
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    return torch.stack([(pts[..., 0] - cx) / fx, (pts[..., 1] - cy) / fy], -1)


def denormalize_with_K(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    return torch.stack([pts[..., 0] * fx + cx, pts[..., 1] * fy + cy], -1)


def project_to_essential(E: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix: singular values -> (1, 1, 0)."""
    U, _, Vt = svd(E)
    return (U * torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype,
                             device=E.device)) @ Vt


def solve_essential_8pt(p1n: torch.Tensor, p2n: torch.Tensor,
                        w: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """8-point essential matrix (x2^T E x1 = 0) from (..., N, 2) normalised
    points, optionally weighted. Returns (E (..., 3, 3), valid (...))."""
    p1h, T1 = normalize_points(p1n, w)
    p2h, T2 = normalize_points(p2n, w)
    x, y = p1h[..., 0], p1h[..., 1]
    u, v = p2h[..., 0], p2h[..., 1]
    one = torch.ones_like(x)
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, one], -1)
    if w is not None:
        A = A * torch.sqrt(w.to(A.dtype))[..., None]
    e = _smallest_singular_vector(A)
    E = T2.transpose(-1, -2) @ e.reshape(e.shape[:-1] + (3, 3)) @ T1
    E = project_to_essential(E)
    norm = torch.linalg.matrix_norm(E)
    valid = (norm > 1e-12) & torch.isfinite(E).flatten(-2).all(-1)
    return E / torch.where(valid, norm, torch.ones_like(norm))[..., None, None], valid


class EssentialResult(NamedTuple):
    E: torch.Tensor             # (B, 3, 3)
    inliers: torch.Tensor       # (B, N) bool
    num_inliers: torch.Tensor   # (B,) int32
    inlier_ratio: torch.Tensor  # (B,) float32
    success: torch.Tensor       # (B,) bool
    residuals: torch.Tensor     # (B, N) squared, in normalised coordinates


def gumbel_subsample(mask: torch.Tensor, generator: torch.Generator,
                     cap: int = SAMPLE_CAP) -> torch.Tensor:
    """(B, cap) indices: the top `cap` of Gumbel noise plus log(mask), a
    uniform draw without replacement of valid points first (the
    reference's subsample, from a torch generator)."""
    u = torch.rand(mask.shape, generator=generator,
                   device=generator.device).to(mask.device)
    g = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    g = g + torch.log(mask.to(torch.float32) + 1e-30)
    return torch.topk(g, cap, dim=-1).indices


def _batched(pts1, pts2, K1, K2, mask):
    single = pts1.ndim == 2
    if single:
        pts1, pts2 = pts1[None], pts2[None]
        mask = None if mask is None else mask[None]
    K2 = K1 if K2 is None else K2
    B = pts1.shape[0]
    K1 = K1.expand(B, 3, 3)
    K2 = K2.expand(B, 3, 3)
    if mask is None:
        mask = torch.ones(pts1.shape[:2], dtype=torch.bool, device=pts1.device)
    return single, pts1, pts2, K1, K2, mask


def find_essential(pts1: torch.Tensor, pts2: torch.Tensor,
                   K1: torch.Tensor, K2: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None,
                   threshold_px: float = 1.5,
                   num_hypotheses: int = 1024,
                   generator: Optional[torch.Generator] = None,
                   refit: bool = True,
                   method: str = "8point",
                   sub: Optional[torch.Tensor] = None,
                   u: Optional[torch.Tensor] = None) -> EssentialResult:
    """RANSAC essential matrix from pixel correspondences (B, N, 2) or
    (N, 2); cv2.findEssentialMat's convention: threshold_px is scaled to
    normalised coordinates by the mean focal length.

    method: '8point' (normalised 8-point + essential-manifold projection)
    or '5point' (the minimal solver of `ops/five_point.py`, up to 10
    models per sample, max(num_hypotheses // 10, 64) samples). Above
    SAMPLE_CAP correspondences RANSAC runs on a Gumbel subsample of the
    valid ones; the model is scored and refit on the full set. `sub`
    ((cap,) or (B, cap)) and `u` ((K, s)) replay given draws; otherwise
    both come from `generator` (seed 0 when None)."""
    single, pts1, pts2, K1, K2, mask = _batched(pts1, pts2, K1, K2, mask)
    B, n = mask.shape
    if generator is None and (u is None or (n > SAMPLE_CAP and sub is None)):
        generator = torch.Generator(device=pts1.device).manual_seed(0)
    p1n = normalize_with_K(pts1, K1)
    p2n = normalize_with_K(pts2, K2)
    f_mean = 0.25 * (K1[:, 0, 0] + K1[:, 1, 1] + K2[:, 0, 0] + K2[:, 1, 1])
    thr_norm = threshold_px / f_mean                                # (B,)

    if n > SAMPLE_CAP:
        if sub is None:
            sub = gumbel_subsample(mask, generator)
        sub = sub.to(pts1.device).expand(B, SAMPLE_CAP)
        p1s = p1n.gather(1, sub[..., None].expand(-1, -1, 2))
        p2s = p2n.gather(1, sub[..., None].expand(-1, -1, 2))
        masks = mask.gather(1, sub)
    else:
        p1s, p2s, masks = p1n, p2n, mask

    if method == "5point":
        res = ransac(p1s, p2s, masks, solver=solve_essential_5pt,
                     residual_fn=_sampson_residuals, sample_size=5,
                     num_hypotheses=max(num_hypotheses // N_ROOTS, 64),
                     models_per_sample=N_ROOTS, threshold=thr_norm,
                     generator=generator, u=u)
    elif method == "8point":
        res = ransac(p1s, p2s, masks, solver=solve_essential_8pt,
                     residual_fn=_sampson_residuals, sample_size=8,
                     num_hypotheses=num_hypotheses, threshold=thr_norm,
                     generator=generator, u=u)
    else:
        raise ValueError(f"method must be '8point' or '5point', got {method!r}")
    E = res.model
    thr2 = (thr_norm ** 2)[:, None]
    # score the winning model on the full set
    r_full = sampson_error(E, p1n, p2n)
    inl = (r_full <= thr2) & mask
    num0 = inl.sum(-1)
    if refit:
        E2, ok = solve_essential_8pt(p1n, p2n, inl.to(p1n.dtype))
        r2 = sampson_error(E2, p1n, p2n)
        inl2 = (r2 <= thr2) & mask
        better = ok & (inl2.sum(-1) >= num0) & res.success
        E = torch.where(better[:, None, None], E2, E)
        inl = torch.where(better[:, None], inl2, inl)
        r_full = torch.where(better[:, None], r2, r_full)
    n_valid = torch.clamp(mask.sum(-1, dtype=torch.int32), min=1)
    num = inl.sum(-1, dtype=torch.int32)
    out = EssentialResult(E=E, inliers=inl, num_inliers=num,
                          inlier_ratio=num / n_valid, success=res.success,
                          residuals=r_full)
    if single:
        out = EssentialResult(*(t[0] for t in out))
    return out


def essential_quality(E: torch.Tensor) -> dict:
    """Singular-value diagnostics of E (..., 3, 3): sigma1 ~= sigma2,
    sigma3 ~= 0."""
    S = torch.linalg.svdvals(finite_or_zero(E))
    s1 = torch.clamp(S[..., 0], min=1e-12)
    ratio = S[..., 1] / s1
    s3 = S[..., 2] / s1
    return {"singular_values": S, "sv_ratio": ratio, "sv3_over_sv1": s3,
            "is_valid": (ratio > 0.7) & (s3 < 0.1)}


_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def decompose_essential(E: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """E (..., 3, 3) -> (R1, R2, t): the four candidate poses are
    (R1, t), (R1, -t), (R2, t), (R2, -t)."""
    U, _, Vt = svd(E)
    # proper rotations (det +1)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor(_W, dtype=E.dtype, device=E.device)
    return U @ W @ Vt, U @ W.T @ Vt, U[..., :, 2]


def triangulate_linear(p1n: torch.Tensor, p2n: torch.Tensor,
                       R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Depth along each camera-1 ray from the two-row closed form, for
    cheirality voting: camera 1 = [I | 0], camera 2 = [R | t]; p*n
    (..., N, 2) normalised. Returns (..., N, 3) in camera 1's frame."""
    x1 = to_homogeneous(p1n)
    x2 = to_homogeneous(p2n)
    Rx1 = x1 @ R.transpose(-1, -2)
    c = torch.linalg.cross(x2, Rx1)
    d = torch.linalg.cross(x2, t[..., None, :])
    l1 = -(c * d).sum(-1) / torch.clamp((c * c).sum(-1), min=1e-12)
    return x1 * l1[..., None]


def recover_pose(E: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor,
                 K1: torch.Tensor, K2: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """cv2.recoverPose: the (R, t) of the 4 candidates with the most points
    in front of both cameras. E (B, 3, 3) with (B, N, 2) points, or one
    pair. Returns (R, t, cheirality mask), t unit-norm, x2 ~ R x1 + t."""
    single = E.ndim == 2
    if single:
        E = E[None]
    _, pts1, pts2, K1, K2, mask = _batched(pts1, pts2, K1, K2, mask)
    p1n = normalize_with_K(pts1, K1)
    p2n = normalize_with_K(pts2, K2)
    R1, R2, t = decompose_essential(E)
    Rs = torch.stack([R1, R1, R2, R2], 1)                          # (B, 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], 1)                            # (B, 4, 3)
    X = triangulate_linear(p1n[:, None], p2n[:, None], Rs, ts)     # (B, 4, N, 3)
    z1 = X[..., 2]
    z2 = (X @ Rs.transpose(-1, -2) + ts[:, :, None, :])[..., 2]
    front = (z1 > 1e-6) & (z2 > 1e-6) & mask[:, None]
    best = torch.argmax(front.sum(-1), dim=1)                       # first max
    rows = torch.arange(E.shape[0], device=E.device)
    out = (Rs[rows, best], ts[rows, best], front[rows, best])
    return tuple(o[0] for o in out) if single else out


def rotation_angle_deg(R: torch.Tensor) -> torch.Tensor:
    """Rotation magnitude in degrees of (..., 3, 3)."""
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    return torch.rad2deg(torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)))
