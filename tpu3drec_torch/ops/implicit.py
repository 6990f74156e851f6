"""Implicit-surface meshing of oriented point clouds: Poisson, alpha-shape
and ball-pivoting equivalents.

Port of `tpu3drec/ops/implicit.py`. The three methods build a scalar
field on a voxel grid and extract its iso-surface with the port's
marching tetrahedra (`ops/tsdf.py`), faces oriented along the field's
gradient (negative inside, as the TSDF):

  - `poisson_mesh`: trilinear splat of the unit normals into a vector
    field V (`index_add_`), the screened Poisson equation
    lap(chi) = div(G_sigma * V) solved spectrally (`torch.fft.fftn` /
    `ifftn` on complex64: the discrete central-difference operators are
    diagonal in the Fourier basis), chi's level at the samples as iso,
    extraction masked to the dilated splat support;
  - `alpha_surface_mesh`: the boundary of the union of alpha-balls, the
    zero set of (exact nearest-point distance - alpha);
  - `ball_pivot_mesh`: the zero set of the Hoppe signed distance
    (x - p_near) . n_near within the ball radius of the samples.

The splat, the spectral solve, the iso sampling and the nearest-point
distance grid (chunked |g|^2 + |p|^2 - 2 g.p matmuls, TF32 off) run on
the points' device; grid setup, support dilation and extraction are host
numpy, copied from the reference. On the card the splat's float atomics
add in a different order from run to run, so V and the density differ in
their last bits between runs. Entry points that take host arrays take
`device=None`, which means CUDA (`core/device.py`); pass device="cpu" for
the CPU.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu3drec_torch.core.device import resolve_device
from tpu3drec_torch.ops.tsdf import marching_tetrahedra

# the 8 corner offsets of a voxel cell, in the reference's order
_CORNERS = [(c >> 2 & 1, c >> 1 & 1, c & 1) for c in range(8)]


def _scalar(x, device) -> torch.Tensor:
    """A float32 0-d tensor on `device`: a true division by it, where a CPU
    scalar would become a multiply by its reciprocal on the card."""
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def _corner_weights(f: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Trilinear weight of the corner at offset `off` (3,) for fractions
    f (N, 3)."""
    return torch.prod(torch.where(off[None] == 1, f, 1.0 - f), dim=1)


# ---------------------------------------------------------------------
# splatting
# ---------------------------------------------------------------------

def splat_oriented_points(points: torch.Tensor, normals: torch.Tensor,
                          mask: torch.Tensor, origin: torch.Tensor, voxel,
                          dims: Tuple[int, int, int]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trilinear scatter of unit normals into a (X, Y, Z, 3) vector field.

    Returns (V (X, Y, Z, 3), density (X, Y, Z)): each point deposits its
    normal over the 8 enclosing voxel corners with trilinear weights."""
    X, Y, Z = dims
    dev = points.device
    g = (points - origin.to(dev)[None]) / _scalar(voxel, dev)
    g0 = torch.floor(g)
    f = g - g0
    gi = g0.to(torch.int32).to(torch.int64)
    V = torch.zeros((X * Y * Z, 3), dtype=torch.float32, device=dev)
    dens = torch.zeros(X * Y * Z, dtype=torch.float32, device=dev)
    m = mask.to(torch.float32)
    for off in torch.tensor(_CORNERS, device=dev):
        w = _corner_weights(f, off) * m
        ijk = gi + off[None]
        inb = ((ijk >= 0).all(dim=1) & (ijk[:, 0] < X) & (ijk[:, 1] < Y)
               & (ijk[:, 2] < Z))
        lin = torch.where(inb, (ijk[:, 0] * Y + ijk[:, 1]) * Z + ijk[:, 2], 0)
        w = torch.where(inb, w, 0.0)
        V.index_add_(0, lin, w[:, None] * normals)
        dens.index_add_(0, lin, w)
    return V.reshape(X, Y, Z, 3), dens.reshape(X, Y, Z)


# ---------------------------------------------------------------------
# spectral Poisson solve
# ---------------------------------------------------------------------

def solve_poisson_spectral(V: torch.Tensor, voxel, sigma_voxels,
                           screen) -> torch.Tensor:
    """Solve (lap - screen) chi = div(G_sigma * V) on a periodic grid.

    Divergence, Gaussian smoothing and the inverse Laplacian are diagonal
    in the Fourier basis of the discrete central-difference operators:
    one pointwise complex multiply between the forward and inverse FFTs.
    chi is returned zero-mean."""
    X, Y, Z = V.shape[:3]
    dev = V.device
    h = _scalar(voxel, dev)
    sigma = _scalar(sigma_voxels, dev)

    def freq(n):
        return 2.0 * math.pi * torch.fft.fftfreq(n, device=dev)

    KX, KY, KZ = torch.meshgrid(freq(X), freq(Y), freq(Z), indexing="ij")
    # central-difference derivative eigenvalue: i sin(k) / h
    dx, dy, dz = (torch.complex(torch.zeros_like(K), torch.sin(K)) / h
                  for K in (KX, KY, KZ))
    # 7-point Laplacian eigenvalue: (2 cos k - 2) / h^2 per axis (<= 0)
    lam = ((2.0 * torch.cos(KX) - 2.0) + (2.0 * torch.cos(KY) - 2.0)
           + (2.0 * torch.cos(KZ) - 2.0)) / (h * h)
    # Gaussian transfer function (grid units)
    k2 = KX * KX + KY * KY + KZ * KZ
    gauss = torch.exp(-0.5 * (sigma * sigma) * k2)

    F = torch.fft.fftn(V.to(torch.complex64), dim=(0, 1, 2))
    div_hat = dx * F[..., 0] + dy * F[..., 1] + dz * F[..., 2]
    denom = lam - _scalar(screen, dev)
    # k = 0 mode: lam = 0; with screen = 0 pin chi_hat(0) = 0 (zero mean)
    pinned = torch.abs(denom) < 1e-12
    safe = torch.where(pinned, 1.0, denom)
    chi_hat = torch.where(pinned, 0.0, gauss * div_hat / safe)
    chi = torch.fft.ifftn(chi_hat, dim=(0, 1, 2)).real
    return chi - torch.mean(chi)


def _sample_trilinear(grid: torch.Tensor, points: torch.Tensor,
                      mask: torch.Tensor, origin: torch.Tensor, voxel
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked sum (and count) of a scalar grid trilinearly sampled at
    points, borders clamped."""
    X, Y, Z = grid.shape
    dev = points.device
    g = (points - origin.to(dev)[None]) / _scalar(voxel, dev)
    g0 = torch.floor(g)
    f = g - g0
    gi = g0.to(torch.int32).to(torch.int64)
    hi = torch.tensor([X - 1, Y - 1, Z - 1], device=dev)[None]
    flat = grid.reshape(-1)
    acc = torch.zeros(points.shape[0], dtype=torch.float32, device=dev)
    for off in torch.tensor(_CORNERS, device=dev):
        w = _corner_weights(f, off)
        ijk = torch.minimum(torch.clamp(gi + off[None], min=0), hi)
        lin = (ijk[:, 0] * Y + ijk[:, 1]) * Z + ijk[:, 2]
        acc = acc + w * flat[lin]
    m = mask.to(torch.float32)
    return torch.sum(acc * m), torch.sum(m)


def _dilate_mask(mask: np.ndarray, rounds: int) -> np.ndarray:
    """6-connected binary dilation (host numpy)."""
    m = mask.copy()
    for _ in range(rounds):
        grown = m.copy()
        grown[1:] |= m[:-1]
        grown[:-1] |= m[1:]
        grown[:, 1:] |= m[:, :-1]
        grown[:, :-1] |= m[:, 1:]
        grown[:, :, 1:] |= m[:, :, :-1]
        grown[:, :, :-1] |= m[:, :, 1:]
        m = grown
    return m


def _grid_setup(pts: np.ndarray, resolution: int, pad_voxels: float):
    lo = pts.min(0)
    hi = pts.max(0)
    extent = float(np.max(hi - lo))
    voxel = max(extent / max(resolution - 1 - 2 * pad_voxels, 1), 1e-9)
    lo = lo - pad_voxels * voxel
    hi = hi + pad_voxels * voxel
    dims = tuple(int(min(np.ceil((h - l) / voxel) + 1, resolution))
                 for l, h in zip(lo, hi))
    return lo.astype(np.float32), float(voxel), dims


def _outward_normals(pts: np.ndarray, normals: Optional[np.ndarray],
                     dev: torch.device) -> np.ndarray:
    """Unit normals: the given ones, or PCA normals oriented away from the
    centroid when absent."""
    if normals is None:
        from tpu3drec_torch.ops.pointcloud import estimate_normals
        nrm = estimate_normals(
            torch.from_numpy(pts).to(dev),
            torch.ones(len(pts), dtype=torch.bool, device=dev),
            k=min(16, max(len(pts) - 1, 1)),
            viewpoint=pts.mean(0)).cpu().numpy()
        nrm = -nrm  # estimate_normals orients toward viewpoint = inward
    else:
        nrm = np.asarray(normals, np.float32)
    return nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                            1e-12)


def poisson_mesh(points: np.ndarray, normals: Optional[np.ndarray] = None,
                 resolution: int = 96, sigma_voxels: float = 1.5,
                 screen: float = 0.0, support_voxels: int = 3,
                 density_quantile: float = 0.05, device=None) -> Dict:
    """Poisson surface reconstruction (mesh_generation.py:29-86).

    points (N, 3) with outward unit normals (N, 3); if normals are absent
    they are estimated by PCA + outward orientation from the centroid.
    Returns {verts, faces, chi, density, origin, voxel, iso}."""
    dev = resolve_device(device)
    pts = np.asarray(points, np.float32)
    nrm = _outward_normals(pts, normals, dev)
    origin, voxel, dims = _grid_setup(pts, resolution,
                                      pad_voxels=3 * sigma_voxels + 2)
    pts_t = torch.from_numpy(pts).to(dev)
    ones = torch.ones(len(pts), dtype=torch.bool, device=dev)
    origin_t = torch.from_numpy(origin).to(dev)
    V, dens = splat_oriented_points(
        pts_t, torch.from_numpy(np.ascontiguousarray(nrm, np.float32)).to(dev),
        ones, origin_t, voxel, dims)
    # chi is LOWER inside (grad chi_indicator = -n_outward at the
    # surface), matching the TSDF sign convention of ops/tsdf.py
    chi = solve_poisson_spectral(V, voxel, sigma_voxels, screen)
    # iso level = mean chi over the input samples (the standard choice)
    s, c = _sample_trilinear(chi, pts_t, ones, origin_t, voxel)
    iso = float(s) / max(float(c), 1.0)
    chi_np = chi.cpu().numpy()
    dens_np = dens.cpu().numpy()

    # extract only where the splat support (dilated) exists: the spectral
    # solve fills the whole periodic box with a smooth field
    thresh = max(np.quantile(dens_np[dens_np > 0], density_quantile)
                 if (dens_np > 0).any() else 0.0, 1e-6)
    support = _dilate_mask(dens_np >= thresh, support_voxels)
    verts, faces = marching_tetrahedra(
        chi_np, support.astype(np.float32), origin, voxel,
        iso=iso, min_weight=0.5)
    return {"verts": verts, "faces": faces, "chi": chi_np,
            "density": dens_np, "origin": origin, "voxel": voxel,
            "iso": iso}


# ---------------------------------------------------------------------
# union-of-balls (alpha shape / ball pivoting equivalents)
# ---------------------------------------------------------------------

def distance_grid(points: torch.Tensor, mask: torch.Tensor,
                  origin: torch.Tensor, voxel, dims: Tuple[int, int, int],
                  chunk: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact nearest-point distance (+ index) on a voxel grid.

    One matmul-form pass per chunk of voxels: |g - p|^2 = |g|^2 + |p|^2
    - 2 g.p, then a min-reduction; float32, so the expanded form cancels
    near the points. Returns (dist (X, Y, Z) f32, argmin (X, Y, Z) i32)."""
    X, Y, Z = dims
    dev = points.device
    n = X * Y * Z
    axes = [torch.arange(k, dtype=torch.float32, device=dev) for k in dims]
    G = (torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
         * _scalar(voxel, dev) + origin.to(dev)[None])
    p2 = torch.sum(points * points, 1)
    p2 = torch.where(mask, p2, torch.inf)
    d2min = torch.empty(n, dtype=torch.float32, device=dev)
    amin = torch.empty(n, dtype=torch.int64, device=dev)
    for s in range(0, n, chunk):
        g = G[s:s + chunk]
        d2 = (torch.sum(g * g, 1)[:, None] + p2[None, :]
              - 2.0 * g @ points.T)
        idx = torch.argmin(d2, 1)
        d2min[s:s + chunk] = torch.gather(d2, 1, idx[:, None])[:, 0]
        amin[s:s + chunk] = idx
    return (torch.sqrt(torch.clamp(d2min, min=0.0)).reshape(X, Y, Z),
            amin.to(torch.int32).reshape(X, Y, Z))


def _uob_field(points: np.ndarray, radius: float, resolution: int,
               max_points: int = 16384, aux: Optional[np.ndarray] = None,
               device=None):
    """Distance field + grid geometry for union-of-balls surfaces:
    (distance, argmin, origin, voxel, points used[, aux used]).

    At most `max_points` points (a numpy default_rng(0) subsample, `aux`,
    e.g. normals, kept in lockstep), all of them real: no padding."""
    dev = resolve_device(device)
    pts = np.asarray(points, np.float32)
    if aux is not None:
        aux = np.asarray(aux, np.float32)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(
            len(pts), max_points, replace=False)
        pts = pts[sel]
        if aux is not None:
            aux = aux[sel]
    # pad so the ball radius fits inside the box (estimate voxel first)
    extent = float(np.max(pts.max(0) - pts.min(0)))
    voxel_est = max(extent / max(resolution - 1, 1), 1e-9)
    pad = int(np.ceil(radius / voxel_est)) + 2
    origin2, voxel2, dims2 = _grid_setup(pts, resolution + 2 * pad,
                                         pad_voxels=pad)
    d, amin = distance_grid(
        torch.from_numpy(pts).to(dev),
        torch.ones(len(pts), dtype=torch.bool, device=dev),
        torch.from_numpy(origin2).to(dev), voxel2, dims2)
    out = (d.cpu().numpy(), amin.cpu().numpy(), origin2, voxel2, pts)
    return out + (aux,) if aux is not None else out


def alpha_surface_mesh(points: np.ndarray, alpha: float = 0.03,
                       resolution: int = 96, device=None) -> Dict:
    """Alpha-shape-equivalent surface (mesh_generation.py:144-180): the
    boundary of the union of alpha-balls around the samples, extracted as
    the iso-surface of the exact distance field."""
    d, _, origin, voxel, _ = _uob_field(points, alpha, resolution,
                                        device=device)
    field = d - float(alpha)            # negative inside the ball union
    verts, faces = marching_tetrahedra(
        field, np.ones_like(field), origin, voxel, iso=0.0, min_weight=0.5)
    return {"verts": verts, "faces": faces, "distance": d,
            "origin": origin, "voxel": voxel}


def _median_nn_spacing(pts: np.ndarray) -> float:
    sub = pts[np.random.default_rng(0).choice(
        len(pts), min(len(pts), 2048), replace=False)]
    d2 = ((sub[:, None] - sub[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return float(np.median(np.sqrt(d2.min(1))))


def ball_pivot_mesh(points: np.ndarray, normals: Optional[np.ndarray] = None,
                    radius: Optional[float] = None, resolution: int = 96,
                    device=None) -> Dict:
    """Ball-pivoting equivalent (mesh_generation.py:87-143): the zero set
    of the Hoppe signed distance (x - p_near) . n_near, extracted only
    within distance r of the samples (holes where the r-ball finds no
    support). radius defaults to 2x the median nearest-neighbour
    spacing."""
    dev = resolve_device(device)
    pts = np.asarray(points, np.float32)
    nrm = _outward_normals(pts, normals, dev)
    if radius is None:
        radius = 2.0 * _median_nn_spacing(pts)
    d, amin, origin, voxel, used, used_n = _uob_field(
        pts, radius, resolution, aux=nrm, device=dev)
    X, Y, Z = d.shape
    gx, gy, gz = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                             indexing="ij")
    centres = (np.stack([gx, gy, gz], axis=-1).astype(np.float32)
               * voxel + origin)
    pn = used[amin]                                    # (X, Y, Z, 3)
    nn = used_n[amin]
    signed = ((centres - pn) * nn).sum(-1)             # negative inside
    support = (d <= float(radius)).astype(np.float32)
    verts, faces = marching_tetrahedra(
        signed, support, origin, voxel, iso=0.0, min_weight=0.5)
    return {"verts": verts, "faces": faces, "distance": d,
            "origin": origin, "voxel": voxel, "radius": float(radius)}
