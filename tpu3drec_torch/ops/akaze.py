"""AKAZE: nonlinear-diffusion scale space + Hessian detection + M-LDB
binary descriptor, batched over `(B, H, W)` images.

Port of `tpu3drec/ops/akaze.py`. The scale space evolves with the g2
conductivity 1 / (1 + |grad L|^2 / k^2), k^2 from the 70th percentile of
each image's gradient magnitude, by Fast Explicit Diffusion steps whose
schedule covers t_i - t_{i-1} (t = sigma^2 / 2) continuously across
sublevels and octaves; each octave resizes the previous octave's evolved
image with JAX's linear resize and scales k by 0.75. The schedule is
static Python (166 steps at 4 octaves of 4 sublevels), so the loop runs
the same ops for every input, each on the whole batch at once. Borders
wrap (`torch.roll`), as the reference's `jnp.roll` does.

Per level: the sigma-normalised determinant of the Hessian, 3x3 NMS, a
threshold, a 10 px border and a per-level top-K; orientation from the
summed gradient of a 9x9 patch; a 486-bit M-LDB descriptor from
2x2 / 3x3 / 4x4 cell means of (intensity, dx, dy) on a rotated 24x24
patch, stored +-1 (`hamming_pm1`). Every top-K orders ties by index, as
`lax.top_k` does. The stages run under profiler ranges
(`akaze.scale_space`, `akaze.levels`, `akaze.merge`).

One FED cycle covers each sublevel's whole time step, so the coarse
levels' cycles are long (up to 29 steps, single steps up to tau = 41
against the explicit limit of 0.25) and amplify a last-ulp difference
of their input without bound: the reference's own levels move by 1e-5
at the second octave's end and by O(100) at the last octave under a
one-ulp change of the image. The port keeps the reference's schedule;
its parity tests hold the stable levels by tolerance and compare
keypoints there (tests/test_torch_detectors.py).
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from tpu3drec_torch.core.types import DescriptorKind, Features
from tpu3drec_torch.ops.harris import merge_top_k, nms_2d, select_top_k
from tpu3drec_torch.ops.image import central_gradients, gaussian_blur, resize
from tpu3drec_torch.ops.sift import _bilinear_many, _patch_offsets
from tpu3drec_torch.utils.profiling import span

N_SUBLEVELS = 4
SIGMA0 = 1.6       # base scale (KAZE sigma0)
TAU_MAX = 0.25     # explicit-scheme stability limit (4-neighbourhood)
PATCH = 24         # descriptor patch side (samples)
PERCENTILE = 70.0  # of the gradient magnitude, for the contrast factor


def fed_tau_schedule(T: float, tau_max: float = TAU_MAX) -> list:
    """Fast-Explicit-Diffusion step sizes integrating total time T: the
    smallest n whose FED cycle, tau_j = tau_max / (2 cos^2(pi (2j+1) /
    (4n+2))), reaches T, rescaled to sum to T exactly."""
    if T <= 0:
        return []
    n = 1
    while tau_max * (n * n + n) / 3.0 < T:
        n += 1
    taus = [tau_max / (2.0 * math.cos(math.pi * (2 * j + 1)
                                      / (4 * n + 2)) ** 2)
            for j in range(n)]
    s = T / sum(taus)
    return [t * s for t in taus]


def _diffusion_step(L: torch.Tensor, k2: torch.Tensor,
                    tau: float) -> torch.Tensor:
    """One explicit step of div(g(|grad L|) grad L) with the g2
    conductivity; `L` (..., H, W), `k2` broadcastable to it."""
    Lr, Ll = torch.roll(L, -1, -1), torch.roll(L, 1, -1)
    Ld, Lu = torch.roll(L, -1, -2), torch.roll(L, 1, -2)
    dx = 0.5 * (Lr - Ll)
    dy = 0.5 * (Ld - Lu)
    g = 1.0 / (1.0 + (dx * dx + dy * dy) / k2)
    gr = 0.5 * (g + torch.roll(g, -1, -1))
    gl = 0.5 * (g + torch.roll(g, 1, -1))
    gd = 0.5 * (g + torch.roll(g, -1, -2))
    gu = 0.5 * (g + torch.roll(g, 1, -2))
    lap = gr * (Lr - L) + gl * (Ll - L) + gd * (Ld - L) + gu * (Lu - L)
    return L + tau * lap


def level_shapes(h0: int, w0: int, n_octaves: int):
    """(h, w) of each octave, as the reference sizes them."""
    return [(max(int(h0 / 2.0 ** o), 32), max(int(w0 / 2.0 ** o), 32))
            for o in range(n_octaves)]


def evolve_scale_space(img: torch.Tensor, k2: torch.Tensor, n_octaves: int):
    """The nonlinear scale space of `(B, H, W)` images with per-image
    contrast factors `k2` (B,): a list of (octave, sublevel, sigma in
    octave pixels, L (B, h, w)) per level."""
    levels = []
    L = gaussian_blur(img, SIGMA0)
    prev_t = 0.5 * SIGMA0 * SIGMA0
    k2_o = k2[:, None, None]
    h0, w0 = img.shape[-2:]
    for o, (h, w) in enumerate(level_shapes(h0, w0, n_octaves)):
        s = 2.0 ** o
        if o > 0:
            L = resize(L, (h, w))
            k2_o = k2_o * (0.75 ** 2)
        for sub in range(N_SUBLEVELS):
            sigma_g = SIGMA0 * 2.0 ** (o + sub / N_SUBLEVELS)
            t = 0.5 * sigma_g * sigma_g
            for tau in fed_tau_schedule(t - prev_t):
                L = _diffusion_step(L, k2_o, tau)
            prev_t = t
            levels.append((o, sub, sigma_g / s, L))
    return levels


def _percentile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """`jnp.percentile(row, q)` of each row of `(B, N)`: linear
    interpolation between the order statistics around q / 100 * (N - 1),
    weighted as JAX weighs them (low * (1 - f) + high * f)."""
    n = x.shape[-1]
    pos = np.float32(q / 100.0) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    f = np.float32(pos - np.float32(lo))
    v = torch.sort(x, dim=-1).values
    return v[..., lo] * (np.float32(1.0) - f) + v[..., hi] * f


def _contrast_k2(img: torch.Tensor) -> torch.Tensor:
    """(B,) squared contrast factor of `(B, H, W)` images: the 70th
    percentile of the gradient magnitude of the sigma-1 blur, per image."""
    dx, dy = central_gradients(gaussian_blur(img, 1.0))
    mag = torch.sqrt(dx * dx + dy * dy)
    k = _percentile_linear(mag.reshape(mag.shape[0], -1), PERCENTILE)
    return torch.clamp(k * k, min=1e-8)


def _hessian_response(L: torch.Tensor, sigma: float) -> torch.Tensor:
    dx, dy = central_gradients(L)
    dxx, dxy = central_gradients(dx)
    dyx, dyy = central_gradients(dy)
    det = dxx * dyy - dxy * dyx
    return (sigma ** 2) * det


def _mldb_tables():
    """Per grid size g (2, 3, 4): the index pairs of its cells."""
    out = []
    for g in (2, 3, 4):
        pairs = list(itertools.combinations(range(g * g), 2))
        out.append((g, np.asarray([p[0] for p in pairs]),
                    np.asarray([p[1] for p in pairs])))
    return out


_MLDB_PAIRS = _mldb_tables()


def _mldb_descriptor(L: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                     xy: torch.Tensor, angle: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """(B, K, 486) +-1 M-LDB bits from a rotated, scaled 24x24 patch of
    `(B, H, W)` maps around `(B, K)` keypoints."""
    dev = L.device
    lin = (torch.arange(PATCH, dtype=torch.float32, device=dev) + 0.5) \
        / PATCH - 0.5
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    ox = gx.reshape(-1) * 2.0  # the patch spans +-1 scale unit x 10 px
    oy = gy.reshape(-1) * 2.0
    ca, sa = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    ext = 10.0 * scale[..., None]
    px = xy[..., 0:1] + (ca * ox - sa * oy) * ext
    py = xy[..., 1:2] + (sa * ox + ca * oy) * ext
    vi = _bilinear_many(L, px, py)                    # (B, K, P*P)
    vx0 = _bilinear_many(dx, px, py)
    vy0 = _bilinear_many(dy, px, py)
    # gradients in the keypoint's frame
    vx = ca * vx0 + sa * vy0
    vy = -sa * vx0 + ca * vy0

    B, K = xy.shape[:2]
    feats = torch.stack([vi, vx, vy], dim=2)          # (B, K, 3, P*P)
    bits = []
    for g, ia, ib in _MLDB_PAIRS:
        cell = PATCH // g
        f = feats.reshape(B, K, 3, g, cell, g, cell).mean(dim=(4, 6))
        f = f.reshape(B, K, 3, g * g)
        cmp = torch.where(f[..., ia] > f[..., ib], 1.0, -1.0)
        bits.append(cmp.reshape(B, K, -1))
    return torch.cat(bits, dim=-1)         # 3 * (6 + 36 + 120) = 486


def detect_and_compute(imgs: torch.Tensor, max_features: int = 2048,
                       n_octaves: int = 4, threshold: float = 0.001):
    """AKAZE of `(B, H, W)` (or one `(H, W)`) float32 images in [0, 1]:
    (xy, response, scale, angle, desc, mask) with capacity `max_features`
    per image."""
    single = imgs.ndim == 2
    if single:
        imgs = imgs[None]
    with span("akaze.scale_space"):
        k2 = _contrast_k2(imgs)
        levels = evolve_scale_space(imgs, k2, n_octaves)
    with span("akaze.levels"):
        parts = [_level_features(o, sigma, L, max_features, threshold)
                 for (o, _, sigma, L) in levels]
    with span("akaze.merge"):
        return merge_top_k(parts, max_features, single)


def _level_features(o: int, sigma: float, L: torch.Tensor,
                    max_features: int, threshold: float) -> dict:
    """One level's slots: Hessian peaks above `threshold` and 10 px inside
    the border, its per-level top-K, their orientations and M-LDB bits."""
    B = L.shape[0]
    dev = L.device
    s = 2.0 ** o
    h, w = L.shape[-2:]
    resp = _hessian_response(L, sigma)
    peaks = nms_2d(resp, 1) & (resp > threshold)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    interior = (yy >= 10) & (yy < h - 10) & (xx >= 10) & (xx < w - 10)
    k_level = max(max_features // (2 ** o) // N_SUBLEVELS, 32)
    k_level = min(k_level, h * w)
    xy, r, mask = select_top_k(resp, peaks & interior, k_level)
    dx, dy = central_gradients(L)
    # orientation: direction of the summed gradient over a 9x9 patch
    offs = _patch_offsets(9, dev) * 12.0 * sigma
    sx = xy[..., 0:1] + offs[:, 0]
    sy = xy[..., 1:2] + offs[:, 1]
    angle = torch.atan2(_bilinear_many(dy, sx, sy).sum(-1),
                        _bilinear_many(dx, sx, sy).sum(-1))
    desc = _mldb_descriptor(L, dx, dy, xy, angle,
                            torch.full((B, k_level), sigma,
                                       dtype=torch.float32, device=dev))
    return dict(
        xy=xy * s,
        response=torch.where(mask, r, torch.full_like(r, -math.inf)),
        scale=torch.full((B, k_level), sigma * s * 6.0,
                         dtype=torch.float32, device=dev),
        angle=angle, desc=desc, mask=mask)


def detect_akaze_features(img: torch.Tensor, max_features: int = 2048,
                          threshold: float = 0.001, n_octaves: int = 4,
                          n_octave_layers: int = 4,
                          method: str = "AKAZE", **_unused) -> Features:
    """Detector contract on one `(H, W)` image or a `(B, H, W)` batch:
    cv2.AKAZE defaults (threshold 0.001, 4 octaves; the sublevels are
    fixed at 4, as in the reference)."""
    xy, resp, scale, angle, desc, mask = detect_and_compute(
        img, max_features, n_octaves, threshold)
    return Features(xy=xy, response=resp, scale=scale, angle=angle,
                    desc=desc, mask=mask, method=method,
                    desc_kind=DescriptorKind.BINARY.value,
                    image_shape=tuple(img.shape[-2:]))
