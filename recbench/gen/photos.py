"""Pairs of textured photos and known similarity warps of them, made on
the device from the seed.

Each photo is band-limited noise at four scales (4, 8, 16 and 32 px
cells, bicubic), normalised to [0, 1]: texture at every scale of SIFT's
five octaves, so each octave's candidate budget fills. The second image
of a pair is the first warped by a similarity about the image centre
(rotation within 12 deg, scale 0.9-1.05, shift within 10 px), as
`chip_smoke.py:warp_batch` warps phase 3's photos, with zeros outside.
"""

from __future__ import annotations


import torch
import torch.nn.functional as F

SCALES = (4, 8, 16, 32)


def photos(n: int, height: int, width: int, gen: torch.Generator,
           device) -> torch.Tensor:
    """(n, H, W) float32 textured photos in [0, 1]."""
    img = torch.zeros(n, 1, height, width, device=device)
    for s in SCALES:
        coarse = torch.rand(n, 1, height // s + 1, width // s + 1,
                            generator=gen, device=device)
        img += 0.3 * F.interpolate(coarse, size=(height, width),
                                   mode="bicubic", align_corners=False)
    img = img[:, 0]
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    return (img - lo) / (hi - lo)


def similarity_warps(n: int, height: int, width: int,
                     gen: torch.Generator) -> torch.Tensor:
    """(n, 3, 3) float64 similarities about the image centre, mapping
    first-image pixel coordinates to the second's; drawn on the host
    from the generator (a CPU generator)."""
    u = torch.rand(n, 4, generator=gen, dtype=torch.float64)
    ang = torch.deg2rad(-12 + 24 * u[:, 0])
    sc = 0.9 + 0.15 * u[:, 1]
    tx, ty = -10 + 20 * u[:, 2], -10 + 20 * u[:, 3]
    cx, cy = (width - 1) / 2, (height - 1) / 2
    H = torch.zeros(n, 3, 3, dtype=torch.float64)
    H[:, 0, 0] = sc * torch.cos(ang)
    H[:, 0, 1] = -sc * torch.sin(ang)
    H[:, 1, 0] = sc * torch.sin(ang)
    H[:, 1, 1] = sc * torch.cos(ang)
    H[:, 0, 2] = cx - (H[:, 0, 0] * cx + H[:, 0, 1] * cy) + tx
    H[:, 1, 2] = cy - (H[:, 1, 0] * cx + H[:, 1, 1] * cy) + ty
    H[:, 2, 2] = 1.0
    return H


def warp(imgs: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """imgs (n, H, W) warped by H (n, 3, 3): out(p) = img(H^-1 p),
    bilinear, zero outside."""
    n, h, w = imgs.shape
    Hinv = torch.linalg.inv(H).to(torch.float32).to(imgs.device)
    ys, xs = torch.meshgrid(
        torch.arange(h, device=imgs.device, dtype=torch.float32),
        torch.arange(w, device=imgs.device, dtype=torch.float32),
        indexing="ij")
    p = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    src = torch.einsum("bij,nj->bni", Hinv, p)
    sx = src[..., 0] / src[..., 2]
    sy = src[..., 1] / src[..., 2]
    grid = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], -1)
    out = F.grid_sample(imgs[:, None], grid.reshape(n, h, w, 2),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)[:, 0]
    return out.contiguous()


def pair_pool(batches: int, batch: int, height: int, width: int, seed: int,
              device):
    """`batches` distinct batches of `batch` pairs: (img1, img2) each
    (batches, batch, H, W) on the device, and the warps (batches, batch,
    3, 3) float64 on the host. The same seed gives the same pool."""
    n = batches * batch
    gen = torch.Generator(device=device).manual_seed(seed)
    host = torch.Generator().manual_seed(seed)
    img1 = photos(n, height, width, gen, device)
    H = similarity_warps(n, height, width, host)
    img2 = warp(img1, H)
    shape = (batches, batch, height, width)
    return (img1.reshape(shape), img2.reshape(shape),
            H.reshape(batches, batch, 3, 3))


def corner_error(H_est, H_true, height: int, width: int) -> float:
    """Largest distance (px) between where the two maps send the image
    corners."""
    c = torch.tensor([[0, 0, 1], [width - 1, 0, 1], [0, height - 1, 1],
                      [width - 1, height - 1, 1]], dtype=torch.float64).T
    a = torch.as_tensor(H_est, dtype=torch.float64) @ c
    b = torch.as_tensor(H_true, dtype=torch.float64) @ c
    d = a[..., :2, :] / a[..., 2:, :] - b[..., :2, :] / b[..., 2:, :]
    return float(torch.linalg.vector_norm(d, dim=-2).max())
