"""Image primitives on the SIFT path: grayscale, normalisation, the banded
Gaussian blur and octave decimation.

Port of the main-path subset of `tpu3drec/ops/image.py`. Images are
float32 `(..., H, W)` tensors in [0, 1]; every function works on any
number of leading batch dimensions. The blur is two dense matrix products
with a banded reflect-101 Toeplitz matrix, as in the reference; with TF32
off (package import) they run at full float32 on the card.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# ITU-R BT.601 luma weights — same as cv2.cvtColor(BGR2GRAY)/(RGB2GRAY)
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) RGB -> (..., H, W) float32 gray; 2-D input passes
    through (as float32)."""
    img = img.to(torch.float32)
    if img.ndim == 2:
        return img
    return img @ torch.from_numpy(_LUMA).to(img.device)


def normalize_u8(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1]."""
    return img.to(torch.float32) * (1.0 / 255.0)


@functools.lru_cache(maxsize=256)
def _band_matrix(n: int, sigma: float, radius: int = None) -> np.ndarray:
    """(n, n) banded Toeplitz blur matrix with reflect-101 boundary.

    Taps are built in float64 and the matrix accumulated in float32,
    exactly as the reference builds it, so both packages blur with the
    same constants. The cache holds read-only numpy arrays."""
    if radius is None:
        radius = max(1, int(math.ceil(4.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    taps = np.exp(-0.5 * (x / sigma) ** 2)
    taps /= taps.sum()
    B = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    for k, w in zip(range(-radius, radius + 1), taps):
        j = idx + k
        j = np.where(j < 0, -j, j)
        j = np.where(j >= n, 2 * (n - 1) - j, j)
        B[idx, j] += w
    B.setflags(write=False)
    return B


def band_matrix(n: int, sigma: float, device) -> torch.Tensor:
    """`_band_matrix` as a float32 tensor on `device`."""
    return torch.tensor(_band_matrix(n, float(sigma)), device=device)


def gaussian_blur_matmul(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur of `(..., H, W)` as `B_h @ img @ B_w^T`."""
    if sigma <= 0:
        return img
    h, w = img.shape[-2:]
    bh = band_matrix(h, sigma, img.device)
    bw = band_matrix(w, sigma, img.device)
    return torch.matmul(torch.matmul(bh, img), bw.T)


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour decimation (SIFT octave downsampling)."""
    return img[..., ::2, ::2]
