"""Image primitives of the SIFT, ORB and dense paths: grayscale,
normalisation, JAX's antialiased linear resize, the separable and the
banded Gaussian blur, octave decimation, Sobel and central gradients, the
box filter and the bilinear homography warp.

Port of `tpu3drec/ops/image.py` less its TPU band warp. Images are
float32 `(..., H, W)` tensors in [0, 1]; every function works on any
number of leading batch dimensions. The blur is two dense matrix products
with a banded reflect-101 Toeplitz matrix, as in the reference; with TF32
off (package import) they run at full float32 on the card. Warps are the
reference's plain four-tap gather (`sample_grid`); its TPU band warp
(`sample_grid_band`) has no counterpart here.
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
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of `jax.image.resize(..., "linear")` along one
    axis, built as JAX's `compute_weight_mat` builds them in float32:
    half-pixel sample positions, a triangle kernel widened by 1/scale when
    downsampling (antialias), columns normalised to sum 1, and samples
    outside the input zeroed. Read-only."""
    f32 = np.float32
    # the forms XLA compiles the reference's expressions to: 1 / scale
    # folded in float64, (i + 0.5) * inv_scale - 0.5 as one fused
    # multiply-add (a float64 product of two float32 values is exact), and
    # the normalisation as a product with the reciprocal of the sum
    inv_scale = f32(n_in / n_out)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = ((np.arange(n_out, dtype=f32) + f32(0.5)).astype(np.float64)
              * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w * (f32(1.0) / np.where(total != 0, total, f32(1.0))),
                 f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, f32(0.0)).astype(f32)
    w.setflags(write=False)
    return w


def resize(img: torch.Tensor, shape) -> torch.Tensor:
    """Resize `(..., H, W)` to `(..., h, w)` as `jax.image.resize(img,
    shape, "linear")` does (antialiased when downsampling; an axis whose
    size does not change is left as it is): two float32 matrix products
    with the reference's weights."""
    h, w = shape
    out = img
    if h != img.shape[-2]:
        wh = torch.tensor(_resize_weights(img.shape[-2], h), device=img.device)
        out = torch.matmul(wh.T, out)
    if w != img.shape[-1]:
        ww = torch.tensor(_resize_weights(img.shape[-1], w), device=img.device)
        out = torch.matmul(out, ww)
    return out


def gaussian_kernel_1d(sigma: float, radius: int = None) -> torch.Tensor:
    """1-D float32 Gaussian taps; radius defaults to ceil(4 sigma)."""
    if radius is None:
        radius = max(1, int(math.ceil(4.0 * sigma)))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, sigma: float,
                  radius: int = None) -> torch.Tensor:
    """Separable Gaussian blur of `(..., H, W)` with reflect padding (two
    1-D convolutions)."""
    if sigma <= 0:
        return img
    taps = gaussian_kernel_1d(sigma, radius)
    return _conv1d(_conv1d(img, taps, 0), taps, 1)


def sobel_gradients(img: torch.Tensor):
    """Sobel dx, dy of `(..., H, W)` (cv2.Sobel ksize=3), reflect-padded."""
    smooth = torch.tensor([1.0, 2.0, 1.0])
    diff = torch.tensor([-1.0, 0.0, 1.0])
    dx = _conv1d(_conv1d(img, smooth, 0), diff, 1)
    dy = _conv1d(_conv1d(img, diff, 0), smooth, 1)
    return dx, dy


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


def central_gradients(img: torch.Tensor):
    """Central-difference dx, dy of `(..., H, W)`, wrapping at the
    borders (`jnp.roll`), as the reference computes them."""
    dx = 0.5 * (torch.roll(img, -1, dims=-1) - torch.roll(img, 1, dims=-1))
    dy = 0.5 * (torch.roll(img, -1, dims=-2) - torch.roll(img, 1, dims=-2))
    return dx, dy


def _conv1d(img: torch.Tensor, taps: torch.Tensor, axis: int) -> torch.Tensor:
    """Reflect-padded 1-D convolution of `(..., H, W)` along axis 0 (rows)
    or 1 (columns) of the image, as a correlation with `taps`."""
    r = taps.shape[0] // 2
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, *img.shape[-2:])
    pad = (0, 0, r, r) if axis == 0 else (r, r, 0, 0)
    x = torch.nn.functional.pad(x, pad, mode="reflect")
    w = taps.to(x).reshape((1, 1, -1, 1) if axis == 0 else (1, 1, 1, -1))
    y = torch.nn.functional.conv2d(x, w)
    return y.reshape(*lead, *y.shape[-2:])


def box_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    """Mean filter of `(..., H, W)` by a separable ones kernel."""
    taps = torch.ones(size, dtype=torch.float32) / size
    return _conv1d(_conv1d(img, taps, 0), taps, 1)


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample `(..., H, W)` at `(..., N, 2)` float (x, y) coordinates,
    bilinear, clamped to the image (cv2.remap BORDER_REPLICATE)."""
    h, w = img.shape[-2:]
    x = torch.clamp(xy[..., 0], 0.0, w - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = x - x0
    fy = y - y0
    # one flat gather for all four taps
    idx = torch.cat([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1], -1)
    taps = torch.gather(img.reshape(*img.shape[:-2], h * w), -1, idx)
    v00, v01, v10, v11 = taps.chunk(4, -1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """Copy a small host tensor to `device` without waiting for the card:
    a copy from pageable memory would first drain the stream, so a CUDA
    copy goes through pinned memory, asynchronously."""
    device = torch.device(device)
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def homography_grid(H: torch.Tensor, out_shape, device=None):
    """Per-output-pixel source coordinates of the FORWARD map H.

    H is (..., 3, 3); returns (sx, sy), each (..., h, w) float32 on
    `device` (default: H's), with [sx, sy, 1] ~ H @ [x, y, 1] for every
    output pixel (x, y). Sampling an image at this grid computes
    out(p) = img(H p); pass H^-1 for the usual inverse warp. H may be
    made on the host: it is copied to `device` (values unchanged)."""
    h, w = out_shape
    dev = H.device if device is None else torch.device(device)
    H = to_device(H.to(torch.float32), dev)[..., None, None]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    # projective division with a sign-preserving |w| guard
    den = H[..., 2, 0, :, :] * xs + H[..., 2, 1, :, :] * ys + H[..., 2, 2, :, :]
    den = torch.sign(den) * torch.clamp(torch.abs(den), min=1e-12)
    sx = (H[..., 0, 0, :, :] * xs + H[..., 0, 1, :, :] * ys
          + H[..., 0, 2, :, :]) / den
    sy = (H[..., 1, 0, :, :] * xs + H[..., 1, 1, :, :] * ys
          + H[..., 1, 2, :, :]) / den
    return sx, sy


def sample_grid(img: torch.Tensor, sx: torch.Tensor,
                sy: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample `(..., H, W)` at `(..., h, w)` coordinate grids,
    clamped (the 2-D form of `bilinear_sample`)."""
    xy = torch.stack([sx.reshape(*sx.shape[:-2], -1),
                      sy.reshape(*sy.shape[:-2], -1)], -1)
    return bilinear_sample(img, xy).reshape(sx.shape)


def grid_in_bounds(shape, sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """Mask of grid positions whose bilinear footprint lies inside an
    (H, W) source image (no border replication involved)."""
    h, w = shape
    return (sx >= 0.0) & (sx <= w - 1.0) & (sy >= 0.0) & (sy <= h - 1.0)


def warp_perspective(img: torch.Tensor, H: torch.Tensor,
                     out_shape) -> torch.Tensor:
    """Inverse-warp an image by homography H (src -> dst), as
    cv2.warpPerspective: samples src at H^-1 @ dst."""
    sx, sy = homography_grid(torch.linalg.inv(H), out_shape,
                             device=img.device)
    return sample_grid(img, sx, sy)
