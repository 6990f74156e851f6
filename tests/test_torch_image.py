"""Parity of tpu3drec_torch.ops.image with tpu3drec.ops.image.

Same numpy inputs through both; tolerance rtol = atol = 1e-6 (float32
products summed in another order; values are in [0, 1])."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

from tpu3drec.ops import image as jimg
from tpu3drec_torch.ops import image as timg

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,sigma", [(37, 1.2), (240, 1.2489996),
                                     (320, 2.5398417), (30, 4.0)])
def test_band_matrix_is_the_reference_matrix(n, sigma):
    np.testing.assert_array_equal(timg._band_matrix(n, sigma),
                                  jimg._band_matrix(n, sigma))


@pytest.mark.parametrize("sigma", [1.2489996, 2.0])
def test_gaussian_blur_matmul_matches_jax(test_image, sigma):
    imgs = np.stack([test_image, test_image[::-1, ::-1].copy()])
    got = timg.gaussian_blur_matmul(torch.from_numpy(imgs), sigma).numpy()
    for b in range(2):
        ref = np.asarray(jimg.gaussian_blur_matmul(jnp.asarray(imgs[b]), sigma))
        np.testing.assert_allclose(got[b], ref, **TOL)


def test_downsample2_matches_jax(test_image):
    got = timg.downsample2(torch.from_numpy(test_image)).numpy()
    ref = np.asarray(jimg.downsample2(jnp.asarray(test_image)))
    np.testing.assert_array_equal(got, ref)


def test_rgb_to_gray_and_normalize_u8_match_jax():
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
    f = np.asarray(jimg.normalize_u8(jnp.asarray(u8)))
    np.testing.assert_allclose(timg.normalize_u8(torch.from_numpy(u8)).numpy(),
                               f, **TOL)
    np.testing.assert_allclose(timg.rgb_to_gray(torch.from_numpy(f)).numpy(),
                               np.asarray(jimg.rgb_to_gray(jnp.asarray(f))),
                               **TOL)
    gray = f[..., 0]
    np.testing.assert_array_equal(
        timg.rgb_to_gray(torch.from_numpy(gray)).numpy(), gray)
