"""Parity of the plain `ori_desc` (tpu3drec_torch.ops.pallas_sample) with the
reference's numpy oracle and its Pallas kernel (interpret mode on the CPU).

Bars are the reference's kernel-vs-oracle bars
(tests/test_pallas_sample.py): angle within 1e-3 rad (circular) and
descriptor cosine above 0.9999. They absorb the summation order and the
reference's polynomial atan2 (1.4e-5 rad)."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from tpu3drec.ops import pallas_sample as jps
from tpu3drec_torch.ops import pallas_sample as tps


def _grad_stacks(S, H, W, seed=0):
    """(S, H, W) f32 gradients and the reference's zero-padded stacks."""
    rng = np.random.default_rng(seed)
    dx = rng.standard_normal((S, H, W)).astype(np.float32) * 0.1
    dy = rng.standard_normal((S, H, W)).astype(np.float32) * 0.1
    Hp, Wp = jps.pad_dims(H, W)
    pad = ((0, 0), (0, Hp - H), (0, Wp - W))
    return dx, dy, np.pad(dx, pad), np.pad(dy, pad), Hp, Wp


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _bars(angle, desc, a_ref, d_ref):
    da = abs(float(a_ref) - float(angle))
    da = min(da, 2 * np.pi - da)
    cos = float(desc @ d_ref) / max(
        float(np.linalg.norm(desc) * np.linalg.norm(d_ref)), 1e-9)
    assert da < 1e-3, da
    assert cos > 0.9999, cos


def _check_against_oracle(S, H, W, xs, ys, layer, scl, keep, seed):
    dx, dy, _, _, Hp, Wp = _grad_stacks(S, H, W, seed)
    fb = tps.frac_bits(Hp, Wp)
    meta = tps.prep_meta(torch.from_numpy(xs), torch.from_numpy(ys),
                         torch.from_numpy(layer), torch.from_numpy(scl),
                         torch.from_numpy(keep), Hp, Wp)
    angle, desc = tps.ori_desc_windows(_bf16(dx), _bf16(dy), meta, Hp, fb)
    angle, desc = angle.numpy(), desc.numpy()
    dxb = _bf16(dx).float().numpy()
    dyb = _bf16(dy).float().numpy()
    m = meta.numpy()
    q = 1.0 / (1 << fb)
    for k in range(len(xs)):
        if not keep[k]:
            assert angle[k] == 0 and np.all(desc[k] == 0)
            continue
        # the oracle fed the quantised coordinates the kernel sees
        a_ref, d_ref = jps.oracle_ori_desc(
            dxb[layer[k]], dyb[layer[k]], m[k, 0] * q, m[k, 1] * q,
            m[k, 2] / 1024.0, hp=Hp)
        _bars(angle[k], desc[k], a_ref, d_ref)


def test_plain_matches_oracle_interior_and_all_four_borders():
    S, H, W = 6, 120, 160
    rng = np.random.default_rng(1)
    xs = np.concatenate([rng.uniform(55, W - 55, 5),
                         [3.3, W - 4.6, 80.2, 71.9, 2.1, W - 2.8]])
    ys = np.concatenate([rng.uniform(45, H - 45, 5),
                         [60.7, 58.1, 2.6, H - 3.4, 3.9, H - 2.2]])
    K = len(xs)
    layer = rng.integers(1, 4, K).astype(np.int32)
    scl = rng.uniform(1.6, 3.5, K).astype(np.float32)
    keep = np.ones(K, bool)
    keep[4] = False
    _check_against_oracle(S, H, W, xs.astype(np.float32),
                          ys.astype(np.float32), layer, scl, keep, seed=0)


def test_plain_matches_oracle_beyond_1024px():
    """fb = 5 on a 2048-wide stack, keypoints past 1024 px."""
    S, H, W = 2, 160, 2000
    assert tps.frac_bits(*jps.pad_dims(H, W)) == 5
    xs = np.array([1500.37, 1980.12, 700.81], np.float32)
    ys = np.array([80.22, 100.61, 60.44], np.float32)
    _check_against_oracle(S, H, W, xs, ys, np.ones(3, np.int32),
                          np.array([2.0, 3.1, 1.7], np.float32),
                          np.ones(3, bool), seed=7)


def test_plain_matches_jax_kernel_interpret():
    """One shape through the reference's Pallas kernel (interpret mode)."""
    S, H, W = 4, 96, 128
    dx, dy, dxp, dyp, Hp, Wp = _grad_stacks(S, H, W, seed=2)
    rng = np.random.default_rng(3)
    K = 8
    xs = rng.uniform(8, W - 8, K).astype(np.float32)
    ys = rng.uniform(8, H - 8, K).astype(np.float32)
    layer = rng.integers(1, 4, K).astype(np.int32)
    scl = rng.uniform(1.6, 3.0, K).astype(np.float32)
    keep = np.ones(K, bool)
    keep[5] = False
    imeta, dims = jps.prep_meta(jnp.asarray(xs), jnp.asarray(ys),
                                jnp.asarray(layer), jnp.asarray(scl),
                                jnp.asarray(keep), Hp, Wp, H, W)
    a_ref, d_ref = jax.jit(jps.ori_desc_windows)(
        jnp.asarray(dxp, jnp.bfloat16), jnp.asarray(dyp, jnp.bfloat16),
        imeta, dims)
    a_ref, d_ref = np.asarray(a_ref), np.asarray(d_ref)
    meta = tps.prep_meta(torch.from_numpy(xs), torch.from_numpy(ys),
                         torch.from_numpy(layer), torch.from_numpy(scl),
                         torch.from_numpy(keep), Hp, Wp)
    angle, desc = tps.ori_desc_windows(_bf16(dx), _bf16(dy), meta, Hp,
                                       tps.frac_bits(Hp, Wp))
    for k in range(K):
        if not keep[k]:
            assert angle[k] == 0 and a_ref[k] == 0
            assert np.all(desc[k].numpy() == 0) and np.all(d_ref[k] == 0)
            continue
        _bars(angle[k], desc[k].numpy(), a_ref[k], d_ref[k])


def test_prep_meta_quantises_like_the_reference():
    rng = np.random.default_rng(5)
    K = 64
    for (hp, wp, h, w) in [(480, 768, 480, 640), (1088, 2048, 1080, 2040)]:
        xs = rng.uniform(0, w - 1, K).astype(np.float32)
        ys = rng.uniform(0, h - 1, K).astype(np.float32)
        xs[:4] = [0.5 / 64, 37.25, 1.0 / 128, 12.0]   # exact half-steps
        layer = rng.integers(1, 6, K).astype(np.int32)
        scl = rng.uniform(1.5, 4.0, K).astype(np.float32)
        keep = rng.random(K) > 0.3
        imeta, _ = jps.prep_meta(jnp.asarray(xs), jnp.asarray(ys),
                                 jnp.asarray(layer), jnp.asarray(scl),
                                 jnp.asarray(keep), hp, wp, h, w)
        im = np.asarray(imeta).astype(np.int64)
        m = tps.prep_meta(torch.from_numpy(xs), torch.from_numpy(ys),
                          torch.from_numpy(layer), torch.from_numpy(scl),
                          torch.from_numpy(keep), hp, wp).numpy()
        np.testing.assert_array_equal(m[:, 0], im[:, 1] & 0xFFFF)
        np.testing.assert_array_equal(m[:, 1], (im[:, 1] >> 16) & 0xFFFF)
        np.testing.assert_array_equal(m[keep, 2], (im[keep, 0] >> 16) & 0xFFFF)
        np.testing.assert_array_equal(m[:, 3], (im[:, 0] & 0xFFFF) - 1)
        assert tps.frac_bits(hp, wp) == jps.frac_bits(hp, wp)
        assert tps.pad_dims(h, w) == jps.pad_dims(h, w)
