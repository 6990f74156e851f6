"""Parity of the plain `ori_desc` (tpu3drec_torch.ops.pallas_sample) with the
reference's numpy oracle and its Pallas kernel (interpret mode on the CPU).

Bars are the reference's kernel-vs-oracle bars
(tests/test_pallas_sample.py): angle within 1e-3 rad (circular) and
descriptor cosine above 0.9999. They absorb the summation order and the
reference's polynomial atan2 (1.4e-5 rad)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

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


@pytest.mark.parametrize("kind", ["mixed", "all_invalid", "all_valid"])
def test_ori_desc_wrapper_on_cpu_zeroes_exactly_the_invalid_slots(kind):
    """The wrapper's CPU route on the slot mixes the kernel lists on the
    card: invalid slots all zero, valid slots within the oracle's bars."""
    S, H, W = 4, 96, 128
    rng = np.random.default_rng(9)
    K = 7
    xs = rng.uniform(10, W - 10, K).astype(np.float32)
    ys = rng.uniform(10, H - 10, K).astype(np.float32)
    layer = rng.integers(1, 4, K).astype(np.int32)
    scl = rng.uniform(1.6, 3.5, K).astype(np.float32)
    keep = {"mixed": rng.random(K) < 0.5, "all_invalid": np.zeros(K, bool),
            "all_valid": np.ones(K, bool)}[kind]
    _check_against_oracle(S, H, W, xs, ys, layer, scl, keep, seed=11)


# ---------------------------------------------------------------------
# the kernel's crop (support_boxes)
# ---------------------------------------------------------------------

def _weighted_pixels(dxs, dys, meta, hp, fb):
    """For each valid slot, the in-image window pixels to which the
    reference gives a non-zero band or descriptor weight, as a
    (k, rows, 128) mask with their absolute rows and columns. Geometry and
    angle are the JAX package's: its kernel's fixed-point rounding of the
    meta, `_row_starts`, and `oracle_ori_desc`'s angle."""
    _, h, w = dxs.shape
    sel = torch.nonzero(meta[:, 3] >= 0)[:, 0]
    m = meta[sel].numpy().astype(np.int64)
    dxb, dyb = dxs.float().numpy(), dys.float().numpy()
    q = np.float32(1.0 / (1 << fb))
    half = 1 << (fb - 1)
    geo = []
    for xq, yq, sclq, lay in m:
        x, y = np.float32(xq) * q, np.float32(yq) * q
        scl = np.float32(sclq) * np.float32(1.0 / 1024.0)
        rxi, ryi = (xq + half) >> fb, (yq + half) >> fb
        ys0, ysb = jps._row_starts(int(ryi), hp)
        a, _ = jps.oracle_ori_desc(dxb[lay], dyb[lay], float(x), float(y),
                                   float(scl), hp=hp)
        geo.append((x, y, scl, a, rxi - 64, ys0, ysb))
    x, y, scl, angle = (torch.tensor(np.array([g[i] for g in geo]),
                                     dtype=torch.float32) for i in range(4))
    xs0, ys0, ysb = (torch.tensor([int(g[i]) for g in geo]) for i in (4, 5, 6))
    y0 = torch.minimum(ys0, ysb)                     # the 96-row window
    rows = y0[:, None] + torch.arange(tps.WIN_H)
    cols = xs0[:, None] + torch.arange(tps.CORE_W)
    rx = (cols.float() - x[:, None])[:, None, :]
    ry = (rows.float() - y[:, None])[:, :, None]
    in_band = ((rows >= ysb[:, None]) & (rows < ysb[:, None] + tps.ORI_H))
    in_core = ((rows >= ys0[:, None]) & (rows < ys0[:, None] + tps.CORE_H))
    s = scl[:, None, None]
    band = (((rx / s).abs() <= tps.ORI_RADIUS_FCTR)
            & ((ry / s).abs() <= tps.ORI_RADIUS_FCTR) & in_band[:, :, None])
    a = angle[:, None, None]
    ca, sa = torch.cos(a), torch.sin(a)
    inv_hw = 1.0 / (tps.DESC_SCL_FCTR * s)
    ud = (ca * rx + sa * ry) * inv_hw
    vd = (-sa * rx + ca * ry) * inv_hw
    desc = ((vd + 1.5 > -1) & (vd + 1.5 < tps.DESC_D) & (ud + 1.5 > -1)
            & (ud + 1.5 < tps.DESC_D) & in_core[:, :, None])
    inside = (((rows >= 0) & (rows < h))[:, :, None]
              & ((cols >= 0) & (cols < w))[:, None, :])
    return sel, (band | desc) & inside, rows, cols, x, y, scl


def _assert_boxes_cover_support(dxs, dys, meta, hp, fb):
    _, h, w = dxs.shape
    sel, need, rows, cols, x, y, scl = _weighted_pixels(dxs, dys, meta, hp, fb)
    assert need.any(1).any(1).all()
    box = tps.support_boxes(meta, hp, fb, h, w)[sel].to(torch.int64)
    r, c = rows[:, :, None], cols[:, None, :]
    in_box = ((r >= box[:, 0, None, None]) & (r < box[:, 1, None, None])
              & (c >= box[:, 2, None, None]) & (c < box[:, 3, None, None]))
    assert not (need & ~in_box).any()
    # and inside the support disc, where the kernel loads gradients
    d2 = ((c.float() - x[:, None, None]) ** 2
          + (r.float() - y[:, None, None]) ** 2)
    rd = tps.support_radius(scl)[:, None, None]
    assert not (need & (d2 > rd * rd)).any()
    # within the window columns and the image
    assert (box[:, 0] >= 0).all() and (box[:, 1] <= h).all()
    assert (box[:, 2] >= 0).all() and (box[:, 3] <= w).all()
    assert ((box[:, 3] - box[:, 2]) <= tps.CORE_W).all()


def test_support_boxes_cover_every_weighted_pixel(test_image):
    from tpu3drec_torch.ops.sift import octave_samples
    imgs = torch.from_numpy(np.asarray(test_image, np.float32))[None]
    n = 0
    for oc in octave_samples(imgs, 256):
        if bool((oc.meta[:, 3] >= 0).any()):
            _assert_boxes_cover_support(oc.dxs, oc.dys, oc.meta, oc.hp, oc.fb)
            n += int((oc.meta[:, 3] >= 0).sum())
    assert n > 50


@pytest.mark.parametrize("H, W", [(120, 160), (30, 40), (30, 39)])
def test_support_boxes_at_borders_and_largest_scale(H, W):
    """Corners, edge midpoints and near-edge keypoints at the detector's
    largest scale, two smaller ones and one at 5 px (beyond the
    detector's range), at octave-0-like, octave-4-like and odd sizes."""
    S = 6
    dx, dy, _, _, Hp, Wp = _grad_stacks(S, H, W, seed=4)
    big = 1.6 * 2 ** (3.5 / 3)                        # the detector's largest
    xs = np.array([0, W - 1, 0, W - 1, (W - 1) / 2, (W - 1) / 2, 0, W - 1,
                   0.3, 0.26 * W, 0.6 * W], np.float32)
    ys = np.array([0, 0, H - 1, H - 1, 0, H - 1, (H - 1) / 2, (H - 1) / 2,
                   H - 2.1, 2.2, 0.4 * H], np.float32)
    scl = np.full(len(xs), big, np.float32)
    scl[-3:] = [2.02, 3.1, 5.0]
    layer = np.arange(len(xs), dtype=np.int32) % 3 + 1
    meta = tps.prep_meta(torch.from_numpy(xs), torch.from_numpy(ys),
                         torch.from_numpy(layer), torch.from_numpy(scl),
                         torch.ones(len(xs), dtype=torch.bool), Hp, Wp)
    _assert_boxes_cover_support(_bf16(dx), _bf16(dy), meta, Hp,
                                tps.frac_bits(Hp, Wp))
