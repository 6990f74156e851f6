"""Parity of the port's stereo path with tpu3drec.ops.stereo on the CPU.

Same numpy inputs through both packages. Tolerances:
- pure data movement and elementwise float32 work done in the same
  order (cost volumes, rolls, WTA/LR, fusion) is exact;
- the SGM recurrence is the reference's float operations in its order:
  rtol 1e-6 / atol 1e-5, the bar of tests/test_pallas_sgm.py (observed:
  bit-equal);
- image warps: rtol/atol 1e-5 (the reference's grids come from its own
  float32 3x3 inverse; observed <= 1e-5 on [0, 1] images);
- stereo on a rotated rig: depth within rtol/atol 1e-4 where both are
  valid and valid masks equal on > 99.9% of pixels, the reference's own
  band-vs-gather bar (tests/test_dense.py:355-359), because the 3x3
  camera math differs at the last float32 bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

from tpu3drec.ops import image as jimg
from tpu3drec.ops import stereo as jst
from tpu3drec.ops.pallas_sgm import sgm_aggregate_batch_pallas
from tpu3drec_torch.ops import image as timg
from tpu3drec_torch.ops import pallas_sgm as tsgm
from tpu3drec_torch.ops import stereo as tst

EXACT = dict(rtol=0, atol=0)
SGM_TOL = dict(rtol=1e-6, atol=1e-5)
WARP_TOL = dict(rtol=1e-5, atol=1e-5)
H, W = 96, 128
FOCAL, BASELINE = 100.0, 0.5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _photo(h, w, seed):
    """Rectangles on a noisy background in [0, 1] (tests/test_dense.py's
    textured photo)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for _ in range(150):
        y, x = rng.integers(0, h - 16), rng.integers(0, w - 16)
        hh, ww = rng.integers(4, 24), rng.integers(4, 24)
        img[y:y + hh, x:x + ww] += rng.uniform(-0.5, 0.5)
    img += 0.05 * rng.standard_normal((h, w)).astype(np.float32)
    img -= img.min()
    img /= img.max()
    return img.astype(np.float32)


def _homography(seed):
    rng = np.random.default_rng(seed)
    Hm = np.eye(3) + np.array([[0.02, -0.03, 4.0], [0.025, 0.01, -3.0],
                               [1e-4, -5e-5, 0.0]]) * rng.uniform(0.5, 1.5)
    return Hm.astype(np.float32)


# ---------------------------------------------------------------------
# image subset
# ---------------------------------------------------------------------

def test_central_gradients_match_jax(test_image):
    gx, gy = timg.central_gradients(_t(test_image))
    jx, jy = jimg.central_gradients(jnp.asarray(test_image))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jy))


@pytest.mark.parametrize("size", [3, 5])
def test_box_filter_matches_jax(test_image, size):
    got = timg.box_filter(_t(test_image), size).numpy()
    ref = np.asarray(jimg.box_filter(jnp.asarray(test_image), size))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_bilinear_sample_matches_jax(test_image):
    rng = np.random.default_rng(1)
    xy = np.stack([rng.uniform(-5, 330, 500), rng.uniform(-5, 250, 500)],
                  1).astype(np.float32)
    got = timg.bilinear_sample(_t(test_image), _t(xy)).numpy()
    ref = np.asarray(jimg.bilinear_sample(jnp.asarray(test_image),
                                          jnp.asarray(xy)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_homography_grid_sample_and_bounds_match_jax(test_image, seed):
    Hm = _homography(seed)
    sx, sy = timg.homography_grid(_t(Hm), test_image.shape)
    jx, jy = jimg.homography_grid(jnp.asarray(Hm), test_image.shape)
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(sy.numpy(), np.asarray(jy))
    got = timg.sample_grid(_t(test_image), sx, sy).numpy()
    ref = np.asarray(jimg.sample_grid(jnp.asarray(test_image), jx, jy))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        timg.grid_in_bounds(test_image.shape, sx, sy).numpy(),
        np.asarray(jimg.grid_in_bounds(test_image.shape, jx, jy)))


def test_batched_homography_grid_is_per_item():
    Hs = np.stack([_homography(0), _homography(1)])
    sx, sy = timg.homography_grid(_t(Hs), (20, 30))
    for i in range(2):
        ex, ey = timg.homography_grid(_t(Hs[i]), (20, 30))
        np.testing.assert_array_equal(sx[i].numpy(), ex.numpy())
        np.testing.assert_array_equal(sy[i].numpy(), ey.numpy())


def test_warp_perspective_matches_jax(test_image):
    Hm = _homography(2)
    got = timg.warp_perspective(_t(test_image), _t(Hm), (200, 300)).numpy()
    ref = np.asarray(jimg.warp_perspective(jnp.asarray(test_image),
                                           jnp.asarray(Hm), (200, 300)))
    np.testing.assert_allclose(got, ref, **WARP_TOL)


# ---------------------------------------------------------------------
# cost volume, SGM, WTA / LR
# ---------------------------------------------------------------------

def _pair(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (24, 40)).astype(np.float32),
            rng.uniform(0, 1, (24, 40)).astype(np.float32))


@pytest.mark.parametrize("D", [1, 16])
def test_cost_volume_and_right_view_are_exact(D):
    left, right = _pair()
    got = tst.cost_volume(_t(left), _t(right), D)
    ref = jst.cost_volume(jnp.asarray(left), jnp.asarray(right), D)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tst._right_view_volume(got).numpy(),
                                  np.asarray(jst._right_view_volume(ref)))


def test_cost_volume_batches_pairs():
    (l0, r0), (l1, r1) = _pair(0), _pair(1)
    got = tst.cost_volume(_t(np.stack([l0, l1])), _t(np.stack([r0, r1])), 8)
    for i, (l, r) in enumerate([(l0, r0), (l1, r1)]):
        np.testing.assert_array_equal(got[i].numpy(),
                                      tst.cost_volume(_t(l), _t(r), 8).numpy())


def _volumes(B, D, h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 2, (B, D, h, w)).astype(np.float32)


# the three shapes of tests/test_pallas_sgm.py, with its penalties; then
# D = 48 (the card's kernel splits D into register tiers) and odd H and W
# (ragged column groups and row chunks on the card)
SGM_CASES = [((2, 32, 24, 40), 0, 15, 90), ((1, 16, 16, 24), 3, 25, 150),
             ((5, 16, 20, 28), 7, 15, 90), ((2, 48, 23, 37), 11, 15, 90),
             ((3, 16, 19, 25), 13, 25, 150)]


@pytest.mark.parametrize("shape,seed,p1,p2", SGM_CASES)
def test_sgm_plain_matches_jax_scan(shape, seed, p1, p2):
    v = _volumes(*shape, seed)
    got = tsgm.sgm_aggregate_batch(_t(v), p1, p2).numpy()
    ref = np.asarray(jst.sgm_aggregate_batch(jnp.asarray(v), p1, p2))
    np.testing.assert_allclose(got, ref, **SGM_TOL)


def test_sgm_plain_matches_pallas_kernel_interpret():
    v = _volumes(1, 16, 16, 24, 3)
    got = tsgm.sgm_aggregate_batch_plain(_t(v), 25, 150).numpy()
    ref = np.asarray(sgm_aggregate_batch_pallas(
        jnp.asarray(v), p1x100=25, p2x100=150, interpret=True))
    np.testing.assert_allclose(got, ref, **SGM_TOL)


def test_sgm_single_volume_and_routing():
    v = _volumes(1, 16, 12, 20, 5)
    got = tst.sgm_aggregate(_t(v[0]))
    np.testing.assert_array_equal(
        got.numpy(), tsgm.sgm_aggregate_batch_plain(_t(v))[0].numpy())
    with pytest.raises(ValueError):
        tsgm.sgm_aggregate_batch(_t(_volumes(1, 200, 4, 4, 0)))
    with pytest.raises(TypeError):
        tsgm.sgm_aggregate_batch(_t(v).double())


def test_winner_take_all_and_lr_check_are_exact():
    v = _volumes(2, 16, 24, 40, 11)
    d, c0 = tst.winner_take_all(_t(v[0]))
    jd, jc0 = jst.winner_take_all(jnp.asarray(v[0]))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(c0.numpy(), np.asarray(jc0))
    fb = torch.tensor(FOCAL) * torch.tensor(BASELINE)
    got = tst._wta_lr_depth(_t(v[0]), _t(v[1]), fb, 1.5)
    ref = jst._wta_lr_depth(jnp.asarray(v[0]), jnp.asarray(v[1]),
                            jnp.float32(FOCAL), jnp.float32(BASELINE), 1.5)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_unrectify_depth_matches_jax():
    import cv2
    rng = np.random.default_rng(0)
    depth = rng.uniform(2, 8, (32, 48)).astype(np.float32)
    valid = rng.uniform(size=(32, 48)) > 0.1
    K = np.array([[100, 0, 24], [0, 100, 16], [0, 0, 1]], np.float32)
    R_new = cv2.Rodrigues(np.array([0.02, -0.04, 0.03]))[0].astype(np.float32)
    H1 = (K @ R_new @ np.linalg.inv(K)).astype(np.float32)
    d, v = tst.unrectify_depth(_t(depth), _t(valid), H1, K, R_new, (32, 48))
    jd, jv = jst.unrectify_depth(jnp.asarray(depth), jnp.asarray(valid),
                                 jnp.asarray(H1), jnp.asarray(K),
                                 jnp.asarray(R_new), (32, 48))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **WARP_TOL)


# ---------------------------------------------------------------------
# two-view and multi-view stereo
# ---------------------------------------------------------------------

def _assert_stereo_close(d_t, v_t, d_j, v_j):
    both = v_t & v_j
    assert both.mean() > 0.25
    assert (v_t == v_j).mean() > 0.999, (v_t == v_j).mean()
    np.testing.assert_allclose(d_t[both], d_j[both], rtol=1e-4, atol=1e-4)


def test_stereo_depth_pair_on_rotated_rig_matches_jax():
    """The rotated-rig scene of tests/test_dense.py at 120x160: a textured
    plane at z = 6, the second view rendered through the plane-induced
    homography with cv2 (the reference with warp_plans=None: gather)."""
    import cv2
    h, w, Z0 = 120, 160, 6.0
    K = np.array([[150.0, 0, w / 2], [0, 150.0, h / 2], [0, 0, 1]])
    ref_img = _photo(h, w, 11)
    R2 = cv2.Rodrigues(np.array([0.03, -0.05, 0.02]))[0]
    t2 = np.array([-0.55, 0.10, 0.12])
    Hp = K @ (R2 + np.outer(t2, [0.0, 0.0, 1.0]) / Z0) @ np.linalg.inv(K)
    img2 = cv2.warpPerspective(ref_img, Hp, (w, h))
    K, R2, t2 = (a.astype(np.float32) for a in (K, R2, t2))
    got = tst.stereo_depth_pair(_t(ref_img), _t(img2), K, K, R2, t2,
                                num_disparities=32)
    ref = jst.stereo_depth_pair(jnp.asarray(ref_img), jnp.asarray(img2),
                                jnp.asarray(K), jnp.asarray(K),
                                jnp.asarray(R2), jnp.asarray(t2),
                                num_disparities=32)
    np.testing.assert_allclose(got["H1"].numpy(), np.asarray(ref["H1"]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["baseline"].numpy(),
                               np.asarray(ref["baseline"]), rtol=1e-6)
    _assert_stereo_close(got["depth"].numpy(), got["valid"].numpy(),
                         np.asarray(ref["depth"]), np.asarray(ref["valid"]))
    d = got["depth"].numpy()[got["valid"].numpy()]
    assert abs(np.median(d) - Z0) < 0.15


def _folder(n_views=3):
    """Reference view plus neighbours: one photo rolled by 5 px per 0.25
    of baseline (a fronto-parallel plane at depth 5)."""
    base = _photo(H, W, 7)
    K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]],
                 np.float32)
    bxs = [0.25 * (i - (n_views - 1) / 2) for i in range(n_views)]
    imgs = [np.roll(base, int(round(20 * bx)), axis=1) for bx in bxs]
    return imgs, K, bxs


@pytest.fixture(scope="module")
def pairs():
    imgs, K, bxs = _folder(4)
    ref = imgs[1]
    others = np.stack([imgs[i] for i in (0, 2, 3)])
    ts = np.stack([np.array([bxs[i] - bxs[1], 0, 0], np.float32)
                   for i in (0, 2, 3)])
    Ks = np.stack([K] * 3)
    Rs = np.stack([np.eye(3, dtype=np.float32)] * 3)
    return ref, others, K, Ks, Rs, ts


def test_pairs_fused_matches_jax(pairs):
    ref, others, K, Ks, Rs, ts = pairs
    got = tst.stereo_depth_pairs_fused(_t(ref), _t(others), K, Ks, Rs, ts,
                                       num_disparities=16)
    exp = jst.stereo_depth_pairs_fused(
        jnp.asarray(ref), jnp.asarray(others), jnp.asarray(K),
        jnp.asarray(Ks), jnp.asarray(Rs), jnp.asarray(ts),
        num_disparities=16)
    for i in range(3):
        _assert_stereo_close(got["depths"][i].numpy(),
                             got["valids"][i].numpy(),
                             np.asarray(exp["depths"][i]),
                             np.asarray(exp["valids"][i]))
    _assert_stereo_close(got["fused_depth"].numpy(),
                         got["fused_valid"].numpy(),
                         np.asarray(exp["fused_depth"]),
                         np.asarray(exp["fused_valid"]))
    np.testing.assert_allclose(got["meta"].numpy(), np.asarray(exp["meta"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["K_rectified0"].numpy(),
                               np.asarray(exp["K_rectified0"]), rtol=1e-6)


def test_pairs_block_and_fuse_blocks_equal_fused(pairs):
    ref, others, K, Ks, Rs, ts = pairs
    fused = tst.stereo_depth_pairs_fused(_t(ref), _t(others), K, Ks, Rs, ts,
                                         num_disparities=16)
    blocks = [tst.stereo_depth_pairs_block(_t(ref), _t(others[s:s + 2]), K,
                                           Ks[s:s + 2], Rs[s:s + 2],
                                           ts[s:s + 2], num_disparities=16)
              for s in (0, 2)]
    d = torch.cat([b["depths"] for b in blocks])
    v = torch.cat([b["valids"] for b in blocks])
    b = torch.cat([b["baselines"] for b in blocks])
    out = tst.fuse_depth_blocks(d, v, b)
    np.testing.assert_array_equal(d.numpy(), fused["depths"].numpy())
    np.testing.assert_array_equal(v.numpy(), fused["valids"].numpy())
    for k in ("fused_depth", "fused_valid", "valid_fractions"):
        np.testing.assert_array_equal(out[k].numpy(), fused[k].numpy())


def _fusion_inputs():
    rng = np.random.default_rng(4)
    depths = rng.uniform(1, 9, (4, 16, 20)).astype(np.float32)
    valids = rng.uniform(size=(4, 16, 20)) > 0.4
    valids[:, 0, 0] = False                     # nothing valid
    valids[:, 0, 1] = [True, True, False, False]    # even count
    valids[:, 0, 2] = [True, True, True, False]     # odd count
    return depths, valids, np.array([1.0, 3.0, 2.0, 0.5], np.float32)


@pytest.mark.parametrize("method", ["weighted", "median", "best"])
def test_fuse_depth_maps_matches_jax(method):
    depths, valids, base = _fusion_inputs()
    got, gv = tst.fuse_depth_maps(_t(depths), _t(valids), _t(base), method)
    ref, rv = jst.fuse_depth_maps(jnp.asarray(depths), jnp.asarray(valids),
                                  jnp.asarray(base), method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    if method == "median":
        # the two middle values are averaged, as jnp.nanmedian does
        assert got[0, 1] == (depths[0, 0, 1] + depths[1, 0, 1]) * 0.5
        assert got[0, 0] == 0.0


def test_fuse_depth_maps_rejects_unknown_method():
    depths, valids, base = _fusion_inputs()
    with pytest.raises(ValueError):
        tst.fuse_depth_maps(_t(depths), _t(valids), _t(base), "mean")
