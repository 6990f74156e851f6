"""Parity of the port's ORB path (tpu3drec_torch.ops.{image.resize, fast,
harris, orb}) with the JAX package's.

- `resize` reproduces `jax.image.resize(..., "linear")`, antialiasing
  included, within 1e-6 at every level shape ORB builds from 120x160,
  240x320 and 480x640.
- FAST scores, Harris responses and NMS masks on `test_image` (240x320):
  scores within 1e-5, masks equal; FAST finds no corner in the 3 px
  border, even where the reference's wrap-around shift sees the opposite
  edge.
- `detect_orb_features` at 240x320, 512 features, both patterns: at
  least 99% of the valid keypoints at the reference's positions within
  1e-3 px, their descriptor bits agreeing on at least 99% (a bit compares
  two samples, so a last-ulp difference can flip it), and a batched
  (B, H, W) call equal to per-image calls (angles within 1e-6: atan2
  rounds one ulp apart in a vectorised and a scalar loop).
- ORB matching (hamming through the plain `knn2`) equals the reference's
  `match_features` on the same descriptors.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import tpu3drec.ops.sift  # noqa: E402,F401  (orb imports it inside its trace)
from tpu3drec.ops import fast as jfast                         # noqa: E402
from tpu3drec.ops import harris as jharris                     # noqa: E402
from tpu3drec.ops import orb as jorb                           # noqa: E402
from tpu3drec.ops.match import match_features as jmatch        # noqa: E402
from tpu3drec_torch.core.types import Features                 # noqa: E402
from tpu3drec_torch.ops import fast as tfast                   # noqa: E402
from tpu3drec_torch.ops import harris as tharris               # noqa: E402
from tpu3drec_torch.ops import image as timage                 # noqa: E402
from tpu3drec_torch.ops import orb as torb                     # noqa: E402
from tpu3drec_torch.ops.match import match_features as tmatch  # noqa: E402

MAX_FEATURES = 512
POS_TOL = 1e-3
SHARE = 0.99


@pytest.mark.parametrize("shape", [(120, 160), (240, 320), (480, 640)])
def test_resize_matches_jax_at_orb_level_shapes(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.uniform(0, 1, shape).astype(np.float32)
    t = torch.from_numpy(img)
    for hw in torb.level_shapes(*shape, 8, 1.2)[1:]:
        ref = np.asarray(jax.image.resize(jnp.asarray(img), hw, "linear"))
        got = timage.resize(t, hw).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=str(hw))


def test_fast_harris_nms_match_jax(test_image):
    j, t = jnp.asarray(test_image), torch.from_numpy(test_image)
    for thr in (20.0 / 255.0, 0.05):
        ref = np.asarray(jfast.fast_score_map(j, thr))
        got = tfast.fast_score_map(t, thr).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got > 0, ref > 0)
    for block in (3, 7):
        ref = np.asarray(jharris.harris_response(j, block))
        got = tharris.harris_response(t, block).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    score = np.array(jfast.fast_score_map(j, 0.05))
    for r in (1, 2):
        np.testing.assert_array_equal(
            tharris.nms_2d(torch.from_numpy(score), r).numpy(),
            np.asarray(jharris.nms_2d(jnp.asarray(score), r)))
    xy, s, m = tfast.detect_fast(t, 64, 0.05)
    rx, rs, rm = jfast.detect_fast(j, 64, 0.05)
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(xy.numpy()[m.numpy()], np.asarray(rx)[np.asarray(rm)])


def test_fast_border_gets_no_corner_from_the_opposite_edge():
    img = np.zeros((40, 48), np.float32)
    img[:, 45:] = 1.0          # a bright strip at the right edge
    img[20:, :2] = 1.0         # and a corner at the left edge
    score = tfast.fast_score_map(torch.from_numpy(img), 0.1).numpy()
    ref = np.asarray(jfast.fast_score_map(jnp.asarray(img), 0.1))
    np.testing.assert_array_equal(score, ref)
    border = np.ones_like(score, bool)
    border[3:-3, 3:-3] = False
    assert not score[border].any()


@pytest.fixture(scope="module")
def orb_pair(test_image):
    """The reference's and the port's ORB of test_image, per pattern."""
    out = {}
    for pattern in ("brief", "opencv"):
        ref = jorb.detect_orb_features(jnp.asarray(test_image),
                                       max_features=MAX_FEATURES,
                                       pattern=pattern)
        got = torb.detect_orb_features(torch.from_numpy(test_image),
                                       max_features=MAX_FEATURES,
                                       pattern=pattern)
        out[pattern] = (ref, got)
    return out


@pytest.mark.parametrize("pattern", ["brief", "opencv"])
def test_orb_keypoints_and_bits_agree_with_jax(orb_pair, pattern):
    ref, got = orb_pair[pattern]
    assert got.desc.shape == (MAX_FEATURES, 256)
    assert got.desc_kind == "binary" and got.image_shape == (240, 320)
    rm, gm = np.asarray(ref.mask), got.mask.numpy()
    assert abs(int(gm.sum()) - int(rm.sum())) <= (1 - SHARE) * rm.sum()
    rxy, gxy = np.asarray(ref.xy), got.xy.numpy()
    same = rm & gm & (np.abs(rxy - gxy).max(1) <= POS_TOL)
    assert same.sum() >= SHARE * rm.sum(), (int(same.sum()), int(rm.sum()))
    np.testing.assert_allclose(got.scale.numpy()[same],
                               np.asarray(ref.scale)[same], rtol=1e-6)
    np.testing.assert_allclose(got.response.numpy()[same],
                               np.asarray(ref.response)[same], rtol=1e-4,
                               atol=1e-6)
    rd, gd = np.asarray(ref.desc)[same], got.desc.numpy()[same]
    assert set(np.unique(gd)) <= {-1.0, 1.0}
    assert (rd == gd).mean() >= SHARE
    # the angles agree up to a last-ulp difference of the moments
    da = np.abs(np.angle(np.exp(1j * (np.asarray(ref.angle)[same]
                                      - got.angle.numpy()[same]))))
    assert np.quantile(da, SHARE) < 1e-3


@pytest.mark.parametrize("pattern", ["brief", "opencv"])
def test_orb_batch_equals_single_images(orb_pair, test_image, pattern):
    _, single = orb_pair[pattern]
    other = np.ascontiguousarray(test_image[::-1, ::-1])
    batch = torb.detect_orb_features(
        torch.from_numpy(np.stack([test_image, other])),
        max_features=MAX_FEATURES, pattern=pattern)
    second = torb.detect_orb_features(torch.from_numpy(other),
                                      max_features=MAX_FEATURES,
                                      pattern=pattern)
    for field in ("xy", "response", "scale", "desc", "mask"):
        b = getattr(batch, field)
        assert torch.equal(b[0], getattr(single, field)), field
        assert torch.equal(b[1], getattr(second, field)), field
    # atan2 may round one ulp apart in a vectorised and a scalar loop
    for i, f in enumerate((single, second)):
        torch.testing.assert_close(batch.angle[i], f.angle, rtol=0, atol=1e-6)


def test_orb_max_features_above_the_level_budgets_pads_to_capacity():
    # tests/test_orb.py's input: the per-level budgets sum below 2000
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (240, 320)).astype(np.float32)
    f = torb.detect_orb_features(torch.from_numpy(img), max_features=2000)
    ref = jorb.detect_orb_features(jnp.asarray(img), max_features=2000)
    assert f.xy.shape == (2000, 2) and f.mask.shape == (2000,)
    assert int(f.mask.sum()) == int(ref.mask.sum()) > 0
    assert float(f.response[~f.mask].abs().max()) == 0.0


def test_orb_matching_equals_jax_on_the_same_descriptors(orb_pair,
                                                        test_image):
    ref, _ = orb_pair["brief"]
    ref2 = jorb.detect_orb_features(jnp.roll(jnp.asarray(test_image), 5, 1),
                                    max_features=MAX_FEATURES)
    feats = [Features(**{k: torch.from_numpy(np.array(getattr(f, k)))
                         for k in ("xy", "response", "scale", "angle",
                                   "desc", "mask")},
                      method="ORB", desc_kind="binary") for f in (ref, ref2)]
    for ratio, cross in ((0.75, False), (0.85, True)):
        a = jmatch(ref, ref2, ratio=ratio, cross_check=cross)
        b = tmatch(feats[0], feats[1], ratio=ratio, cross_check=cross)
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        np.testing.assert_array_equal(b.idx2.numpy()[b.mask.numpy()],
                                      np.asarray(a.idx2)[np.asarray(a.mask)])
        np.testing.assert_array_equal(b.score.numpy(), np.asarray(a.score))
        assert int(b.mask.sum()) > 50


def test_unpack_cv2_orb_like_jax():
    rng = np.random.default_rng(1)
    d = rng.integers(0, 256, (9, 32), dtype=np.uint8)
    np.testing.assert_array_equal(torb.unpack_cv2_orb(d), jorb.unpack_cv2_orb(d))
    np.testing.assert_array_equal(torb.BRIEF_PAIRS, jorb.BRIEF_PAIRS)
