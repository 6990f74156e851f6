"""Parity of the port's other detectors (tpu3drec_torch.ops.{akaze, brisk,
harris, sift}) with the JAX package's.

Inputs are tests/test_sift.py's `photo` (256x320) and the conftest
`test_image` (240x320), at feature counts the JAX tests already compile.
Each reference result is computed once per module.

- BRISK's frozen pattern tables and AKAZE's FED schedule equal the
  reference's exactly.
- `resize` is within 3.3e-7 of `jax.image.resize(..., "linear")` at
  AKAZE's and BRISK's octave shapes and at SIFT `upscale`'s 2x.
- AKAZE's scale space. The reference's FED cycles amplify a last-ulp
  difference of their input without bound at the coarse levels: its own
  jitted evolution of `photo` and of `photo` moved by one ulp per pixel
  differ by 1.8e-7 at level 0, 1.6e-5 at level 8 and 137 at level 15
  (values that should stay in [0, 1]). So a level is held within 1e-5
  where that self-difference is under 1e-5, and within 4x the
  self-difference elsewhere; keypoints are compared on the levels where
  it is under 1e-5. k^2 is a percentile of a gradient magnitude, whose
  central differences cancel: the blur's 1-2 ulp (XLA:CPU's convolution
  sums in another order) become ~2e-5 relative near the percentile, and
  the reference's own k^2 moves by the same order under the one-ulp
  input change, so k^2 is held within 5e-5 relative.
- AKAZE, BRISK, Harris and GFTT: valid keypoints matched by position
  (and scale), never by slot; >= 99% of the reference's found, responses
  within rtol 1e-4 and angles within 1e-4 rad on >= 99% of the shared
  ones, binary bits agreeing >= 99%; the SIFT-style descriptors of
  Harris and GFTT at cosine > 0.9999.
- SIFT's gather sampler (`sampler="xla"`) and `upscale` against the
  reference's `sampler="xla"`, with and without `upscale`, by
  tests/test_torch_sift.py's bars (keypoints within 1e-4 px, angles
  within 1e-3 rad, descriptors at cosine > 0.9999).
- A (3, H, W) batch equals per-image calls for each new detector (angles
  within 1e-6: torch's vectorised and scalar atan2 loops round apart).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_sift import photo  # noqa: E402,F401  (the fixture)

import tpu3drec.ops.sift  # noqa: E402,F401  (akaze, brisk import it in traces)
from tpu3drec.ops import akaze as jakaze                       # noqa: E402
from tpu3drec.ops import brisk as jbrisk                       # noqa: E402
from tpu3drec.ops import harris as jharris                     # noqa: E402
from tpu3drec.ops.sift import detect_and_compute as jsift      # noqa: E402
import tpu3drec_torch as tv                                    # noqa: E402
from tpu3drec_torch.ops import akaze as takaze                 # noqa: E402
from tpu3drec_torch.ops import brisk as tbrisk                 # noqa: E402
from tpu3drec_torch.ops import harris as tharris               # noqa: E402
from tpu3drec_torch.ops import image as timage                 # noqa: E402
from tpu3drec_torch.ops import sift as tsift                   # noqa: E402

SHARE = 0.99
POS_TOL = 1e-3
MAXF = 512          # tests/test_akaze_brisk.py's count
CORNERS = 300       # tests/test_sift.py's Harris count
SIFT_MAXF = 256     # tests/test_torch_sift.py's count
STABLE = 1e-5       # scale-space agreement where the reference is stable


def _np(f):
    return {k: np.asarray(getattr(f, k)) for k in
            ("xy", "response", "scale", "angle", "desc", "mask")}


def _tnp(f):
    return {k: getattr(f, k).numpy() for k in
            ("xy", "response", "scale", "angle", "desc", "mask")}


def shared(ref, got, keep=None):
    """Valid reference keypoints (those `keep` selects) and their port
    counterparts at the same scale within POS_TOL px: (ref rows, port
    rows)."""
    rv = np.nonzero(ref["mask"] & (True if keep is None else keep(ref)))[0]
    gv = np.nonzero(got["mask"] & (True if keep is None else keep(got)))[0]
    d = np.abs(ref["xy"][rv][:, None] - got["xy"][gv][None]).max(-1)
    d = np.where(np.isclose(ref["scale"][rv][:, None],
                            got["scale"][gv][None], rtol=1e-6), d, np.inf)
    j = d.argmin(1) if len(gv) else np.zeros(len(rv), int)
    ok = d[np.arange(len(rv)), j] <= POS_TOL if len(gv) else np.zeros(len(rv), bool)
    return rv[ok], gv[j[ok]], len(rv), len(gv)


def angle_diff(a, b):
    return np.abs(np.angle(np.exp(1j * (a.astype(np.float64) - b))))


def assert_agree(ref, got, keep=None, binary=True):
    ir, ig, nr, ng = shared(ref, got, keep)
    assert nr > 50, nr
    assert len(ir) >= SHARE * nr, (len(ir), nr)
    assert abs(ng - nr) <= (1 - SHARE) * nr, (ng, nr)
    rr, gr = ref["response"][ir], got["response"][ig]
    assert np.mean(np.abs(gr - rr) <= 1e-4 * np.abs(rr)) >= SHARE
    assert np.mean(angle_diff(ref["angle"][ir], got["angle"][ig]) <= 1e-4) \
        >= SHARE
    rd, gd = ref["desc"][ir], got["desc"][ig]
    if binary:
        assert set(np.unique(gd)) <= {-1.0, 1.0}
        assert (rd == gd).mean() >= SHARE
    else:
        cos = (rd * gd).sum(1) / np.maximum(
            np.linalg.norm(rd, axis=1) * np.linalg.norm(gd, axis=1), 1e-12)
        assert np.mean(cos > 0.9999) >= SHARE, np.sort(cos)[:5]
    return len(ir), nr


# ---- frozen tables and static schedules --------------------------------

def test_brisk_tables_are_the_reference_arrays():
    from tpu3drec_torch.ops import _brisk_pattern as tp
    for name in ("PATTERN", "SHORT_PAIRS", "LONG_PAIRS"):
        a, b = getattr(tp, name), getattr(jbrisk, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tp.SHORT_PAIRS.shape == (512, 2) and tp.LONG_PAIRS.shape == (256, 2)


def test_fed_schedule_equals_the_reference():
    steps = 0
    prev = 0.5 * takaze.SIGMA0 ** 2
    for o in range(4):
        for sub in range(takaze.N_SUBLEVELS):
            t = 0.5 * (takaze.SIGMA0 * 2.0 ** (o + sub / 4)) ** 2
            got = takaze.fed_tau_schedule(t - prev)
            assert got == jakaze.fed_tau_schedule(t - prev)
            steps += len(got)
            prev = t
    assert steps == 166
    for T in (0.0, -1.0, 0.01, 1.0, 7.3, 250.0):
        assert takaze.fed_tau_schedule(T) == jakaze.fed_tau_schedule(T)


@pytest.mark.parametrize("shape", [(480, 640), (256, 320), (240, 320)])
def test_resize_matches_jax_at_detector_shapes(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.uniform(0, 1, shape).astype(np.float32)
    t = torch.from_numpy(img)
    sizes = set(takaze.level_shapes(*shape, 4)[1:])
    sizes |= set(tbrisk.level_shapes(*shape, 3)[1:])
    sizes.add((2 * shape[0], 2 * shape[1]))
    for hw in sorted(sizes):
        ref = np.asarray(jax.image.resize(jnp.asarray(img), hw, "linear"))
        got = timage.resize(t, hw).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=3.3e-7,
                                   err_msg=str(hw))


# ---- AKAZE ---------------------------------------------------------------

def _ref_levels(img, k2):
    h, w = img.shape
    fn = jax.jit(lambda im, k: [L for (_, _, _, L) in
                                jakaze.evolve_scale_space(im, k, 4, h, w)])
    return [np.asarray(L) for L in fn(jnp.asarray(img), k2)]


@pytest.fixture(scope="module")
def akaze_ref(photo):
    """The reference's k^2, scale space (of `photo` and of `photo` moved
    by one ulp per pixel: its own sensitivity per level) and features."""
    img = jnp.asarray(photo)
    k2 = jax.jit(jakaze._contrast_k2)(img)
    rng = np.random.default_rng(0)
    nudged = np.nextafter(photo, np.where(rng.random(photo.shape) < 0.5,
                                          2.0, -1.0).astype(np.float32))
    k2n = jax.jit(jakaze._contrast_k2)(jnp.asarray(nudged))
    levels = _ref_levels(photo, k2)
    self_diff = [float(np.abs(a - b).max())
                 for a, b in zip(levels, _ref_levels(nudged, k2))]
    feats = _np(jakaze.detect_akaze_features(img, max_features=MAXF))
    return dict(k2=float(k2), k2_nudged=float(k2n), levels=levels,
                self_diff=self_diff, feats=feats)


@pytest.fixture(scope="module")
def akaze_port(photo):
    return _tnp(takaze.detect_akaze_features(torch.from_numpy(photo),
                                             max_features=MAXF))


def test_akaze_contrast_factor_matches_jax(photo, akaze_ref):
    k2 = float(takaze._contrast_k2(torch.from_numpy(photo)[None])[0])
    ref = akaze_ref["k2"]
    # the reference's own k^2 moves by this much under a one-ulp input
    # change; the port's is held at 5e-5 relative
    own = abs(akaze_ref["k2_nudged"] - ref) / ref
    assert abs(k2 - ref) / ref <= 5e-5, (k2, ref, own)


def test_akaze_scale_space_matches_jitted_jax(photo, akaze_ref):
    k2 = torch.tensor([akaze_ref["k2"]], dtype=torch.float32)
    got = takaze.evolve_scale_space(torch.from_numpy(photo)[None], k2, 4)
    assert len(got) == len(akaze_ref["levels"]) == 16
    stable = 0
    for i, ((o, sub, sigma, L), ref, own) in enumerate(
            zip(got, akaze_ref["levels"], akaze_ref["self_diff"])):
        assert L.shape[1:] == ref.shape, i
        diff = float(np.abs(L[0].numpy() - ref).max())
        if own < STABLE:
            stable += 1
            assert diff <= STABLE, (i, diff)
        else:
            assert diff <= 4 * own, (i, diff, own)
    # octaves 0 and 1 are stable on this image
    assert stable >= 8, akaze_ref["self_diff"]


def _stable_scales(akaze_ref):
    """Keypoint scales (6 sigma) of the levels the reference evolves
    stably (its own one-ulp difference under STABLE)."""
    out = []
    for i, own in enumerate(akaze_ref["self_diff"]):
        o, sub = divmod(i, takaze.N_SUBLEVELS)
        if own < STABLE:
            out.append(np.float32(takaze.SIGMA0 * 2.0 ** (o + sub / 4)
                                  / 2.0 ** o) * np.float32(2.0 ** o * 6.0))
    return np.asarray(out, np.float32)


def test_akaze_keypoints_angles_and_bits_agree_with_jax(akaze_ref, akaze_port):
    ref, got = akaze_ref["feats"], akaze_port
    assert got["desc"].shape == (MAXF, 486)
    scales = _stable_scales(akaze_ref)

    def keep(f):
        return np.isclose(f["scale"][:, None], scales[None], rtol=1e-6).any(1)

    n, total = assert_agree(ref, got, keep)
    assert total >= 0.5 * ref["mask"].sum()
    assert not got["response"][~got["mask"]].any()


# ---- BRISK ---------------------------------------------------------------

@pytest.fixture(scope="module")
def brisk_pair(photo):
    ref = _np(jbrisk.detect_brisk_features(jnp.asarray(photo),
                                           max_features=MAXF))
    got = _tnp(tbrisk.detect_brisk_features(torch.from_numpy(photo),
                                            max_features=MAXF))
    return ref, got


def test_brisk_keypoints_angles_and_bits_agree_with_jax(brisk_pair):
    ref, got = brisk_pair
    assert got["desc"].shape == (MAXF, 512)
    assert_agree(ref, got)
    np.testing.assert_array_equal(np.unique(got["scale"][got["mask"]]),
                                  np.unique(ref["scale"][ref["mask"]]))


def test_brisk_threshold_in_0_255_units_is_divided():
    img = np.random.default_rng(3).uniform(0, 1, (64, 80)).astype(np.float32)
    t = torch.from_numpy(img)
    a = tbrisk.detect_brisk_features(t, max_features=128, threshold=30)
    b = tbrisk.detect_brisk_features(t, max_features=128,
                                     threshold=30 / 255.0)
    assert torch.equal(a.mask, b.mask) and torch.equal(a.desc, b.desc)
    assert float(a.scale[a.mask].max()) <= 48.0


# ---- Harris and GFTT -----------------------------------------------------

@pytest.fixture(scope="module")
def corner_pairs(photo):
    out = {}
    for use_harris in (True, False):
        ref = _np(jharris.detect_harris_features(
            jnp.asarray(photo), max_features=CORNERS, use_harris=use_harris))
        got = _tnp(tharris.detect_harris_features(
            torch.from_numpy(photo), max_features=CORNERS,
            use_harris=use_harris))
        out[use_harris] = (ref, got)
    return out


def test_shi_tomasi_response_matches_jax(test_image):
    ref = np.asarray(jharris.shi_tomasi_response(jnp.asarray(test_image)))
    got = tharris.shi_tomasi_response(torch.from_numpy(test_image)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("use_harris", [True, False], ids=["Harris", "GFTT"])
def test_corners_and_descriptors_agree_with_jax(corner_pairs, use_harris):
    ref, got = corner_pairs[use_harris]
    assert got["desc"].shape == (CORNERS, 128)
    assert_agree(ref, got, binary=False)
    # the corners are integer pixels; masked rows are zeroed
    assert not got["desc"][~got["mask"]].any()
    assert not got["angle"][~got["mask"]].any()


# ---- SIFT's gather sampler and upscale -----------------------------------

@pytest.mark.parametrize("upscale", [False, True], ids=["plain", "upscale"])
def test_sift_gather_sampler_matches_jax(test_image, upscale):
    rxy, rresp, rscale, rangle, rdesc, rmask = [np.asarray(o) for o in jsift(
        jnp.asarray(test_image), max_features=SIFT_MAXF, sampler="xla",
        upscale=upscale)]
    xy, resp, scale, angle, desc, mask = [t.numpy() for t in tsift.detect_and_compute(
        torch.from_numpy(test_image), SIFT_MAXF, sampler="xla",
        upscale=upscale)]
    a, b = np.nonzero(mask)[0], np.nonzero(rmask)[0]
    assert len(b) > 100
    d = np.linalg.norm(xy[a][:, None] - rxy[b][None], axis=-1)
    j = d.argmin(1)
    matched = d[np.arange(len(a)), j] < 1e-4
    assert len(a) - matched.sum() <= 0.01 * len(b)
    assert abs(len(a) - len(b)) <= 0.01 * len(b)
    ia, ib = a[matched], b[j[matched]]
    np.testing.assert_allclose(resp[ia], rresp[ib], rtol=1e-4)
    np.testing.assert_allclose(scale[ia], rscale[ib], rtol=1e-4)
    assert angle_diff(angle[ia], rangle[ib]).max() < 1e-3
    cos = (desc[ia] * rdesc[ib]).sum(1) / np.maximum(
        np.linalg.norm(desc[ia], axis=1) * np.linalg.norm(rdesc[ib], axis=1),
        1e-12)
    assert cos.min() > 0.9999


def test_sift_samplers_agree_and_auto_is_the_window_route(test_image):
    t = torch.from_numpy(test_image)
    auto = tsift.detect_and_compute(t, SIFT_MAXF)
    win = tsift.detect_and_compute(t, SIFT_MAXF, sampler="pallas")
    for a, b in zip(auto, win):
        assert torch.equal(a, b)
    # the samplers differ in orientation and descriptor only (a 9x9 / 12x12
    # gather grid against dense windows); detection is shared
    xla = tsift.detect_and_compute(t, SIFT_MAXF, sampler="xla")
    for i in (0, 1, 2, 5):
        assert torch.equal(xla[i], win[i])
    with pytest.raises(ValueError, match="sampler"):
        tsift.detect_and_compute(t, SIFT_MAXF, sampler="gather")
    f = tv.detect_features(test_image, "SIFT", max_features=SIFT_MAXF,
                           device="cpu", upscale=True, sampler="xla")
    assert f.image_shape == (240, 320) and f.xy.shape == (SIFT_MAXF, 2)
    assert float(f.xy[f.mask][:, 0].max()) < 320


# ---- batches equal single images -----------------------------------------

@pytest.mark.parametrize("method", ["AKAZE", "BRISK", "Harris", "GFTT",
                                    "SIFT-xla", "SIFT-upscale"])
def test_batch_equals_single_images(test_image, method):
    from tpu3drec_torch.api import _get_detector_registry
    imgs = [test_image, np.ascontiguousarray(test_image[::-1, ::-1]),
            np.ascontiguousarray(np.roll(test_image, 17, 1))]
    if method.startswith("SIFT"):
        kw = {"sampler": "xla"} if method == "SIFT-xla" else {"upscale": True}
        det, kw["max_features"] = tsift.detect_sift_features, SIFT_MAXF
    else:
        det, kw = _get_detector_registry()[method], {"max_features": 256}
    batch = det(torch.from_numpy(np.stack(imgs)), **kw)
    assert batch.image_shape == (240, 320)
    for i, img in enumerate(imgs):
        one = det(torch.from_numpy(img), **kw)
        for field in ("xy", "response", "scale", "desc", "mask"):
            b, s = getattr(batch, field)[i], getattr(one, field)
            if method.startswith("SIFT") and field == "desc":
                torch.testing.assert_close(b, s, rtol=0, atol=1e-3)
            else:
                assert torch.equal(b, s), (i, field)
        torch.testing.assert_close(batch.angle[i], one.angle, rtol=0,
                                   atol=1e-6)


def test_describe_at_points_batched_and_masked(test_image):
    t = torch.from_numpy(np.stack([test_image, test_image[::-1].copy()]))
    xy = torch.tensor([[[40.0, 50.0], [100.5, 80.25], [2.0, 3.0]]] * 2)
    mask = torch.tensor([[True, True, False], [True, False, True]])
    desc, angle = tsift.describe_at_points(t, xy, mask)
    assert desc.shape == (2, 3, 128) and angle.shape == (2, 3)
    assert not desc[~mask].any() and not angle[~mask].any()
    ref_d, ref_a = tpu3drec.ops.sift.describe_at_points(
        jnp.asarray(test_image), jnp.asarray(xy[0].numpy()),
        jnp.asarray(mask[0].numpy()))
    np.testing.assert_allclose(desc[0].numpy(), np.asarray(ref_d), atol=1e-3)
    np.testing.assert_allclose(angle[0].numpy(), np.asarray(ref_a), atol=1e-4)
    one_d, one_a = tsift.describe_at_points(t[1], xy[1], mask[1])
    torch.testing.assert_close(desc[1], one_d, rtol=0, atol=1e-3)
    torch.testing.assert_close(angle[1], one_a, rtol=0, atol=1e-6)


def test_every_non_deep_detector_is_registered():
    from tpu3drec.api import _get_detector_registry as jreg
    from tpu3drec_torch.api import _get_detector_registry as treg
    assert sorted(treg()) == sorted(jreg())
    img = np.random.default_rng(5).uniform(0, 1, (96, 128)).astype(np.float32)
    for m, kind, width in (("Harris", "float", 128), ("GoodFeatures", "float", 128),
                           ("GFTT", "float", 128), ("AKAZE", "binary", 486),
                           ("BRISK", "binary", 512)):
        f = tv.detect_features(img, m, max_features=64, device="cpu")
        assert f.desc_kind == kind and f.desc.shape == (64, width), m
        assert f.method == ("GoodFeatures" if m == "GFTT" else m)
