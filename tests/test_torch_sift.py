"""The port's SIFT, pair step and API against the reference, end to end.

The reference runs its Pallas sampler (`sampler="pallas"`, interpret mode
on the CPU) so both sides compute the same dense orientation/descriptor;
its results are computed once per module. Every reference call uses the
shapes and static arguments of tests/test_pallas_sample.py (240x320,
max_features=256), so its compiled kernel is reused.

Tolerances: detected keypoint sets equal up to 1% (ULP-level float32
differences between XLA:CPU and torch blurs may flip a `dog >= max` tie;
observed: 0 differences on `test_image` at max_features=256, 1 of 353
at 2048); matched keypoints within 1e-4 px
and the oracle bars on angle (1e-3 rad) and descriptor (cosine 0.9999).
Pair step, with the reference's RANSAC draws injected: match and inlier
counts within max(2, 2%), homographies within 0.5 px at the corners."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)
from scipy import ndimage

from tpu3drec.core.types import Features as JFeatures
from tpu3drec.core.types import Matches as JMatches
from tpu3drec.ops.geometry import find_homography as j_find_homography
from tpu3drec.ops.match import knn2 as j_knn2
from tpu3drec.ops.sift import detect_and_compute as j_detect
import tpu3drec_torch as tt
from tpu3drec_torch.core.types import Features, Matches
from tpu3drec_torch.ops.match import match_features
from tpu3drec_torch.ops.sift import detect_and_compute

MAXF = 256
K_HYP = 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_pair_fn(max_features, num_hypotheses):
    """__graft_entry__._make_pair_fn with the Pallas sampler (which the
    reference picks on a TPU and the port ports)."""
    def pair_fn(img1, img2):
        xy1, _, _, _, d1, m1 = j_detect(img1, max_features=max_features,
                                        sampler="pallas")
        xy2, _, _, _, d2, m2 = j_detect(img2, max_features=max_features,
                                        sampler="pallas")
        nn_idx, nn_dist = j_knn2(d1, d2, m1, m2, metric="l2_int8")
        ok = (nn_dist[:, 0] < 0.75 * jnp.maximum(nn_dist[:, 1], 1e-12)) & m1
        rr = j_find_homography(xy1, xy2[nn_idx[:, 0]], mask=ok,
                               num_hypotheses=num_hypotheses,
                               key=jax.random.PRNGKey(0), refit=False)
        return {"num_matches": jnp.sum(ok.astype(jnp.int32)),
                "num_inliers": rr.num_inliers,
                "inlier_ratio": rr.inlier_ratio, "homography": rr.model}
    return pair_fn


def _warp(img, deg=8.0, scale=0.95):
    """Rotate + scale about the centre with scipy; returns (warped, H)
    with H mapping img pixel coords (x, y) to the warped image's."""
    h, w = img.shape
    t = np.deg2rad(deg)
    A = scale * np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
    c = np.array([(w - 1) / 2, (h - 1) / 2])
    Hm = np.eye(3)
    Hm[:2, :2] = A
    Hm[:2, 2] = c - A @ c
    Ainv = np.linalg.inv(A)
    M = Ainv[::-1, ::-1]                      # (row, col) order
    off = c[::-1] - M @ c[::-1]
    warped = ndimage.affine_transform(img, M, offset=off, order=1)
    return warped.astype(np.float32), Hm


def _corners_px(Ha, Hb, h, w):
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]],
                 float).T
    a, b = np.asarray(Ha, float) @ c, np.asarray(Hb, float) @ c
    return float(np.abs(a[:2] / a[2] - b[:2] / b[2]).max())


@pytest.fixture(scope="module")
def pair(test_image):
    warped, Hm = _warp(test_image)
    return test_image, warped, Hm


@pytest.fixture(scope="module")
def jax_ref(pair):
    img, warped, _ = pair
    det = [np.asarray(o) for o in j_detect(jnp.asarray(img), max_features=MAXF,
                                           sampler="pallas")]
    out = _jax_pair_fn(MAXF, K_HYP)(jnp.asarray(img), jnp.asarray(warped))
    return det, {k: np.asarray(v) for k, v in out.items()}


def test_detect_and_compute_matches_reference(pair, jax_ref):
    img = pair[0]
    rxy, rresp, rscale, rangle, rdesc, rmask = jax_ref[0]
    xy, resp, scale, angle, desc, mask = [
        t.numpy() for t in detect_and_compute(torch.from_numpy(img), MAXF)]
    assert xy.shape == (MAXF, 2) and desc.shape == (MAXF, 128)
    a, b = np.nonzero(mask)[0], np.nonzero(rmask)[0]
    assert len(b) > 100
    d = np.linalg.norm(xy[a][:, None] - rxy[b][None], axis=-1)
    j = d.argmin(1)
    matched = d[np.arange(len(a)), j] < 1e-4
    assert len(a) - matched.sum() <= 0.01 * len(b)
    assert abs(len(a) - len(b)) <= 0.01 * len(b)
    ia, ib = a[matched], b[j[matched]]
    np.testing.assert_allclose(resp[ia], rresp[ib], rtol=1e-4)
    np.testing.assert_allclose(scale[ia], rscale[ib], rtol=1e-5)
    da = np.abs(angle[ia] - rangle[ib])
    da = np.minimum(da, 2 * np.pi - da)
    assert da.max() < 1e-3, da.max()
    cos = (desc[ia] * rdesc[ib]).sum(1) / np.maximum(
        np.linalg.norm(desc[ia], axis=1) * np.linalg.norm(rdesc[ib], axis=1),
        1e-9)
    assert cos.min() > 0.9999, cos.min()
    assert np.all(desc[~mask] == 0)     # invalid slots and padding


def test_pair_step_matches_reference(pair, jax_ref):
    img, warped, Hm = pair
    ref = jax_ref[1]
    u = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (K_HYP, 4), 0,
                                      2 ** 31 - 1, dtype=jnp.int32))
    out = tt.make_pair_fn(MAXF, K_HYP)(torch.from_numpy(img)[None],
                                       torch.from_numpy(warped)[None],
                                       u=torch.tensor(u))
    nm, ni = int(out["num_matches"][0]), int(out["num_inliers"][0])
    rnm, rni = int(ref["num_matches"]), int(ref["num_inliers"])
    assert rnm > 30
    assert abs(nm - rnm) <= max(2, 0.02 * rnm), (nm, rnm)
    assert abs(ni - rni) <= max(2, 0.02 * rni), (ni, rni)
    h, w = img.shape
    Hp = out["homography"][0].numpy()
    assert _corners_px(Hp, ref["homography"], h, w) < 0.5
    assert _corners_px(Hp, Hm, h, w) < 2.0


def test_quick_match_quality_and_api_contract(pair):
    img, warped, Hm = pair
    r = tt.quick_match(img, warped, max_features=1024, device="cpu")
    assert r.num_matches > 30
    assert r.inlier_ratio > 0.8
    assert r.reprojection_error < 1.0
    assert _corners_px(r.homography, Hm, *img.shape) < 2.0
    # an unknown method names the available detectors (ORB is one since
    # the matching slice, so it no longer serves as the unknown name)
    with pytest.raises(ValueError, match="SIFT"):
        tt.detect_features(img, method="NoSuchDetector", device="cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked_for(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.detect_features(pair[0])


def test_features_and_matches_round_trip_with_reference(jax_ref):
    xy, resp, scale, angle, desc, mask = jax_ref[0]
    jf = JFeatures(xy=jnp.asarray(xy), response=jnp.asarray(resp),
                   scale=jnp.asarray(scale), angle=jnp.asarray(angle),
                   desc=jnp.asarray(desc), mask=jnp.asarray(mask),
                   method="SIFT", image_shape=(240, 320))
    d = jf.to_numpy()
    kw = dict(response=d["response"], scale=d["scale"], angle=d["angle"],
              capacity=MAXF, method=d["method"], desc_kind=d["desc_kind"],
              image_shape=d["image_shape"])
    tf = Features.from_numpy(d["xy"], d["desc"], device="cpu", **kw)
    back = tf.to_numpy()
    assert back.keys() == d.keys()
    for k in d:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(d[k]))
    # same padding rules as the reference's from_numpy
    jf2 = JFeatures.from_numpy(d["xy"], d["desc"], **kw)
    for k in ("xy", "response", "scale", "angle", "desc", "mask"):
        np.testing.assert_array_equal(getattr(tf, k).numpy(),
                                      np.asarray(getattr(jf2, k)))

    m = match_features(tf, tf)
    md = m.to_numpy()
    jm = JMatches(idx1=jnp.asarray(m.idx1.numpy()), idx2=jnp.asarray(m.idx2.numpy()),
                  score=jnp.asarray(m.score.numpy()), mask=jnp.asarray(m.mask.numpy()),
                  score_type=m.score_type, method=m.method)
    jd = jm.to_numpy()
    assert md.keys() == jd.keys() and len(md["idx1"]) > 100
    for k in md:
        np.testing.assert_array_equal(np.asarray(md[k]), np.asarray(jd[k]))
    m2 = Matches.from_numpy(jd["idx1"], jd["idx2"], jd["score"],
                            capacity=MAXF, score_type=jd["score_type"],
                            method=jd["method"], device="cpu")
    for k, v in m2.to_numpy().items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(jd[k]))


def test_port_imports_no_jax():
    # PIL blocked: the card's machine may have none
    code = ("import sys; sys.modules['PIL'] = None; "
            "import tpu3drec_torch, chip_smoke; "
            "import tpu3drec_torch.ops.stereo, tpu3drec_torch.ops.pallas_sgm, "
            "tpu3drec_torch.ops.pointcloud, tpu3drec_torch.ops.tsdf, "
            "tpu3drec_torch.ops.mesh, tpu3drec_torch.pipelines.dense, "
            "tpu3drec_torch.ops.implicit, "
            "tpu3drec_torch.ops.lie, tpu3drec_torch.ops.five_point, "
            "tpu3drec_torch.ops.epipolar, tpu3drec_torch.ops.triangulate, "
            "tpu3drec_torch.ops.pnp, tpu3drec_torch.ops.ba, "
            "tpu3drec_torch.sfm.refinement, tpu3drec_torch.sfm, "
            "tpu3drec_torch.sfm.pipeline, tpu3drec_torch.sfm.reconstruction, "
            "tpu3drec_torch.sfm.correspondence, tpu3drec_torch.sfm.pair_selector, "
            "tpu3drec_torch.sfm.intrinsics, tpu3drec_torch.sfm.quality, "
            "tpu3drec_torch.io, tpu3drec_torch.io.colmap, "
            "tpu3drec_torch.io.batch_pickle, tpu3drec_torch.bench, "
            "tpu3drec_torch.bench.synthetic, tpu3drec_torch.core.config, "
            "tpu3drec_torch.core.registry, tpu3drec_torch.core.multi_match, "
            "tpu3drec_torch.multi_method, tpu3drec_torch.models, "
            "tpu3drec_torch.models._params, tpu3drec_torch.models._common, "
            "tpu3drec_torch.models.superpoint, tpu3drec_torch.models.disk, "
            "tpu3drec_torch.models.aliked, tpu3drec_torch.models.aliked_n16, "
            "tpu3drec_torch.models.lightglue, "
            "tpu3drec_torch.ops.fast, tpu3drec_torch.ops.harris, "
            "tpu3drec_torch.ops.orb, tpu3drec_torch.ops._orb_pattern_cv, "
            "tpu3drec_torch.io.images, tpu3drec_torch.io.native_decoder, "
            "tpu3drec_torch.io.checkpoint, tpu3drec_torch.io.converters, "
            "tpu3drec_torch.pipelines.matching, tpu3drec_torch.api; "
            "import tpu3drec_torch.ops.orb as o; o._pattern_table('opencv'); "
            "bad = [m for m in ('jax', 'flax', 'tpu3drec', 'bench', "
            "'__graft_entry__') if m in sys.modules]; "
            "assert not bad, bad")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
