"""Parity of the port's SfM data layer (tpu3drec_torch.sfm.{intrinsics,
quality, reconstruction, correspondence, pair_selector}, io.{colmap,
batch_pickle}, bench.synthetic) with the JAX package's.

The host-side numpy paths are copies and must agree exactly: equal
arrays, equal dicts, byte-equal files. `to_ba_problem` /
`to_local_ba_problem` pack the real counts where the reference pads to
capacity buckets, so the port's arrays equal the real prefix of the
reference's. The batched fundamental RANSACs of `score_all_pairs` draw
from torch generators, so the free-running comparison holds the best
pair and the inlier ratios within 0.02; `score_pair` given the
reference's RANSAC result is exact. The synthetic scene replaces
OpenCV's Rodrigues by the port's, so its correspondences agree within
1e-6 px.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_local_ba import _sequential_recon                    # noqa: E402
from test_sfm_pipeline import make_scene                       # noqa: E402

from tpu3drec.sfm import correspondence as jc                  # noqa: E402
from tpu3drec.sfm import intrinsics as ji                      # noqa: E402
from tpu3drec.sfm import pair_selector as jp                   # noqa: E402
from tpu3drec.sfm import quality as jq                         # noqa: E402
from tpu3drec.sfm import reconstruction as jr                  # noqa: E402
from tpu3drec_torch.sfm import correspondence as tc            # noqa: E402
from tpu3drec_torch.sfm import intrinsics as ti                # noqa: E402
from tpu3drec_torch.sfm import pair_selector as tp             # noqa: E402
from tpu3drec_torch.sfm import quality as tq                   # noqa: E402
from tpu3drec_torch.sfm import reconstruction as tr            # noqa: E402

RATIO_TOL = 0.02
SCENE_TOL_PX = 1e-6


def copy_recon(ref, mod):
    """The same reconstruction in package `mod`'s classes (the reference's
    or the port's reconstruction module), built by the same calls."""
    out = mod.Reconstruction()
    for n, c in ref.cameras.items():
        out.add_camera(mod.Camera(n, c.R.copy(), c.t.copy(), c.K.copy(),
                                  tuple(c.image_size)))
    out.add_points_batch(ref.points)
    for n in ref.camera_names():
        pids, uvs = ref.camera_obs_arrays(n)
        out.add_observations_batch(n, pids, uvs)
    return out


def assert_same_recon(a, b):
    assert list(a.cameras) == list(b.cameras)
    assert a.camera_names() == b.camera_names()
    for n in a.cameras:
        for f in ("R", "t", "K"):
            np.testing.assert_array_equal(getattr(a.cameras[n], f),
                                          getattr(b.cameras[n], f))
        assert tuple(a.cameras[n].image_size) == tuple(b.cameras[n].image_size)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.point_colors, b.point_colors)
    for x, y in zip(a.obs_arrays(), b.obs_arrays()):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def seq():
    ref, _ = _sequential_recon()
    return ref, copy_recon(ref, tr)


# ---- intrinsics and quality -------------------------------------------

def test_intrinsics_match_reference():
    for w, h in ((640, 480), (4000, 3000), (2000, 500), (300, 1000)):
        np.testing.assert_array_equal(ti.heuristic_K(w, h), ji.heuristic_K(w, h))
        assert ti.fov_heuristic_ratio(w, h) == ji.fov_heuristic_ratio(w, h)
    je, te = ji.ProgressiveIntrinsicsEstimator(), ti.ProgressiveIntrinsicsEstimator()
    rng = np.random.default_rng(0)
    for i in range(60):      # past MAX_PATTERNS, with rejected ratios
        w, h = [(640, 480), (1920, 1080), (800, 600)][i % 3]
        f = rng.uniform(0.1, 6.0) * max(w, h)
        K = np.array([[f, 0, w / 2], [0, f * 1.01, h / 2], [0, 0, 1.0]])
        je.learn(K, w, h)
        te.learn(K, w, h)
        np.testing.assert_array_equal(te.estimate(1024, 768),
                                      je.estimate(1024, 768))
    assert te.num_learned == je.num_learned


def test_quality_and_stats_from_reference_state(seq, tmp_path):
    ref, _ = seq
    ref.save_state(tmp_path / "state.pkl")
    got = tr.Reconstruction.load_state(tmp_path / "state.pkl")
    assert tq.assess_reconstruction_quality(got) == \
        jq.assess_reconstruction_quality(ref)
    assert got.stats() == ref.stats()
    np.testing.assert_array_equal(tq.reprojection_errors(got),
                                  jq.reprojection_errors(ref))
    np.testing.assert_array_equal(got.track_lengths(), ref.track_lengths())
    assert tq.print_quality_report({"a": 1.0}) == jq.print_quality_report({"a": 1.0})


def test_export_colmap_byte_equal(seq, tmp_path):
    ref, got = seq
    ref.export_colmap(tmp_path / "ref")
    got.export_colmap(tmp_path / "port")
    for f in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "ref" / f).read_bytes(), f
    from tpu3drec.io.colmap import _rotmat_to_qvec as jq_vec
    from tpu3drec_torch.io.colmap import _rotmat_to_qvec as tq_vec
    from tpu3drec_torch.ops.lie import exp_so3_np
    for rv in ([0, 0, 0], [3.1, 0.1, 0], [0, 3.0, 0.2], [0.2, 0.1, 3.1]):
        R = exp_so3_np(np.asarray(rv, np.float64))
        np.testing.assert_array_equal(tq_vec(R), jq_vec(R))
    from tpu3drec.io.colmap import export_pair_matches as jx
    from tpu3drec_torch.io.colmap import export_pair_matches as tx
    kp = np.arange(20, dtype=np.float64).reshape(10, 2)
    mt = np.stack([np.arange(5), np.arange(5)[::-1]], 1)
    jx(tmp_path / "pm_ref", "a", "b", kp, kp + 0.5, mt)
    tx(tmp_path / "pm_port", "a", "b", kp, kp + 0.5, mt)
    for f in ("a_keypoints.txt", "b_keypoints.txt", "matches.txt"):
        assert (tmp_path / "pm_port" / f).read_bytes() == \
            (tmp_path / "pm_ref" / f).read_bytes()


# ---- BA packing and write-back ------------------------------------------

def _assert_prefix(tprob, jprob):
    t = tprob.to_numpy()
    C, P, M = len(t["cam_params"]), len(t["points"]), len(t["obs_cam"])
    for k in ("cam_params", "param_mask"):
        np.testing.assert_array_equal(t[k], np.asarray(getattr(jprob, k))[:C])
    np.testing.assert_array_equal(t["points"], np.asarray(jprob.points)[:P])
    for k in ("obs_cam", "obs_pt", "obs_uv"):
        np.testing.assert_array_equal(t[k], np.asarray(getattr(jprob, k))[:M])
    assert np.asarray(jprob.obs_mask)[:M].all() and t["obs_mask"].all()
    assert not np.asarray(jprob.obs_mask)[M:].any()
    assert t["point_mask"].all() and not np.asarray(jprob.point_mask)[P:].any()
    return C, P


@pytest.mark.parametrize("kind", ["full", "window", "local"])
def test_ba_problem_equals_reference_prefix(seq, kind):
    ref, got = seq
    window = ["cam10.png", "cam11.png"]
    if kind == "local":
        jprob, jnames, jpids = ref.to_local_ba_problem(window, optimize_intrinsics=False)
        tprob, tnames, tpids = got.to_local_ba_problem(window, optimize_intrinsics=False,
                                                       device="cpu")
        np.testing.assert_array_equal(tpids, jpids)
    else:
        opt = None if kind == "full" else window
        jprob, jnames = ref.to_ba_problem(optimize_cams=opt)
        tprob, tnames = got.to_ba_problem(optimize_cams=opt, device="cpu")
    assert tnames == jnames
    C, P = _assert_prefix(tprob, jprob)

    # the same solved arrays written back give the same reconstruction
    rng = np.random.default_rng(1)
    cams = np.asarray(jprob.cam_params) + 0.01 * rng.standard_normal(
        np.asarray(jprob.cam_params).shape).astype(np.float32)
    pts = np.asarray(jprob.points) + 0.05 * rng.standard_normal(
        np.asarray(jprob.points).shape).astype(np.float32)
    got2, ref_copy = copy_recon(ref, tr), copy_recon(ref, jr)
    if kind == "local":
        ref_copy.update_from_local_ba(cams, pts, jnames, jpids)
        got2.update_from_local_ba(cams[:C], pts[:P], tnames, tpids)
    else:
        ref_copy.update_from_ba(cams, pts, jnames)
        got2.update_from_ba(cams[:C], pts[:P], tnames)
    assert_same_recon(got2, ref_copy)


def test_ba_problem_on_device_none_means_cuda(seq):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        seq[1].to_ba_problem()


def test_state_round_trips_both_ways(seq, tmp_path):
    ref, got = seq
    got.save_state(tmp_path / "port.pkl")
    assert_same_recon(jr.Reconstruction.load_state(tmp_path / "port.pkl"), ref)
    ref.save_state(tmp_path / "ref.pkl")
    assert_same_recon(tr.Reconstruction.load_state(tmp_path / "ref.pkl"), got)
    got.save(tmp_path / "legacy_port.pkl")
    ref.save(tmp_path / "legacy_ref.pkl")
    import pickle
    a = pickle.load(open(tmp_path / "legacy_port.pkl", "rb"))
    b = pickle.load(open(tmp_path / "legacy_ref.pkl", "rb"))
    assert a == b


def test_remove_points_matches_reference(seq):
    ref, _ = seq
    a, b = copy_recon(ref, jr), copy_recon(ref, tr)
    drop = np.random.default_rng(2).choice(ref.num_points, 57, replace=False)
    a.remove_points(drop)
    b.remove_points(drop)
    assert_same_recon(b, a)
    for n in a.cameras:
        for x, y in zip(a.camera_obs_arrays(n), b.camera_obs_arrays(n)):
            np.testing.assert_array_equal(x, y)
        assert b.points_seen_by(n) == a.points_seen_by(n)
    assert b.cameras_seeing(3) == a.cameras_seeing(3)
    assert b.observations_of_camera("cam02.png")[5][0] == \
        a.observations_of_camera("cam02.png")[5][0]


# ---- correspondence --------------------------------------------------------

@pytest.mark.parametrize("nq,nr", [(300, 200), (2000, 900), (50, 10)])
def test_min_dists_exact(nq, nr):
    rng = np.random.default_rng(nq)
    q = rng.uniform(0, 640, (nq, 2))
    r = rng.uniform(0, 640, (nr, 2))
    for x, y in zip(tc.min_dists(q, r), jc.min_dists(q, r)):
        np.testing.assert_array_equal(x, y)


def _mining_matches(recon, rng):
    """matches of a new image against three cameras: 60% near the
    camera's observations (1.5 px noise), the rest random."""
    md = {}
    for i, cam in enumerate(("cam03.png", "cam04.png", "cam07.png")):
        _, uvs = recon.camera_obs_arrays(cam)
        n = 70
        other = np.where(rng.random((n, 1)) < 0.6,
                         uvs[:n] + rng.normal(0, 1.5, (n, 2)),
                         rng.uniform(0, 640, (n, 2)))
        corr = np.c_[rng.uniform(0, 640, (n, 2)), other]
        key = ("new.png", cam) if i % 2 == 0 else (cam, "new.png")
        md[key] = {"correspondences": (corr if i % 2 == 0 else
                                       np.c_[corr[:, 2:], corr[:, :2]]),
                   "num_matches": n, "quality_score": 0.7 + 0.1 * i}
    return md


def test_lookup_and_find_2d3d_exact(seq):
    ref, got = seq
    md = _mining_matches(ref, np.random.default_rng(3))
    for a, b in (("new.png", "cam03.png"), ("cam04.png", "new.png"),
                 ("new.png", "cam00.png")):
        x, y = tc.lookup_pair(md, a, b), jc.lookup_pair(md, a, b)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)
    for ladder in ((2.0, 4.0, 8.0), (0.5, 1.0)):
        tcfg = tc.CorrespondenceConfig(tolerance_ladder=ladder)
        jcfg = jc.CorrespondenceConfig(tolerance_ladder=ladder)
        tuv, tpid, tdiag = tc.CorrespondenceFinder(tcfg).find_2d3d(got, "new.png", md)
        juv, jpid, jdiag = jc.CorrespondenceFinder(jcfg).find_2d3d(ref, "new.png", md)
        np.testing.assert_array_equal(tuv, juv)
        np.testing.assert_array_equal(tpid, jpid)
        assert tdiag == jdiag
    assert tc.diagnose_failure(got, "new.png", md) == \
        jc.diagnose_failure(ref, "new.png", md)
    assert tc.CorrespondenceManager().select_next_image(got, ["new.png"], md) == \
        jc.CorrespondenceManager().select_next_image(ref, ["new.png"], md)


def test_pre_triangulator_matches_reference(seq):
    ref, got = seq
    md = _mining_matches(ref, np.random.default_rng(4))
    cam = ref.cameras["cam05.png"]
    j = jc.PreTriangulator().triangulate_against_all(
        ref, "new.png", cam.R, cam.t + 0.1, cam.K, md)
    t = tc.PreTriangulator().triangulate_against_all(
        got, "new.png", cam.R, cam.t + 0.1, cam.K, md, device="cpu")
    assert [d["other"] for d in t] == [d["other"] for d in j]
    for a, b in zip(t, j):
        assert (a["mask"] != b["mask"]).sum() <= 1
        both = a["mask"] & b["mask"]
        np.testing.assert_allclose(a["points"][both], b["points"][both],
                                   rtol=1e-4, atol=1e-4)


# ---- pair selection --------------------------------------------------------

def test_pure_scoring_functions_exact(seq):
    ref, got = seq
    rng = np.random.default_rng(5)
    for st, m in (("distance", "SIFT"), ("distance", "ORB"), ("distance", "AKAZE"),
                  ("distance", "other"), ("confidence", "lg"),
                  ("similarity", "ncc"), ("unknown", "")):
        s = rng.uniform(-1, 300, 40)
        assert tp.normalize_match_scores(s, st, m) == jp.normalize_match_scores(s, st, m)
    assert tp.normalize_match_scores([], "distance") == \
        jp.normalize_match_scores([], "distance")
    for n, shift, spread in ((120, 40.0, 2.0), (60, 1.0, 1.2), (10, 5.0, 1.0),
                             (200, 200.0, 3.0)):
        p1 = rng.uniform((50, 50), (590, 430), (n, 2))
        p2 = p1 + shift + rng.normal(0, spread, (n, 2))
        assert tp.validate_correspondences(p1, p2, (640, 480)) == \
            jp.validate_correspondences(p1, p2, (640, 480))
    assert tp.validate_correspondences(np.zeros((5, 2)), np.zeros((4, 2)),
                                       (640, 480)) == \
        jp.validate_correspondences(np.zeros((5, 2)), np.zeros((4, 2)), (640, 480))
    for pts in (np.zeros((0, 2)), rng.uniform(0, 700, (80, 2))):
        assert tp._spatial_distribution_score(pts, (640, 480)) == \
            jp._spatial_distribution_score(pts, (640, 480))
    for d in (1.0, 20.0, 150.0, 400.0, 900.0):
        assert tp._baseline_score(0.9, d, 800.0) == jp._baseline_score(0.9, d, 800.0)

    md = _mining_matches(ref, np.random.default_rng(6))
    md[("x.png", "cam01.png")] = {"correspondences": np.zeros((2, 4)),
                                  "num_matches": 2,
                                  "match_scores": [10.0, 20.0],
                                  "score_type": "distance", "method": "SIFT"}
    md[("y.png", "z.png")] = {"error": "failed"}
    remaining = ["new.png", "x.png", "y.png"]
    for recon_t, recon_j in ((None, None), (got, ref)):
        assert tp.InitializationPairSelector().rank_next_views(
            remaining, list(ref.cameras), md, recon=recon_t) == \
            jp.InitializationPairSelector().rank_next_views(
                remaining, list(ref.cameras), md, recon=recon_j)


@pytest.fixture(scope="module")
def pair_scores():
    """The reference's and the port's free-running scores of
    make_scene(n_views=4)'s pairs, and the reference's batched F-RANSAC
    results per pair (`_fpair_batch` packed as score_all_pairs packs it)."""
    md, info, *_ = make_scene(n_views=4)
    js = jp.InitializationPairSelector().score_all_pairs(md, info)
    ts = tp.InitializationPairSelector(device="cpu").score_all_pairs(md, info)
    items = sorted(md.items())
    cap = 512
    B = 8
    P1 = np.zeros((B, cap, 2), np.float32)
    P2 = np.zeros((B, cap, 2), np.float32)
    M = np.zeros((B, cap), bool)
    for g, (_, pd) in enumerate(items):
        c = np.asarray(pd["correspondences"], np.float32)
        P1[g, :len(c)], P2[g, :len(c)], M[g, :len(c)] = c[:, :2], c[:, 2:], True
    rr = jp._fpair_batch(jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(M),
                         jnp.asarray(np.arange(B, dtype=np.uint32)), 2.0)
    geom = {pair: (float(rr.inlier_ratio[g]) if bool(rr.success[g]) else 0.0,
                   np.asarray(rr.inliers)[g, :len(pd["correspondences"])])
            for g, (pair, pd) in enumerate(items)}
    return md, info, js, ts, geom


def test_score_all_pairs_free_running(pair_scores):
    md, info, js, ts, _ = pair_scores
    assert set(ts) == set(js)
    best = lambda s: max(s.items(), key=lambda kv: kv[1]["total"])[0]
    assert best(ts) == best(js)
    for pair in js:
        assert abs(ts[pair]["inlier_ratio"] - js[pair]["inlier_ratio"]) <= RATIO_TOL
        assert ts[pair]["num_matches"] == js[pair]["num_matches"]


def test_score_pair_given_reference_geometry_exact(pair_scores):
    md, info, js, _, geom = pair_scores
    for i, (pair, pd) in enumerate(sorted(md.items())):
        corr = np.asarray(pd["correspondences"])
        got = tp.score_pair(corr, (640, 480), tp.ScoringConfig(), confidence=0.8,
                            precomputed_geom=geom[pair])
        assert got == jp.score_pair(corr, (640, 480), jp.ScoringConfig(),
                                    confidence=0.8, precomputed_geom=geom[pair])
        assert got == js[pair]
    few = np.zeros((10, 4))
    assert tp.score_pair(few) == jp.score_pair(few)


# ---- synthetic scene and batch pickles -------------------------------------

def test_make_sfm_scene_matches_reference():
    from tpu3drec.bench.synthetic import make_sfm_scene as jscene
    from tpu3drec_torch.bench.synthetic import make_sfm_scene as tscene
    jmd, jinfo, jgt = jscene(n_views=6, n_pts=600)
    tmd, tinfo, tgt = tscene(n_views=6, n_pts=600)
    assert list(tmd) == list(jmd) and tinfo == jinfo
    for k in jmd:
        assert tmd[k]["num_matches"] == jmd[k]["num_matches"]
        np.testing.assert_allclose(tmd[k]["correspondences"],
                                   jmd[k]["correspondences"], rtol=0,
                                   atol=SCENE_TOL_PX)
    np.testing.assert_array_equal(tgt["X"], jgt["X"])
    for (Rt, tt), (Rj, tj) in zip(tgt["views"], jgt["views"]):
        np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-15)
        np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-14)


def test_load_and_validate_pickle_matches_reference(tmp_path):
    from tpu3drec.io.batch_pickle import (load_and_validate_pickle as jload,
                                          save_batch, save_image_metadata)
    from tpu3drec.io.images import ImageMetadata
    from tpu3drec_torch.io.batch_pickle import load_and_validate_pickle as tload
    md, info, *_, names = make_scene(n_views=4)
    keys = sorted(md)
    save_batch(tmp_path, "res", 0, {k: md[k] for k in keys[:3]},
               config={"feature_type": "SIFT"})
    # a string key, a failed pair and a duplicate in the second batch
    second = {str(keys[3]): md[keys[3]], keys[0]: md[keys[1]],
              ("p.png", "q.png"): {"error": "no matches"}}
    second.update({k: md[k] for k in keys[4:]})
    save_batch(tmp_path, "res", 1, second)
    save_image_metadata(tmp_path, "res", [
        ImageMetadata(name=n, path=n, width=640, height=480) for n in names[:3]])
    for arg in (tmp_path / "res_batch_000.pkl", str(tmp_path / "res_batch_*.pkl")):
        assert tload(str(arg)) == jload(str(arg))
    lone = tmp_path / "other.pkl"
    lone.write_bytes((tmp_path / "res_batch_001.pkl").read_bytes())
    assert tload(str(lone)) == jload(str(lone))
    with pytest.raises(FileNotFoundError):
        tload(str(tmp_path / "missing.pkl"))
