"""Parity of the port's folder matching pipeline and folder API
(tpu3drec_torch.{io.images, io.native_decoder, io.checkpoint,
io.batch_pickle, io.converters, multi_method, pipelines.matching, api})
with the JAX package's, on `tests/test_pipeline_matching.py`'s 5-image
120x160 folder.

The reference's folder run happens once per module. The port's run on
the same folder must give the same pair set and counts, per-method raw
match counts within max(2, 2%), and the same best method wherever the
reference's two quality scores differ by more than 0.02 (RANSAC draws
differ between the packages, and `inlier_ratio` enters the score). The
batched engine makes 2 device calls per method per batch. Pickles read
both ways, COLMAP exports are byte-equal given the same matches, and the
io layer behaves as the reference's tests require. A `RuntimeError` (a
kernel or CUDA fault) propagates instead of counting a failed pair;
other failures degrade as in the reference and are counted. The folder
chain `reconstruct_folder` holds the reference's end-to-end bars on 4
rendered views.
"""

import os
import sys

import numpy as np
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_end_to_end import render_splat_views                 # noqa: E402
from test_pipeline_matching import make_folder                 # noqa: E402

from tpu3drec.io import batch_pickle as jbp                    # noqa: E402
from tpu3drec.io import checkpoint as jck                      # noqa: E402
from tpu3drec.io import converters as jconv                    # noqa: E402
from tpu3drec.io import images as jimg                         # noqa: E402
from tpu3drec.io import native_decoder as jnd                  # noqa: E402
from tpu3drec.pipelines.matching import create_pipeline as jcreate  # noqa: E402
import tpu3drec_torch as tv                                    # noqa: E402
from tpu3drec_torch.io import batch_pickle as tbp              # noqa: E402
from tpu3drec_torch.io import checkpoint as tck                # noqa: E402
from tpu3drec_torch.io import converters as tconv              # noqa: E402
from tpu3drec_torch.io import images as timg                   # noqa: E402
from tpu3drec_torch.io import native_decoder as tnd            # noqa: E402
from tpu3drec_torch.pipelines.matching import (                # noqa: E402
    create_pipeline as tcreate,
)

CFG = {"methods": ["SIFT", "ORB"], "max_features": 512}
SCORE_GAP = 0.02


def count_tol(n):
    return max(2, 0.02 * n)


# ---- io layer -----------------------------------------------------------

def test_scan_and_pair_modes_like_jax(tmp_path):
    folder = make_folder(tmp_path)
    jm, tm = jimg.scan_folder_metadata(folder), timg.scan_folder_metadata(folder)
    assert [m.to_dict() for m in tm] == [m.to_dict() for m in jm]
    assert tm[0].width == 160 and tm[0].height == 120
    assert timg.scan_folder_quick(folder) == jimg.scan_folder_quick(folder)
    assert len(timg.scan_folder_metadata(folder, max_images=2)) == 2
    for mode, window in (("consecutive", 1), ("consecutive", 2),
                         ("first", 1), ("all", 1)):
        assert timg.create_pairs_from_metadata(tm, mode, window) \
            == jimg.create_pairs_from_metadata(jm, mode, window)
    with pytest.raises(ValueError):
        timg.create_pairs_from_metadata(tm, "ring")


def test_image_cache_eviction_and_stats():
    cache = timg.ImageCache(max_bytes=4 * 100 * 100 * 3)  # holds 3 images
    for i in range(5):
        cache.put(f"im{i}", np.zeros((100, 100), np.float32))
    assert len(cache) == 3 and cache.nbytes == 3 * 40000
    assert "im0" not in cache and "im4" in cache
    assert cache.get("im0") is None and cache.get("im4") is not None
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 1


def test_batch_loader_reuses_cache_and_decodes_like_jax(tmp_path):
    folder = make_folder(tmp_path)
    metas = timg.scan_folder_metadata(folder)
    loader = timg.BatchImageLoader()
    got = loader.load_batch(metas[:3])
    assert loader.cache.misses == 3
    loader.load_batch(metas[1:4])
    assert loader.cache.misses == 4  # only one new load
    r = loader.analyze_batch_reuse([m.name for m in metas[:3]],
                                   [m.name for m in metas[1:4]])
    assert r["reused"] == 2 and r["new"] == 1
    ref = jimg.BatchImageLoader().load_batch(jimg.scan_folder_metadata(folder)[:3])
    for n in ref:
        np.testing.assert_array_equal(got[n], ref[n])
    # the native decoder's binding, where the prebuilt library loads here
    assert tnd.available() == jnd.available()
    if tnd.available():
        paths = [m.path for m in metas[:2]]
        sizes = [(m.height, m.width) for m in metas[:2]]
        for a, b in zip(tnd.decode_batch(paths, sizes, resize_to=(60, 80)),
                        jnd.decode_batch(paths, sizes, resize_to=(60, 80))):
            np.testing.assert_array_equal(a, b)


def test_npy_folder_reads_without_pil(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(2):
        np.save(tmp_path / f"v{i}.npy",
                rng.integers(0, 256, (24, 32), dtype=np.uint8))
    src = timg.FolderImageSource(tmp_path)
    img = src.load("v1.npy")
    assert img.dtype == np.float32 and img.shape == (24, 32)
    assert img.max() <= 1.0
    np.testing.assert_array_equal(
        img, jimg.FolderImageSource(tmp_path).load("v1.npy"))


def test_batch_processor_semantics_and_cross_read(tmp_path):
    pairs = [("a", "b"), ("b", "c"), ("c", "d")]
    bp = tck.BatchProcessor(tmp_path)
    assert not bp.is_completed(pairs[0])
    bp.mark_completed(pairs[0])
    bp.mark_completed(pairs[1])
    assert (tmp_path / "progress.json").exists()
    # resume in a fresh instance, of either package
    for mod in (tck, jck):
        bp2 = mod.BatchProcessor(tmp_path)
        assert bp2.is_completed(pairs[0]) and bp2.is_completed(pairs[1])
        assert bp2.get_remaining_pairs(pairs) == [pairs[2]]
        assert mod.get_remaining_pairs(tmp_path, pairs) == [pairs[2]]
        assert mod.load_progress(tmp_path)["total_completed"] == 2
    # corrupted checkpoint -> start fresh
    (tmp_path / "progress.json").write_text("{not json")
    assert tck.BatchProcessor(tmp_path).num_completed == 0
    assert tck.load_progress(tmp_path) is None
    tck.BatchProcessor(tmp_path).reset()
    assert not (tmp_path / "progress.json").exists()
    assert tck.delete_progress(tmp_path) is False
    assert tck.get_remaining_pairs(tmp_path, pairs) == pairs


def test_stage_glue_load_images_and_keypoint_roundtrip(tmp_path):
    from PIL import Image
    good = tmp_path / "a.png"
    Image.fromarray((np.random.default_rng(0).uniform(
        0, 255, (40, 60)).astype(np.uint8))).save(good)
    (tmp_path / "broken.png").write_bytes(b"not a png")
    paths = [str(good), str(tmp_path / "broken.png"),
             str(tmp_path / "missing.png")]
    loaded = tbp.load_images(paths)
    assert len(loaded) == 1 and loaded[0][1] == "a.png"
    np.testing.assert_array_equal(loaded[0][0], jbp.load_images(paths)[0][0])

    from tpu3drec.core.types import Features as JF
    xy = np.array([[3.0, 4.0], [10.0, 20.0]], np.float32)
    kw = dict(response=[0.5, 0.25], scale=[1.5, 2.0], angle=[0.5, -2.5],
              image_shape=(40, 60))
    tf = tv.Features.from_numpy(xy, np.zeros((2, 8), np.float32),
                                device="cpu", **kw)
    jf = JF.from_numpy(xy, np.zeros((2, 8), np.float32), **kw)
    dicts = tbp.keypoints_to_serializable(tf)
    assert dicts == jbp.keypoints_to_serializable(jf)
    back = tbp.serializable_to_keypoints(dicts, image_shape=(40, 60),
                                         device="cpu")
    ref = jbp.serializable_to_keypoints(dicts, image_shape=(40, 60))
    for f in ("xy", "angle", "scale", "response", "mask"):
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    assert tbp.serializable_to_keypoints([], device="cpu").xy.shape[1] == 2


# ---- the folder run -----------------------------------------------------

def engine_results(pipe):
    """Every MatchingResult the pipeline's batched engine returns, by pair
    (the folder run's own, so no test recomputes them)."""
    store = {}
    inner = pipe._match_pairs_batched

    def keep(images, pairs):
        out = inner(images, pairs)
        store.update(out)
        return out
    pipe._match_pairs_batched = keep
    return store


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's folder runs on one folder, and each
    engine's per-pair MatchingResults (the runs' single batch)."""
    tmp = tmp_path_factory.mktemp("mf")
    folder = make_folder(tmp)
    out = {}
    for name, create, kw in (("jax", jcreate, {}),
                             ("torch", tcreate, {"device": "cpu"})):
        pipe = create("fast", CFG, **kw)
        engine = engine_results(pipe)
        summary = pipe.match_folder(folder, tmp / name, batch_size=4,
                                    export_colmap=True, collect_results=True)
        assert sorted(engine) == sorted(summary["matches_data"])
        out[name] = dict(pipe=pipe, summary=summary, engine=engine,
                         dir=tmp / name)
    out["folder"] = folder
    return out


def test_folder_run_counts_like_jax(runs):
    j, t = runs["jax"]["summary"], runs["torch"]["summary"]
    assert sorted(t["matches_data"]) == sorted(j["matches_data"])
    for k in ("total_pairs", "completed", "failed", "skipped"):
        assert t["stats"][k] == j["stats"][k], k
    assert t["stats"]["completed"] == 4 and t["stats"]["failed"] == 0
    assert t["stats"]["engine_fallbacks"] == 0
    assert t["stats"]["method_errors"] == 0
    # 1 batch x 2 methods x (detect + match)
    assert runs["torch"]["pipe"].dispatch_count == 4
    assert set(t["methods"]) == {"SIFT", "ORB"}
    assert t["image_info"] == j["image_info"]
    assert (runs["torch"]["dir"] / "batch_summary.json").exists()
    assert (runs["torch"]["dir"] / "progress.json").exists()


def test_per_method_raw_counts_and_best_method_like_jax(runs):
    je, te = runs["jax"]["engine"], runs["torch"]["engine"]
    assert sorted(te) == sorted(je)
    for pair in je:
        for method in CFG["methods"]:
            a, b = je[pair][method], te[pair][method]
            assert b.error is None
            assert abs(b.num_raw_matches - a.num_raw_matches) \
                <= count_tol(a.num_raw_matches), (pair, method)
            assert b.num_raw_matches > 10
        scores = sorted(r.get_quality_score() for r in je[pair].values())
        if scores[-1] - scores[0] > SCORE_GAP:
            assert te[pair].get_best_method_name() \
                == je[pair].get_best_method_name(), pair


@pytest.fixture(scope="module")
def accurate_runs(tmp_path_factory):
    """Each package's batched engine on the folder's pairs at the
    `accurate` preset (SIFT + AKAZE + BRISK at 3,000 features), and the
    port's folder run."""
    tmp = tmp_path_factory.mktemp("acc")
    folder = make_folder(tmp)
    cfg = {"filtering": {"use_adaptive_filtering": False}}
    pipe = tcreate("accurate", cfg, device="cpu")
    engine = engine_results(pipe)
    summary = pipe.match_folder(folder, tmp / "torch", collect_results=True)
    pairs = sorted(summary["matches_data"])
    assert sorted(engine) == pairs
    images = jimg.FolderImageSource(folder).load_many(
        sorted({n for p in pairs for n in p}))
    # the reference's engine on the batch the port's folder run matched
    batch = list(engine)
    return {"summary": summary, "pipe": pipe, "pairs": pairs,
            "folder": folder, "torch": engine,
            "jax": jcreate("accurate", cfg)._match_pairs_batched(images, batch)}


def test_accurate_preset_counts_and_best_method_like_jax(accurate_runs):
    je, te = accurate_runs["jax"], accurate_runs["torch"]
    s = accurate_runs["summary"]
    assert s["stats"]["completed"] == 4 and s["stats"]["failed"] == 0
    assert s["stats"]["engine_fallbacks"] == 0
    assert s["stats"]["method_errors"] == 0
    # 1 batch x 3 methods x (detect + match)
    assert accurate_runs["pipe"].dispatch_count == 6
    assert set(s["methods"]) == {"SIFT", "AKAZE", "BRISK"}
    assert sorted(te) == sorted(je)
    for pair in je:
        for method in ("SIFT", "AKAZE", "BRISK"):
            a, b = je[pair][method], te[pair][method]
            assert b.error is None
            assert abs(b.num_raw_matches - a.num_raw_matches) \
                <= count_tol(a.num_raw_matches), (pair, method,
                                                  b.num_raw_matches,
                                                  a.num_raw_matches)
            assert b.num_raw_matches > 10
        assert te[pair]["AKAZE"].features1.desc.shape[-1] == 486
        assert te[pair]["BRISK"].features1.desc.shape[-1] == 512
        assert te[pair]["AKAZE"].matcher_used == "knn-batched[hamming_pm1]"
        scores = sorted(r.get_quality_score() for r in je[pair].values())
        if scores[-1] - scores[0] > SCORE_GAP:
            assert te[pair].get_best_method_name() \
                == je[pair].get_best_method_name(), pair


def test_per_pair_match_takes_binary_descriptors_like_the_engine(
        accurate_runs):
    """The per-pair path matches AKAZE's 486-wide and BRISK's 512-wide
    +-1 descriptors as the batched engine does: raw counts within
    max(2, 2%). The images are the engine's own decoded arrays (a folder
    batch decodes natively, one image through PIL, an ulp apart, and on
    this image's flat rectangles BRISK's bits compare equal intensities,
    so an ulp flips them)."""
    pair = accurate_runs["pairs"][0]
    images = timg.FolderImageSource(accurate_runs["folder"]).load_many(
        sorted({n for p in accurate_runs["pairs"] for n in p}))
    pipe = tcreate("accurate", {"filtering": {"use_adaptive_filtering": False}},
                   device="cpu")
    res = pipe.match(images[pair[0]], images[pair[1]])
    for method in ("SIFT", "AKAZE", "BRISK"):
        got = res[method].num_raw_matches
        ref = accurate_runs["torch"][pair][method].num_raw_matches
        assert res[method].error is None
        assert res[method].features1.desc.shape[-1] \
            == {"SIFT": 128, "AKAZE": 486, "BRISK": 512}[method]
        assert abs(got - ref) <= count_tol(ref), (method, got, ref)


def test_pickles_read_both_ways(runs):
    for writer in ("jax", "torch"):
        path = str(runs[writer]["dir"] / "results_batch_000.pkl")
        a, b = jbp.load_and_validate_pickle(path), tbp.load_and_validate_pickle(path)
        assert a["image_names"] == b["image_names"]
        assert a["image_info"] == b["image_info"]
        assert a["processing_stats"] == b["processing_stats"]
        assert a["feature_type"] == b["feature_type"] == "SIFT+ORB"
        pair, pd = next(iter(b["matches_data"].items()))
        corr = np.asarray(pd["correspondences"])
        assert corr.ndim == 2 and corr.shape[1] == 4
        assert pd["num_matches"] == len(corr)
        assert b["image_info"][pair[0]].get("width") == 160
    j = jbp.load_and_validate_pickle(str(runs["jax"]["dir"] / "results_batch_000.pkl"))
    t = tbp.load_and_validate_pickle(str(runs["torch"]["dir"] / "results_batch_000.pkl"))
    assert sorted(j["matches_data"]) == sorted(t["matches_data"])
    assert sorted(j["matches_data"][pair]) == sorted(t["matches_data"][pair])


def _port_result(ref):
    """A port MethodResult holding the reference result's arrays."""
    def feats(f):
        return tv.Features(**{k: torch.from_numpy(np.array(getattr(f, k)))
                              for k in ("xy", "response", "scale", "angle",
                                        "desc", "mask")},
                           method=f.method, desc_kind=f.desc_kind)
    def matches(m):
        return None if m is None else tv.Matches(
            **{k: torch.from_numpy(np.array(getattr(m, k)))
               for k in ("idx1", "idx2", "score", "mask")}, method=m.method)

    return tv.MethodResult(
        method=ref.method, features1=feats(ref.features1),
        features2=feats(ref.features2), matches=matches(ref.matches),
        filtered_matches=matches(ref.filtered_matches),
        homography=ref.homography, inlier_ratio=ref.inlier_ratio,
        reprojection_error=ref.reprojection_error,
        detection_time=ref.detection_time, matching_time=ref.matching_time)


def test_exports_byte_equal_given_the_same_matches(runs, tmp_path):
    pair = sorted(runs["jax"]["engine"])[0]
    ref = runs["jax"]["engine"][pair]
    port = tv.MatchingResult(results={m: _port_result(r) for m, r in ref.items()},
                             image1_name=pair[0], image2_name=pair[1])
    for method in CFG["methods"]:
        jconv.MethodReconstructionData.from_method_result(
            ref[method]).export_to_colmap(tmp_path / "j" / method, "a", "b")
        tconv.MethodReconstructionData.from_method_result(
            port[method]).export_to_colmap(tmp_path / "t" / method, "a", "b")
        for f in ("a_keypoints.txt", "b_keypoints.txt", "matches.txt"):
            assert (tmp_path / "t" / method / f).read_bytes() \
                == (tmp_path / "j" / method / f).read_bytes()
        a = jbp.pair_data_from_result(ref[method])
        b = tbp.pair_data_from_result(port[method])
        assert a == b
    assert tconv.MultiMethodReconstruction.from_matching_result(port).to_dict() \
        == jconv.MultiMethodReconstruction.from_matching_result(ref).to_dict()
    tconv.export_results_csv([port], tmp_path / "t.csv")
    jconv.export_results_csv([ref], tmp_path / "j.csv")
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    tconv.save_for_reconstruction(port, tmp_path / "r.pkl")
    back = jconv.load_for_reconstruction(tmp_path / "r.pkl")
    assert back.get_best_method() == tconv.MultiMethodReconstruction \
        .from_matching_result(port).get_best_method()
    vis = tconv.ResultConverter.to_visualization(port)
    assert vis.num_methods == 2
    with pytest.raises(ValueError, match="images required"):
        vis.plot()
    # the folder run's own exports exist for every pair with matches
    dirs = list((runs["torch"]["dir"] / "colmap").iterdir())
    assert len(dirs) == 4 and "matches.txt" in {p.name for p in dirs[0].iterdir()}


def test_second_run_skips_every_pair(runs):
    pipe = tcreate("fast", CFG, device="cpu")
    s2 = pipe.match_folder(runs["folder"], runs["torch"]["dir"], batch_size=4)
    assert s2["stats"]["skipped"] == 4 and s2["stats"]["completed"] == 0
    assert pipe.dispatch_count == 0


def test_kernel_fault_propagates_instead_of_failing_a_pair(tmp_path, monkeypatch):
    from tpu3drec_torch.ops import match as tmatch

    def broken(*a, **k):
        raise RuntimeError("knn2 kernel launch failed: CUDA error 700")

    monkeypatch.setattr(tmatch, "knn2_raw", broken)
    folder = make_folder(tmp_path)
    pipe = tcreate("fast", CFG, device="cpu")
    with pytest.raises(RuntimeError, match="knn2"):
        pipe.match_folder(folder, tmp_path / "o", batch_size=4,
                          auto_save=False)
    with pytest.raises(RuntimeError, match="knn2"):
        pipe.match_folder(folder, tmp_path / "p", batch_size=4,
                          auto_save=False, engine="perpair", resume=False)


def test_method_errors_are_counted(tmp_path, monkeypatch):
    folder = make_folder(tmp_path, n=3)
    pipe = tcreate("fast", {"methods": ["ORB"], "max_features": 256},
                   device="cpu")

    def refuse(method):
        raise ValueError("no matcher")

    monkeypatch.setattr(pipe, "_matcher_params", refuse)
    s = pipe.match_folder(folder, tmp_path / "o", auto_save=False)
    # each pair's one method result carries the error; no pair failed
    assert s["stats"]["completed"] == 2 and s["stats"]["failed"] == 0
    assert s["stats"]["method_errors"] == 2


def test_engine_fallback_is_counted_and_bad_inputs_degrade(tmp_path, monkeypatch):
    folder = make_folder(tmp_path, n=3)
    pipe = tcreate("fast", {"methods": ["ORB"], "max_features": 256},
                   device="cpu")

    def refuse(*a, **k):
        raise ValueError("engine refuses")

    monkeypatch.setattr(pipe, "_batched_one_method", refuse)
    s = pipe.match_folder(folder, tmp_path / "o", auto_save=False)
    assert s["stats"]["engine_fallbacks"] == 1
    assert s["stats"]["completed"] == 2 and s["stats"]["failed"] == 0
    # a method that fails on a bad input yields an empty result with error
    bad = pipe.match(np.zeros((8, 8), np.float32), np.zeros((8, 8), np.float32))
    assert bad["ORB"].error and bad["ORB"].num_matches == 0


def test_unported_detectors_are_never_dropped_silently(monkeypatch, tmp_path):
    # every detector that needs no weights runs, in the presets too
    pipe = tv.create_pipeline("accurate", device="cpu")
    assert pipe.methods == ["SIFT", "AKAZE", "BRISK"]
    img = make_image()
    for m in ("Harris", "GoodFeatures", "GFTT", "AKAZE", "BRISK"):
        f = tv.detect_features(img, m, max_features=128, device="cpu")
        assert int(f.mask.sum()) > 0, m
    from tpu3drec_torch.multi_method import create_multi_detector
    from tpu3drec.api import _get_detector_registry as jreg
    from tpu3drec_torch.api import _get_detector_registry as treg
    # deep detectors without weights are unavailable in both packages:
    # skipped and listed, never dropped silently
    assert sorted(set(jreg()) & {"SuperPoint", "DISK", "ALIKED"}) \
        == sorted(set(treg()) & {"SuperPoint", "DISK", "ALIKED"}) == []
    det = create_multi_detector(("SIFT", "AKAZE", "SuperPoint"),
                                max_features=128, device="cpu")
    assert det.methods == ["SIFT", "AKAZE"] and det.skipped == ["SuperPoint"]
    got = det.detect_all(img)
    assert set(got) == {"SIFT", "AKAZE"} and len(got["AKAZE"]) > 50
    robust = tv.create_pipeline("robust", device="cpu")
    assert robust.methods == ["SIFT", "AKAZE"]
    with pytest.raises(ValueError, match="no available detectors"):
        tv.create_pipeline("deep_learning", device="cpu")
    # with converted weights on disk (here random, written by the port),
    # both packages register the deep detectors and the port runs them
    import tpu3drec.models as jmodels
    import tpu3drec_torch.models as tmodels
    from tpu3drec_torch.models import aliked, disk, superpoint
    wd = tmp_path / "weights"
    for mod in (jmodels, tmodels):
        monkeypatch.setattr(mod, "WEIGHTS_DIR", wd)
    gen = torch.Generator().manual_seed(0)
    for mod, cls, name in ((superpoint, superpoint.SuperPoint, "superpoint"),
                           (disk, disk.DISK, "disk"),
                           (aliked, aliked.ALIKED, "aliked")):
        mod.save_weights(cls().init_random(gen), wd / f"{name}.npz")
    deep = {"SuperPoint", "DISK", "ALIKED"}
    assert set(jreg()) & deep == set(treg()) & deep == deep
    for m in sorted(deep):
        f = tv.detect_features(img, m, max_features=64, device="cpu")
        assert f.method == m and f.desc.shape[0] == 64, m
        assert int(f.mask.sum()) > 0, m
    det = create_multi_detector(("SIFT", "DISK"), max_features=64,
                                device="cpu")
    assert det.methods == ["SIFT", "DISK"] and det.skipped == []


def make_image():
    rng = np.random.default_rng(1)
    img = np.zeros((120, 160), np.float32)
    for _ in range(40):
        y, x = rng.integers(0, 100), rng.integers(0, 140)
        img[y:y + rng.integers(4, 20), x:x + rng.integers(4, 20)] += rng.uniform(0.1, 0.5)
    return np.clip(img, 0, 1)


def test_device_none_means_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: None means that card")
    with pytest.raises(RuntimeError):
        tv.create_pipeline("fast")


# ---- the folder chain ---------------------------------------------------

def test_reconstruct_folder_end_to_end(tmp_path):
    """The reference's slow end-to-end test's bars, on the port."""
    folder = tmp_path / "imgs"
    folder.mkdir()
    render_splat_views(folder)
    out = tmp_path / "out"
    result = tv.reconstruct_folder(folder, out, preset="fast",
                                   pair_mode="consecutive", pair_window=2,
                                   device="cpu")
    recon = result["reconstruction"]
    assert recon.num_cameras >= 3, sorted(recon.cameras)
    assert recon.num_points > 50
    q = tv.assess_reconstruction_quality(recon)
    assert q["mean_reprojection_error"] < 3.0, q
    assert result["matching"]["stats"]["engine_fallbacks"] == 0
    assert set(result["timings_s"]) == {"matching", "sfm"}
    assert (out / "matching" / "batch_summary.json").exists()
    assert list((out / "matching").glob("results_batch_*.pkl"))
    assert (out / "sfm" / "camera_poses.json").exists()
