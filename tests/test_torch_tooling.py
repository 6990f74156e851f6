"""The port's tooling leaves against the JAX package's: the benchmark
inputs, metrics, statistics and runner (tpu3drec_torch.bench), the
profiling utilities, the offline dataset generator, checkerboard
calibration and the plotting module.

Bars: synthetic images, transform pairs and generated dataset files are
bit-equal to the reference's (numpy in both); the metrics and statistics
are copies and must give equal dicts; calibrated K within 1e-3 relative
of the reference's on the same corners (float32 DLT and BA in both, in
other orders); the runner and the plots are held to the reference tests'
own bars.
"""

import dataclasses
import json
import sys
import time

import numpy as np
import pytest
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

from tpu3drec.bench import metrics as jmetrics
from tpu3drec.bench import runner as jrunner
from tpu3drec.bench import stats as jstats
from tpu3drec.bench import synthetic as jsyn
from tpu3drec_torch.bench.metrics import AdvancedQualityMetrics
from tpu3drec_torch.bench.runner import (
    ThroughputTask, UnifiedBenchmarkConfig, UnifiedBenchmarkPipeline,
)
from tpu3drec_torch.bench.stats import StatisticalAnalyzer, describe
from tpu3drec_torch.bench.synthetic import (
    SyntheticImageGenerator, _warp, create_transform_pair,
)
from tpu3drec_torch.data.downloader import (
    download_pixabay_images, generate_synthetic_dataset, write_png_gray,
)
from tpu3drec_torch.sfm.calibration import (
    CameraCalibration, checkerboard_object_points,
)
from tpu3drec_torch.utils.profiling import (
    ProfileCollector, Timer, device_memory_stats, trace_to,
)


# -- benchmark inputs, metrics, statistics (tests/test_benchmark.py) ---

def test_generator_deterministic():
    gen = SyntheticImageGenerator(width=160, height=120, seed=7)
    a = gen.generate()
    b = gen.generate()
    np.testing.assert_array_equal(a, b)
    c = gen.generate(seed=8)
    assert np.abs(a - c).max() > 0.1
    assert a.shape == (120, 160) and a.dtype == np.float32
    assert 0.0 <= a.min() and a.max() <= 1.0
    ref = jsyn.SyntheticImageGenerator(width=160, height=120, seed=7)
    np.testing.assert_array_equal(a, ref.generate())
    np.testing.assert_array_equal(c, ref.generate(seed=8))
    np.testing.assert_array_equal(
        SyntheticImageGenerator(seed=3).generate(0.05, 0.0),
        jsyn.SyntheticImageGenerator(seed=3).generate(0.05, 0.0))


@pytest.mark.parametrize("ttype", ["perspective", "affine", "rotation",
                                   "scale"])
def test_transform_pairs_have_correct_gt(ttype):
    gen = SyntheticImageGenerator(width=160, height=120, seed=3)
    img = gen.generate()
    warped, H = create_transform_pair(img, ttype, magnitude=0.2, seed=1)
    assert warped.shape == img.shape
    np.testing.assert_allclose(warped, _warp(img, H), atol=1e-6)
    c = H @ np.array([80, 60, 1.0])
    assert 0 < c[0] / c[2] < 160 and 0 < c[1] / c[2] < 120
    rwarped, rH = jsyn.create_transform_pair(img, ttype, magnitude=0.2,
                                             seed=1)
    np.testing.assert_array_equal(warped, rwarped)
    np.testing.assert_array_equal(H, rH)


def test_quality_metrics_perfect_matches():
    rng = np.random.default_rng(0)
    H = np.array([[1.05, 0.02, 5], [-0.01, 0.98, -3], [1e-5, 0, 1]])
    p1 = rng.uniform(20, 300, (200, 2))
    ph = np.concatenate([p1, np.ones((200, 1))], 1) @ H.T
    p2 = ph[:, :2] / ph[:, 2:3]
    q = AdvancedQualityMetrics.comprehensive_quality_assessment(
        p1, p2, H, H, (480, 640))
    assert q["mean_error"] < 1e-6
    assert q["inlier_ratio"] == 1.0
    assert q["frobenius_error"] < 1e-9
    assert q["overall_quality"] > 0.7
    p2_bad = p2 + rng.uniform(-50, 50, p2.shape)
    q_bad = AdvancedQualityMetrics.comprehensive_quality_assessment(
        p1, p2_bad, None, H, (480, 640))
    assert q_bad["overall_quality"] < q["overall_quality"] - 0.2
    ref = jmetrics.AdvancedQualityMetrics
    assert q == ref.comprehensive_quality_assessment(p1, p2, H, H,
                                                     (480, 640))
    assert q_bad == ref.comprehensive_quality_assessment(p1, p2_bad, None,
                                                         H, (480, 640))


def test_statistical_analyzer():
    rng = np.random.default_rng(1)
    a = rng.normal(10, 1, 20)
    b = rng.normal(12, 1, 20)
    cmp = StatisticalAnalyzer.compare_methods(a, b)
    assert cmp["significant"]
    assert abs(cmp["cohens_d"]) > 1.0
    same = StatisticalAnalyzer.compare_methods(a, a)
    assert not same["significant"]
    d = describe([1.0, 2.0, 3.0])
    assert d["mean"] == 2.0 and d["n"] == 3
    assert cmp == jstats.StatisticalAnalyzer.compare_methods(a, b)


def test_unified_benchmark_runs(tmp_path):
    cfg = UnifiedBenchmarkConfig(methods=("SIFT", "ORB"), num_runs=2,
                                 image_size=(120, 160), max_features=256,
                                 transform_types=("rotation",),
                                 measure_memory=True)
    pipe = UnifiedBenchmarkPipeline(cfg, device="cpu")
    res = pipe.benchmark_synthetic(n_images=1)
    perf = res["benchmarks"]["performance"]["summary"]
    acc = res["benchmarks"]["accuracy"]["summary"]
    for m in ("SIFT", "ORB"):
        assert "error" not in perf[m], perf[m]
        assert perf[m]["fps"] > 0
        assert len(perf[m]["raw_runs"]) == 2
        assert "traced_peak_mb" in perf[m]["raw_runs"][0]["memory"]
        assert acc[m]["avg_quality"] > 0.2, acc[m]
    ranking = res["analysis"]["ranking"]
    assert len(ranking) == 2
    thr = res["benchmarks"]["throughput"]["summary"]
    for m in ("SIFT", "ORB"):
        assert "error" not in thr[m], thr[m]
        assert thr[m]["batched_pairs_per_s"] > 0
        assert thr[m]["batch"] == cfg.throughput_batch
        assert thr[m]["compile_time_s"] > 0
    # the reference's metric choice (tpu3drec/bench/runner.py:180-186)
    assert thr["SIFT"]["metric"] == "l2_int8"
    assert thr["ORB"]["metric"] == "hamming_pm1"
    # the CPU ranks by per-call FPS, as the reference does on its CPU
    assert res["analysis"]["speed_metric"] == "fps"
    path = pipe.save_results(res, tmp_path)
    saved = json.loads(path.read_text())
    assert saved["benchmarks"]["performance"]["summary"].keys() == perf.keys()
    # the saved config has the reference's fields
    assert set(saved["config"]) == set(
        dataclasses.asdict(jrunner.UnifiedBenchmarkConfig()))
    table = pipe.print_table(res)
    assert "SIFT" in table and "ORB" in table


def test_throughput_task_records_a_method_fault(monkeypatch):
    """A fault inside one method's batch is that method's `error` entry,
    as in the reference; the other method still runs."""
    from tpu3drec_torch.ops import match as tm
    cfg = UnifiedBenchmarkConfig(methods=("SIFT", "ORB"), max_features=64)
    img = SyntheticImageGenerator(width=160, height=120, seed=1).generate()
    real = tm.knn2

    def knn2(d1, d2, m1, m2, metric="l2"):
        if metric == "l2_int8":
            raise RuntimeError("kernel launch failed")
        return real(d1, d2, m1, m2, metric=metric)

    monkeypatch.setattr(tm, "knn2", knn2)
    out = ThroughputTask(cfg, batch=2, reps=1, device="cpu").run(
        [(img, np.roll(img, 2, axis=1))])
    assert "kernel launch failed" in out["SIFT"]["error"]
    assert "error" not in out["ORB"]


# -- profiling and the dataset generator (tests/test_utils_data.py) ----

def test_timer_and_collector():
    with Timer() as t:
        time.sleep(0.01)
    assert t.elapsed >= 0.009
    pc = ProfileCollector()
    for _ in range(3):
        with pc.span("work"):
            time.sleep(0.002)
    s = pc.summary()
    assert s["work"]["count"] == 3
    assert s["work"]["mean_s"] >= 0.001
    pc.reset()
    assert pc.summary() == {}


def test_device_memory_stats_shape():
    import torch
    stats = device_memory_stats()
    assert isinstance(stats, dict)
    assert "host_rss_bytes" in stats
    # the card's keys only where there is a card
    assert ("device_bytes_in_use" in stats) == torch.cuda.is_available()


def test_trace_to_is_safe(tmp_path):
    import torch
    with trace_to(str(tmp_path)):
        _ = torch.ones(10) + 1
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())


def test_downloader_requires_key():
    with pytest.raises(ValueError):
        download_pixabay_images("/tmp/x", api_key=None)


def test_synthetic_dataset_feeds_pipeline(tmp_path, monkeypatch):
    from PIL import Image
    from tpu3drec.data.downloader import (
        generate_synthetic_dataset as j_generate,
    )
    from tpu3drec_torch.pipelines.matching import FeatureProcessingPipeline
    out = generate_synthetic_dataset(tmp_path / "ds", n_views=4,
                                     width=160, height=120, seed=1)
    assert out["generated"] == 4
    ref = j_generate(tmp_path / "ref", n_views=4, width=160, height=120,
                     seed=1)
    assert out["files"] == ref["files"]
    for name in out["files"]:
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "ds" / name)),
            np.asarray(Image.open(tmp_path / "ref" / name)))
    # without PIL the standard-library writer gives the same pixels
    monkeypatch.setitem(sys.modules, "PIL", None)
    generate_synthetic_dataset(tmp_path / "nopil", n_views=4, width=160,
                               height=120, seed=1)
    monkeypatch.delitem(sys.modules, "PIL")
    for name in out["files"]:
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "nopil" / name)),
            np.asarray(Image.open(tmp_path / "ref" / name)))

    pipe = FeatureProcessingPipeline({"methods": ["SIFT"],
                                      "max_features": 256,
                                      "matcher_config": {"SIFT": "bf"}},
                                     device="cpu")
    summary = pipe.match_folder(tmp_path / "ds", tmp_path / "out",
                                batch_size=4)
    assert summary["stats"]["completed"] == 3
    assert summary["stats"]["total_matches"] > 30


def test_png_writer_reads_back_exactly(tmp_path):
    from PIL import Image
    from tpu3drec_torch.io import native_decoder
    a = np.random.default_rng(0).integers(0, 256, (37, 53)).astype(np.uint8)
    write_png_gray(tmp_path / "a.png", a)
    with Image.open(tmp_path / "a.png") as im:
        assert im.mode == "L"
        np.testing.assert_array_equal(np.asarray(im), a)
    assert native_decoder.available()
    x = native_decoder.decode_batch([tmp_path / "a.png"], [(37, 53)])[0]
    np.testing.assert_array_equal(np.rint(x * 255).astype(np.uint8), a)


# -- calibration and plotting (tests/test_refinement_calib_viz.py) -----

def test_checkerboard_calibration():
    import cv2
    from tpu3drec.sfm.calibration import CameraCalibration as JCalib
    rng = np.random.default_rng(1)
    cols, rows = 7, 5
    calib = CameraCalibration(cols, rows, square_size=0.03, device="cpu")
    K_gt = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    obj3 = np.concatenate([calib.obj, np.zeros((cols * rows, 1))], 1)
    corner_sets = []
    for v in range(5):
        R = cv2.Rodrigues(np.array([0.3 + 0.1 * v, -0.2 + 0.15 * v,
                                    0.05 * v]))[0]
        t = np.array([-0.1 + 0.02 * v, -0.07, 0.5 + 0.1 * v])
        Xc = obj3 @ R.T + t
        uv = (Xc / Xc[:, 2:3]) @ K_gt.T
        corner_sets.append(uv[:, :2]
                           + 0.2 * rng.standard_normal((cols * rows, 2)))
    out = calib.calibrate(corner_sets, (640, 480))
    assert abs(out["K"][0, 0] - 600) / 600 < 0.05, out["K"]
    assert abs(out["K"][0, 2] - 320) < 25
    assert out["mean_reproj_px"] < 1.0
    assert out["num_views"] == 5
    ref = JCalib(cols, rows, square_size=0.03).calibrate(corner_sets,
                                                         (640, 480))
    np.testing.assert_allclose(out["K"], ref["K"], rtol=1e-3)
    assert abs(out["mean_reproj_px"] - ref["mean_reproj_px"]) < 1e-3
    with pytest.raises(RuntimeError, match="CUDA"):
        CameraCalibration(cols, rows)        # device=None means CUDA

    # a view whose detection failed (NaN corners) fails its DLT and is
    # dropped with its own corners: the rest calibrate as before
    bad = [corner_sets[0], np.full_like(corner_sets[0], np.nan),
           *corner_sets[1:]]
    out_bad = calib.calibrate(bad, (640, 480))
    assert out_bad["num_views"] == 5
    np.testing.assert_allclose(out_bad["K"], out["K"], rtol=1e-6)
    assert abs(out_bad["mean_reproj_px"] - out["mean_reproj_px"]) < 1e-6
    for (Rb, tb), (R, t) in zip(out_bad["poses"], out["poses"]):
        np.testing.assert_allclose(Rb, R, atol=1e-6)
        np.testing.assert_allclose(tb, t, atol=1e-6)


def test_object_points_layout():
    from tpu3drec.sfm.calibration import (
        checkerboard_object_points as j_points,
    )
    pts = checkerboard_object_points(4, 3, 2.0)
    assert pts.shape == (12, 2)
    assert pts[1, 0] == 2.0 and pts[4, 1] == 2.0
    np.testing.assert_array_equal(pts, j_points(4, 3, 2.0))


def test_visualization_smoke(tmp_path):
    import cv2
    from tpu3drec_torch import viz
    from tpu3drec_torch.api import detect_features, match_images
    from tpu3drec_torch.io.converters import ResultConverter
    from tpu3drec_torch.pipelines.matching import FeatureProcessingPipeline
    rng = np.random.default_rng(2)
    img = np.zeros((120, 160), np.float32)
    for _ in range(25):
        y, x = rng.integers(5, 100), rng.integers(5, 140)
        img[y:y + 12, x:x + 12] += rng.uniform(-0.5, 0.5)
    img -= img.min()
    img /= img.max()
    M = cv2.getRotationMatrix2D((80, 60), 6.0, 0.97)
    warped = cv2.warpAffine(img, M, (160, 120))

    r = match_images(img, warped, method="SIFT", max_features=256,
                     device="cpu")
    ax = viz.visualize_matches(img, warped, r)
    p = viz.save_visualization(ax, tmp_path / "matches.png")
    assert p.exists() and p.stat().st_size > 1000

    f = detect_features(img, "SIFT", max_features=128, device="cpu")
    ax2 = viz.visualize_keypoints_only(img, f)
    viz.save_visualization(ax2, tmp_path / "kpts.png")
    assert (tmp_path / "kpts.png").exists()

    pipe = FeatureProcessingPipeline({"methods": ["SIFT"],
                                      "max_features": 128,
                                      "matcher_config": {"SIFT": "bf"}},
                                     device="cpu")
    mr = pipe.match(img, warped)
    fig = viz.plot_method_comparison(img, warped, mr)
    viz.save_visualization(fig, tmp_path / "cmp.png")
    assert (tmp_path / "cmp.png").exists()
    # VisualizationData.plot draws the same comparison
    fig2 = ResultConverter.to_visualization(mr, img, warped).plot()
    viz.save_visualization(fig2, tmp_path / "vd.png")
    assert (tmp_path / "vd.png").stat().st_size > 1000
