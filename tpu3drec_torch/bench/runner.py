"""Unified benchmark runner: performance, batched-throughput and accuracy
tasks, combined ranking, JSON export, table printer.

Port of `tpu3drec/bench/runner.py` over the port's `api`, on `device`
(None means CUDA):

- `PerformanceTask` times `match_images` per pair and method, with
  tracemalloc + psutil RSS and the card's allocator counters;
- `ThroughputTask` runs a batch of pairs per method as one batched
  detection of all 2B images, one `knn2` call over the B pairs (the
  reference's metric choice: `hamming_pm1` for binary descriptors,
  `l2_int8` for SIFT, `l2` otherwise) and the ratio test; the first call
  is `compile_time_s` (on the card it includes building the kernels);
- `AccuracyTask` scores matches against the known transforms of
  `create_transform_pair`.

Each task records an exception in one method as `{"error": ...}` for
that method, as the reference does; callers that must not pass over a
kernel fault check every entry for `error`.
"""

from __future__ import annotations

import dataclasses
import json
import time
import tracemalloc
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpu3drec_torch.bench.metrics import AdvancedQualityMetrics
from tpu3drec_torch.bench.stats import StatisticalAnalyzer, describe
from tpu3drec_torch.bench.synthetic import (
    SyntheticImageGenerator, create_transform_pair,
)
from tpu3drec_torch.core.device import resolve_device
from tpu3drec_torch.io.converters import _host


@dataclasses.dataclass
class UnifiedBenchmarkConfig:
    """The reference's benchmark configuration, field for field."""
    methods: Sequence[str] = ("SIFT", "ORB")
    max_features: int = 2000
    num_runs: int = 5
    image_size: Tuple[int, int] = (480, 640)   # (H, W)
    transform_types: Sequence[str] = ("perspective", "affine",
                                      "rotation", "scale")
    transform_magnitude: float = 0.3
    ratio_threshold: float = 0.75
    ransac_threshold: float = 4.0
    measure_memory: bool = True
    seed: int = 42
    # batched-throughput task; the per-call PerformanceTask stays for
    # parity with the reference
    measure_throughput: bool = True
    throughput_batch: int = 8
    throughput_reps: int = 3


def _device_memory_stats() -> Dict:
    from tpu3drec_torch.utils.profiling import device_memory_stats
    s = device_memory_stats()
    return {k: s[k] for k in ("device_bytes_in_use", "device_peak_bytes")
            if k in s}


class PerformanceTask:
    """Timing + memory per method over single pairs."""

    def __init__(self, config: UnifiedBenchmarkConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    def _match(self, img1, img2, method, **kw):
        from tpu3drec_torch.api import match_images
        return match_images(img1, img2, method=method,
                            max_features=self.config.max_features,
                            ratio=self.config.ratio_threshold,
                            device=self.device, **kw)

    def run(self, image_pairs: Sequence[Tuple[np.ndarray, np.ndarray]]
            ) -> Dict[str, Dict]:
        results: Dict[str, Dict] = {}
        for method in self.config.methods:
            runs: List[Dict] = []
            try:
                # first call outside the timed runs
                self._match(image_pairs[0][0], image_pairs[0][1], method)
            except Exception as e:
                results[method] = {"error": str(e)}
                continue
            for run in range(self.config.num_runs):
                img1, img2 = image_pairs[run % len(image_pairs)]
                proc = None
                baseline_mb = 0.0
                if self.config.measure_memory:
                    try:
                        import psutil
                        proc = psutil.Process()
                        baseline_mb = proc.memory_info().rss / 1e6
                    except Exception:
                        proc = None
                    tracemalloc.start()
                t0 = time.perf_counter()
                r = self._match(img1, img2, method,
                                ransac_threshold=self.config.ransac_threshold)
                dt = time.perf_counter() - t0
                mem = {}
                if self.config.measure_memory:
                    cur, peak = tracemalloc.get_traced_memory()
                    tracemalloc.stop()
                    mem = {"traced_current_mb": cur / 1e6,
                           "traced_peak_mb": peak / 1e6}
                    if proc is not None:
                        final_mb = proc.memory_info().rss / 1e6
                        mem.update({
                            "baseline_mb": baseline_mb,
                            "final_mb": final_mb,
                            "rss_mb": final_mb,
                            "net_increase_mb": final_mb - baseline_mb,
                        })
                    mem.update(_device_memory_stats())
                runs.append({
                    "pipeline_time": dt,
                    "num_matches": r.num_matches,
                    "num_raw_matches": r.num_raw_matches,
                    "detection_time": r.detection_time,
                    "matching_time": r.matching_time,
                    "memory": mem,
                })
            times = [r["pipeline_time"] for r in runs]
            matches = [r["num_matches"] for r in runs]
            peaks = [r["memory"].get("traced_peak_mb") for r in runs
                     if r["memory"].get("traced_peak_mb") is not None]
            nets = [r["memory"].get("net_increase_mb") for r in runs
                    if r["memory"].get("net_increase_mb") is not None]
            results[method] = {
                "raw_runs": runs,
                "avg_pipeline_time": float(np.mean(times)),
                "fps": float(1.0 / max(np.mean(times), 1e-9)),
                "avg_matches": float(np.mean(matches)),
                "matches_per_second": float(
                    np.mean(matches) / max(np.mean(times), 1e-9)),
                "time_stats": describe(times),
                "memory_summary": {
                    "avg_traced_peak_mb":
                        float(np.mean(peaks)) if peaks else None,
                    "avg_net_increase_mb":
                        float(np.mean(nets)) if nets else None,
                },
            }
        return results


class ThroughputTask:
    """Batched detect + match pairs/s per method: `batch` pairs go through
    one detection call (all 2 x batch images), one `knn2` call and the
    ratio test, as the batched folder engine runs them."""

    def __init__(self, config: UnifiedBenchmarkConfig,
                 batch: int = 8, reps: int = 3, device=None):
        self.config = config
        self.batch = batch
        self.reps = reps
        self.device = resolve_device(device)

    @staticmethod
    def _metric_for(method: str, feats) -> str:
        from tpu3drec_torch.core.types import DescriptorKind
        if feats.desc_kind == DescriptorKind.BINARY.value:
            return "hamming_pm1"    # +-1 int8 encoding, exact
        return "l2_int8" if method == "SIFT" else "l2"

    def run(self, image_pairs: Sequence[Tuple[np.ndarray, np.ndarray]]
            ) -> Dict[str, Dict]:
        import torch
        from tpu3drec_torch.api import (
            _detector_params, _get_detector_registry, prepare_image,
        )
        from tpu3drec_torch.ops.match import knn2

        registry = _get_detector_registry()
        # tile the provided pairs up to the batch size
        reps_needed = -(-self.batch // len(image_pairs))
        tiled = (list(image_pairs) * reps_needed)[:self.batch]
        stack = torch.stack([prepare_image(a, self.device) for a, _ in tiled]
                            + [prepare_image(b, self.device)
                               for _, b in tiled])
        B = self.batch
        ratio = self.config.ratio_threshold
        results: Dict[str, Dict] = {}
        for method in self.config.methods:
            if method not in registry:
                results[method] = {"error": f"unavailable: {method}"}
                continue
            try:
                params = _detector_params(method, None,
                                          self.config.max_features)
                detect = registry[method]

                def batched():
                    f = detect(stack, **params)
                    metric = self._metric_for(method, f)
                    _, dist = knn2(f.desc[:B], f.desc[B:], f.mask[:B],
                                   f.mask[B:], metric=metric)
                    ok = (dist[..., 0]
                          < ratio * torch.clamp(dist[..., 1], min=1e-12)) \
                        & f.mask[:B]
                    return ok.sum(-1).cpu().numpy(), metric

                t0 = time.perf_counter()
                n_matches, metric = batched()
                compile_s = time.perf_counter() - t0
                times = []
                for _ in range(self.reps):
                    t0 = time.perf_counter()
                    n_matches, _ = batched()
                    times.append(time.perf_counter() - t0)
                med = float(np.median(times))
                results[method] = {
                    "batch": self.batch,
                    "reps": self.reps,
                    "metric": metric,
                    "batched_pairs_per_s": self.batch / max(med, 1e-9),
                    "median_batch_time_s": med,
                    "compile_time_s": compile_s,
                    "avg_matches": float(np.mean(n_matches)),
                    "time_stats": describe(times),
                }
            except Exception as e:
                results[method] = {"error": str(e)}
        return results


class AccuracyTask:
    """Match quality against known transforms."""

    def __init__(self, config: UnifiedBenchmarkConfig, device=None):
        self.config = config
        self.device = resolve_device(device)

    def run(self, base_images: Sequence[np.ndarray]) -> Dict[str, Dict]:
        from tpu3drec_torch.api import match_images
        results: Dict[str, Dict] = {}
        for method in self.config.methods:
            per_transform: Dict[str, List[float]] = {}
            all_quality: List[float] = []
            all_matches: List[int] = []
            try:
                for ti, ttype in enumerate(self.config.transform_types):
                    for bi, base in enumerate(base_images):
                        warped, H_gt = create_transform_pair(
                            base, ttype, self.config.transform_magnitude,
                            seed=self.config.seed + 31 * ti + bi)
                        r = match_images(
                            base, warped, method=method,
                            max_features=self.config.max_features,
                            ratio=self.config.ratio_threshold,
                            device=self.device)
                        m = r.best_matches.to_numpy()
                        p1 = _host(r.features1.xy)[m["idx1"]]
                        p2 = _host(r.features2.xy)[m["idx2"]]
                        q = AdvancedQualityMetrics \
                            .comprehensive_quality_assessment(
                                p1, p2, r.homography, H_gt, base.shape)
                        per_transform.setdefault(ttype, []).append(
                            q["overall_quality"])
                        all_quality.append(q["overall_quality"])
                        all_matches.append(len(p1))
            except Exception as e:
                results[method] = {"error": str(e)}
                continue
            results[method] = {
                "avg_quality": (float(np.mean(all_quality))
                                if all_quality else 0.0),
                "avg_matches": (float(np.mean(all_matches))
                                if all_matches else 0.0),
                "per_transform": {t: float(np.mean(v))
                                  for t, v in per_transform.items()},
            }
        return results


class UnifiedBenchmarkPipeline:
    """Runs the three tasks on synthetic images, a folder or one pair."""

    def __init__(self, config: Optional[UnifiedBenchmarkConfig] = None,
                 device=None):
        self.config = config or UnifiedBenchmarkConfig()
        self.device = resolve_device(device)

    # -- entry points --------------------------------------------------

    def benchmark_synthetic(self, n_images: int = 3) -> Dict:
        h, w = self.config.image_size
        gen = SyntheticImageGenerator(width=w, height=h,
                                      seed=self.config.seed)
        bases = [gen.generate(seed=self.config.seed + i)
                 for i in range(n_images)]
        pairs = [(bases[i],
                  create_transform_pair(bases[i], "perspective", 0.2,
                                        seed=i)[0])
                 for i in range(n_images)]
        return self._run(pairs, bases)

    def benchmark_folder(self, folder, max_images: int = 10) -> Dict:
        from tpu3drec_torch.io.images import FolderImageSource
        src = FolderImageSource(folder, resize_to=self.config.image_size,
                                max_images=max_images)
        names = src.names()
        imgs = [src.load(n) for n in names]
        pairs = [(imgs[i], imgs[i + 1]) for i in range(len(imgs) - 1)]
        return self._run(pairs, imgs[:3])

    def benchmark_single_pair(self, img1, img2) -> Dict:
        return self._run([(img1, img2)], [np.asarray(img1)])

    # -- core ----------------------------------------------------------

    def _run(self, pairs, bases) -> Dict:
        t0 = time.time()
        perf = PerformanceTask(self.config, self.device).run(pairs)
        acc = AccuracyTask(self.config, self.device).run(bases)
        thr = {}
        if self.config.measure_throughput:
            thr = ThroughputTask(self.config,
                                 batch=self.config.throughput_batch,
                                 reps=self.config.throughput_reps,
                                 device=self.device).run(pairs)
        analysis = self._combined_analysis(perf, acc, thr)
        return {
            "timestamp": t0,
            "config": dataclasses.asdict(self.config),
            "device": str(self.device),
            "benchmarks": {
                "performance": {"summary": perf},
                "accuracy": {"summary": acc},
                "throughput": {"summary": thr},
            },
            "analysis": analysis,
        }

    def _combined_analysis(self, perf: Dict, acc: Dict,
                           thr: Optional[Dict] = None) -> Dict:
        """Rank = mean of the normalised speed and quality. On the card
        the speed is the batched pairs/s (ThroughputTask); on the CPU it
        is the per-call FPS, as in the reference."""
        thr = thr or {}
        methods = [m for m in perf if "error" not in perf[m]]
        if not methods:
            return {"ranking": []}
        use_thr = (self.device.type != "cpu"
                   and all("error" not in thr.get(m, {"error": 1})
                           for m in methods))
        if use_thr:
            fps = {m: thr[m]["batched_pairs_per_s"] for m in methods}
        else:
            fps = {m: perf[m]["fps"] for m in methods}
        qual = {m: acc.get(m, {}).get("avg_quality", 0.0) for m in methods}
        max_fps = max(fps.values()) or 1.0
        max_q = max(qual.values()) or 1.0
        combined = {m: 0.5 * fps[m] / max_fps + 0.5 * qual[m] / max_q
                    for m in methods}
        ranking = sorted(combined.items(), key=lambda kv: -kv[1])
        # pairwise significance on pipeline times
        comparisons = {}
        for i, a in enumerate(methods):
            for b in methods[i + 1:]:
                ta = [r["pipeline_time"] for r in perf[a]["raw_runs"]]
                tb = [r["pipeline_time"] for r in perf[b]["raw_runs"]]
                comparisons[f"{a}_vs_{b}"] = \
                    StatisticalAnalyzer.compare_methods(ta, tb)
        return {"ranking": ranking, "combined_scores": combined,
                "speed_metric": ("batched_pairs_per_s" if use_thr
                                 else "fps"),
                "statistical_comparisons": comparisons}

    # -- output --------------------------------------------------------

    def save_results(self, results: Dict, output_dir=".") -> Path:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"benchmark_results_{int(results['timestamp'])}.json"
        path.write_text(json.dumps(results, indent=2, default=str))
        return path

    @staticmethod
    def print_table(results: Dict) -> str:
        perf = results["benchmarks"]["performance"]["summary"]
        acc = results["benchmarks"]["accuracy"]["summary"]
        thr = results["benchmarks"].get("throughput", {}).get("summary", {})
        lines = [f"{'method':<12} {'time(s)':>9} {'FPS':>8} "
                 f"{'pairs/s':>9} {'matches':>8} {'quality':>8}"]
        lines.append("-" * 60)
        for m, p in perf.items():
            if "error" in p:
                lines.append(f"{m:<12} ERROR: {p['error'][:40]}")
                continue
            q = acc.get(m, {}).get("avg_quality", float("nan"))
            tp = thr.get(m, {}).get("batched_pairs_per_s")
            tp_s = f"{tp:>9.2f}" if tp is not None else f"{'-':>9}"
            lines.append(f"{m:<12} {p['avg_pipeline_time']:>9.3f} "
                         f"{p['fps']:>8.2f} {tp_s} "
                         f"{p['avg_matches']:>8.0f} {q:>8.3f}")
        table = "\n".join(lines)
        print(table)
        return table


def quick_synthetic_benchmark(methods=("SIFT", "ORB"), num_runs: int = 3,
                              image_size=(240, 320), device=None,
                              **kw) -> Dict:
    cfg = UnifiedBenchmarkConfig(methods=methods, num_runs=num_runs,
                                 image_size=image_size, **kw)
    return UnifiedBenchmarkPipeline(cfg, device).benchmark_synthetic()


def quick_folder_benchmark(folder, methods=("SIFT", "ORB"),
                           num_runs: int = 3, device=None, **kw) -> Dict:
    cfg = UnifiedBenchmarkConfig(methods=methods, num_runs=num_runs, **kw)
    return UnifiedBenchmarkPipeline(cfg, device).benchmark_folder(folder)
