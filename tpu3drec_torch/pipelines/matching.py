"""FeatureProcessingPipeline: multi-method pair matching and folder batches.

Port of `tpu3drec/pipelines/matching.py`. `match` runs every configured
detector method over one pair, matches with the method's configured
matcher, applies homography RANSAC filtering and geometry metrics, and
returns a multi-method MatchingResult. `match_folder` scans metadata
only, generates pairs, loads batches through the byte-budgeted cache,
checkpoints progress.json after every pair, and auto-saves batch pickles,
COLMAP exports and a batch summary.

The batched folder engine (`_match_pairs_batched`) detects a batch's
unique images in one call per method and matches + RANSACs all its pairs
in one more, then pulls each call's outputs to the host once. Detected
features are memoized per (image, method) within a folder run. The
engine works at the batch's real counts (the reference pads images and
pairs to buckets for its compile cache), and each pair's RANSAC draws
come from its own CPU generator seeded with its index in the batch, so
the card and the CPU draw the same samples. Like the reference's, the
engine matches every method by kNN, also one configured for `lightglue`:
LightGlue runs on the per-pair path (`match`, `engine="perpair"`).

Failures: the reference turns any exception into a degraded result (the
batched engine falls back to the per-pair path, a method yields an empty
result with `error`, a pair counts as failed). The port does the same for
every exception but `RuntimeError`, which is how a kernel wrapper or a
CUDA fault reports: it propagates, so a fault on the card is never
counted as a bad input. Each fallback of the batched engine is counted in
the summary's `stats["engine_fallbacks"]`, and each method result that
carries an `error` in `stats["method_errors"]`.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu3drec_torch.core.config import (
    DEFAULT_CONFIG, MATCHER_SPECIFIC_CONFIGS, create_config_from_preset,
    merge_configs, validate_config,
)
from tpu3drec_torch.core.device import resolve_device
from tpu3drec_torch.core.types import (
    Features, Matches, MatchingResult, MethodResult, ScoreType,
)
from tpu3drec_torch.io.batch_pickle import (
    pair_data_from_result, save_batch, save_image_metadata,
)
from tpu3drec_torch.io.checkpoint import BatchProcessor
from tpu3drec_torch.io.colmap import export_pair_matches
from tpu3drec_torch.io.images import (
    FolderImageSource, create_pairs_from_metadata,
)
from tpu3drec_torch.ops.ransac import draw_uniform

# RANSAC hypotheses: the reference's per-pair default and its batched engine's
PAIR_HYPOTHESES = 512
BATCH_HYPOTHESES = 256


def _pull(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Host copies of `tensors` in one device-to-host copy: each is cast to
    float32 (exact for the bools, the indices below 2**24 and the float32
    values these hold), flattened, concatenated, copied once and restored
    to its shape and dtype."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    host = flat.cpu()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(host[at:at + n].reshape(t.shape).to(t.dtype))
        at += n
    return out


def _pair_uniforms(n_pairs: int, num_hypotheses: int) -> torch.Tensor:
    """(n_pairs, K, 4) RANSAC uniforms, pair b's from a CPU generator
    seeded with b."""
    return torch.stack([
        draw_uniform(num_hypotheses, 4, torch.Generator().manual_seed(b))
        for b in range(n_pairs)])


class FeatureProcessingPipeline:
    """Multi-method detect/match/filter pipeline on `device` (None means
    CUDA)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None, device=None):
        from tpu3drec_torch.api import _get_detector_registry
        self.config = merge_configs(DEFAULT_CONFIG, config)
        problems = validate_config(self.config)
        if problems:
            raise ValueError("invalid config: " + "; ".join(problems))
        self.device = resolve_device(device)
        registry = _get_detector_registry()
        self.methods = [m for m in self.config["methods"] if m in registry]
        if not self.methods:
            raise ValueError(
                f"no available detectors among {self.config['methods']}")
        self._feature_cache: Dict[Tuple[str, str], Features] = {}
        # device calls of the batched engine: 2 per method per batch
        self.dispatch_count = 0

    # -- single pair ---------------------------------------------------

    def _detect(self, image, method: str, name: Optional[str] = None) -> Features:
        from tpu3drec_torch.api import detect_features
        if name is not None:
            key = (name, method)
            hit = self._feature_cache.get(key)
            if hit is not None:
                # the batched engine caches host copies
                return hit.to(self.device)
        feats = detect_features(image, method, config=self.config,
                                device=self.device)
        if name is not None:
            self._feature_cache[key] = feats
        return feats

    def _matcher_params(self, method: str) -> Tuple[str, Dict[str, Any]]:
        matcher = (self.config.get("matcher_config") or {}).get(
            method, "auto")
        mp = dict(MATCHER_SPECIFIC_CONFIGS.get(matcher, {}))
        mp.update((self.config.get("matcher_params") or {}).get(method, {}))
        return matcher, mp

    def _empty_result(self, method: str, error: str) -> MethodResult:
        dev = self.device
        return MethodResult(
            method=method,
            features1=Features.empty(1, 1, method=method, device=dev),
            features2=Features.empty(1, 1, method=method, device=dev),
            matches=Matches(idx1=torch.zeros(1, dtype=torch.int32, device=dev),
                            idx2=torch.zeros(1, dtype=torch.int32, device=dev),
                            score=torch.zeros(1, device=dev),
                            mask=torch.zeros(1, dtype=torch.bool, device=dev)),
            error=error)

    def match(self, image1, image2,
              image1_name: str = "", image2_name: str = "") -> MatchingResult:
        """One pair through all configured methods."""
        from tpu3drec_torch.ops.geometry import (
            find_homography, reprojection_error_homography,
        )
        from tpu3drec_torch.ops.match import (
            auto_select_matcher, match_features,
        )

        t_start = time.perf_counter()
        results: Dict[str, MethodResult] = {}
        filtering = self.config.get("filtering", {})
        ransac_thr = filtering.get("ransac_threshold", 4.0)
        use_filter = filtering.get("use_adaptive_filtering", True)

        for method in self.methods:
            try:
                t0 = time.perf_counter()
                f1 = self._detect(image1, method, image1_name or None)
                f2 = self._detect(image2, method, image2_name or None)
                int(f1.mask.sum() + f2.mask.sum())      # wait for the device
                t1 = time.perf_counter()

                matcher, mp = self._matcher_params(method)
                matcher_used = matcher
                m = None
                if matcher == "lightglue":
                    # LightGlue where converted weights fit the
                    # descriptors; otherwise kNN, and the fallback recorded
                    from tpu3drec_torch.models.lightglue import (
                        match_features_lightglue,
                    )
                    try:
                        m = match_features_lightglue(
                            f1, f2, filter_threshold=mp.get(
                                "filter_threshold", 0.1))
                    except ImportError as fe:
                        matcher_used = f"knn (lightglue fallback: {fe})"
                elif matcher == "auto":
                    matcher_used = auto_select_matcher(f1)
                if m is None:
                    m = match_features(
                        f1, f2, ratio=mp.get("ratio_threshold", 0.75),
                        cross_check=mp.get("cross_check", False),
                        method=method)
                int(m.mask.sum())
                t2 = time.perf_counter()

                result = MethodResult(
                    method=method, features1=f1, features2=f2, matches=m,
                    detection_time=t1 - t0, matching_time=t2 - t1,
                    matcher_used=matcher_used)

                if use_filter:
                    p1, p2 = m.gather_points(f1, f2)
                    u = draw_uniform(PAIR_HYPOTHESES, 4,
                                     torch.Generator().manual_seed(0))
                    rr = find_homography(p1, p2, mask=m.mask,
                                         threshold=ransac_thr, u=u)
                    if bool(rr.success):
                        result.filtered_matches = m.replace(mask=rr.inliers)
                        result.homography = rr.model.cpu().numpy()
                        result.inlier_ratio = float(rr.inlier_ratio)
                        result.reprojection_error = float(
                            reprojection_error_homography(
                                rr.model, p1, p2, rr.inliers))
                results[method] = result
            except RuntimeError:
                raise          # a kernel or CUDA fault: never a bad input
            except Exception as e:  # noqa: BLE001 - per-method fault tolerance
                results[method] = self._empty_result(method, str(e))

        shape1 = tuple(np.asarray(image1).shape[:2])
        shape2 = tuple(np.asarray(image2).shape[:2])
        return MatchingResult(
            results=results,
            image1_name=image1_name, image2_name=image2_name,
            image1_shape=shape1, image2_shape=shape2,
            total_processing_time=time.perf_counter() - t_start,
        )

    # -- batched folder engine -------------------------------------------

    def _match_pairs_batched(self, images: Dict[str, np.ndarray],
                             pairs: Sequence[Tuple[str, str]]
                             ) -> Dict[Tuple[str, str], MatchingResult]:
        """Whole-batch pair matching in two device calls per method: the
        batch's unique images detect as one batched call, and all pairs
        match + RANSAC as one more. Needs images of one shape."""
        from tpu3drec_torch.api import unit_float
        from tpu3drec_torch.ops import image as imops

        names = sorted({n for p in pairs for n in p})
        host = np.stack([unit_float(images[n]) for n in names])
        stack = imops.to_device(torch.from_numpy(host), self.device)
        if stack.ndim == 4:                  # (U, H, W, 3) RGB
            stack = imops.rgb_to_gray(stack)

        per_method = {m: self._batched_one_method(m, stack, names, pairs)
                      for m in self.methods}
        results: Dict[Tuple[str, str], MatchingResult] = {}
        for (n1, n2) in pairs:
            mrs = {m: per_method[m][(n1, n2)] for m in self.methods}
            results[(n1, n2)] = MatchingResult(
                results=mrs,
                image1_name=n1, image2_name=n2,
                image1_shape=tuple(np.asarray(images[n1]).shape[:2]),
                image2_shape=tuple(np.asarray(images[n2]).shape[:2]),
                total_processing_time=sum(
                    mr.total_time for mr in mrs.values()))
        return results

    def _batched_one_method(self, method: str, stack: torch.Tensor,
                            names: List[str],
                            pairs: Sequence[Tuple[str, str]]
                            ) -> Dict[Tuple[str, str], MethodResult]:
        """One method's whole-batch detect (1 device call, 1 host pull) +
        match and RANSAC (1 device call, 1 host pull) over an image
        stack."""
        from tpu3drec_torch.api import _detector_params, _get_detector_registry
        from tpu3drec_torch.ops.geometry import (
            find_homography, reprojection_error_homography,
        )
        from tpu3drec_torch.ops.match import _match_impl, _metric_for

        filtering = self.config.get("filtering", {})
        thr = float(filtering.get("ransac_threshold", 4.0))
        use_filter = filtering.get("use_adaptive_filtering", True)
        _, mp = self._matcher_params(method)
        ratio = float(mp.get("ratio_threshold", 0.75))
        cross = bool(mp.get("cross_check", False))

        t0 = time.perf_counter()
        det = _get_detector_registry()[method]
        feats = det(stack, **_detector_params(method, self.config, None))
        fields = ("xy", "response", "scale", "angle", "desc", "mask")
        host = dict(zip(fields, _pull([getattr(feats, k) for k in fields])))
        self.dispatch_count += 1
        t1 = time.perf_counter()

        per_image = {}
        for i, n in enumerate(names):
            fi = feats.replace(**{k: v[i] for k, v in host.items()})
            per_image[n] = fi
            self._feature_cache[(n, method)] = fi

        idx = {n: i for i, n in enumerate(names)}
        dev = stack.device
        i1 = torch.tensor([idx[a] for a, _ in pairs], device=dev)
        i2 = torch.tensor([idx[b] for _, b in pairs], device=dev)
        metric = _metric_for(feats)
        best, dist, ok = _match_impl(feats.desc[i1], feats.desc[i2],
                                     feats.mask[i1], feats.mask[i2],
                                     ratio, cross, metric)
        p1 = feats.xy[i1]
        p2 = feats.xy[i2].gather(1, best.long()[..., None].expand(-1, -1, 2))
        rr = find_homography(p1, p2, mask=ok, threshold=thr,
                             num_hypotheses=BATCH_HYPOTHESES,
                             u=_pair_uniforms(len(pairs), BATCH_HYPOTHESES))
        err = reprojection_error_homography(rr.model, p1, p2, rr.inliers)
        (best, dist, ok, H, inl, inl_ratio, success, err) = _pull(
            [best, dist, ok, rr.model, rr.inliers, rr.inlier_ratio,
             rr.success, err])
        self.dispatch_count += 1
        t2 = time.perf_counter()

        det_share = (t1 - t0) / max(len(pairs), 1)
        match_share = (t2 - t1) / max(len(pairs), 1)
        cap = feats.xy.shape[-2]
        out_mrs: Dict[Tuple[str, str], MethodResult] = {}
        for b, (n1, n2) in enumerate(pairs):
            m = Matches(
                idx1=torch.arange(cap, dtype=torch.int32),
                idx2=best[b].to(torch.int32),
                score=torch.where(ok[b], dist[b], torch.zeros_like(dist[b])),
                mask=ok[b],
                score_type=ScoreType.DISTANCE.value,
                method=method)
            mr = MethodResult(
                method=method,
                features1=per_image[n1], features2=per_image[n2],
                matches=m,
                detection_time=det_share, matching_time=match_share,
                matcher_used=f"knn-batched[{metric}]")
            if bool(success[b]):
                if use_filter:
                    mr.filtered_matches = m.replace(mask=inl[b])
                mr.homography = H[b].numpy()
                mr.inlier_ratio = float(inl_ratio[b])
                mr.reprojection_error = float(err[b])
            out_mrs[(n1, n2)] = mr
        return out_mrs

    def match_folder(self, folder, output_dir,
                     pair_mode: str = "consecutive",
                     pair_window: int = 1,
                     batch_size: Optional[int] = None,
                     resume: bool = True,
                     auto_save: bool = True,
                     export_colmap: bool = False,
                     max_images: Optional[int] = None,
                     resize_to: Optional[Tuple[int, int]] = None,
                     base_name: str = "results",
                     pairs: Optional[List] = None,
                     collect_results: bool = False,
                     engine: str = "auto") -> Dict[str, Any]:
        """Batch job over an image folder.

        `pairs` overrides pair generation with an explicit subset.
        `collect_results` keeps every pair's reconstruction payload in
        memory and returns it as summary['matches_data'] (with
        summary['image_info']), the in-process handoff to SfM; the pickles
        are still written when auto_save=True. `engine`: 'auto' uses the
        batched engine when the batch's images share one shape, 'perpair'
        forces the per-pair loop."""
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        batch_size = batch_size or self.config.get("pair_batch_size", 8)
        resize_to = resize_to or self.config.get("image_size")

        source = FolderImageSource(folder, resize_to=resize_to,
                                   max_images=max_images)
        metas = source.get_metadata_list()
        if pairs is None:
            pairs = create_pairs_from_metadata(metas, pair_mode, pair_window)
        bp = BatchProcessor(output_dir,
                            metadata={"folder": str(folder),
                                      "pair_mode": pair_mode})
        if not resume:
            bp.reset()

        if auto_save:
            save_image_metadata(output_dir, base_name, metas)

        self._feature_cache.clear()
        t_start = time.perf_counter()
        stats = {"total_pairs": len(pairs), "completed": 0, "skipped": 0,
                 "failed": 0, "total_matches": 0, "engine_fallbacks": 0,
                 "method_errors": 0}
        batch_results: Dict[Tuple[str, str], Dict] = {}
        collected: Dict[Tuple[str, str], Dict] = {}
        batch_number = 0
        summaries: List[Dict] = []

        for batch_start in range(0, len(pairs), batch_size):
            batch_pairs = pairs[batch_start:batch_start + batch_size]
            todo = [p for p in batch_pairs if not (resume and bp.is_completed(p))]
            stats["skipped"] += len(batch_pairs) - len(todo)
            if not todo:
                continue
            unique = sorted({n for p in todo for n in p})
            images = source.load_many(unique)
            # evict features of images no longer needed
            live = set(unique)
            self._feature_cache = {k: v for k, v in self._feature_cache.items()
                                   if k[0] in live}

            precomputed: Dict[Tuple[str, str], MatchingResult] = {}
            if engine != "perpair":
                shapes = {np.asarray(images[n]).shape[:2] for n in unique}
                if len(shapes) == 1:
                    try:
                        precomputed = self._match_pairs_batched(images, todo)
                    except RuntimeError:
                        raise      # a kernel or CUDA fault surfaces
                    except Exception:  # noqa: BLE001 - degrade, and count it
                        stats["engine_fallbacks"] += 1
                        precomputed = {}

            for (n1, n2) in todo:
                try:
                    res = precomputed.get((n1, n2)) \
                        or self.match(images[n1], images[n2], n1, n2)
                    stats["method_errors"] += sum(
                        1 for r in res.values() if r.error)
                    best = res.get_best()
                    if best is not None:
                        pd = pair_data_from_result(best)
                        batch_results[(n1, n2)] = pd
                        if collect_results:
                            collected[(n1, n2)] = pd
                        stats["total_matches"] += best.num_matches
                        summaries.append(res.summary())
                        if export_colmap and best.num_matches > 0:
                            m = best.best_matches.to_numpy()
                            export_pair_matches(
                                output_dir / "colmap" / f"{n1}__{n2}",
                                Path(n1).stem, Path(n2).stem,
                                best.features1.to_numpy()["xy"],
                                best.features2.to_numpy()["xy"],
                                np.stack([m["idx1"], m["idx2"]], 1)
                                if len(m["idx1"]) else np.zeros((0, 2)))
                    stats["completed"] += 1
                except RuntimeError:
                    raise          # a kernel or CUDA fault surfaces
                except Exception as e:  # noqa: BLE001 - a bad pair is counted
                    batch_results[(n1, n2)] = {"error": str(e)}
                    stats["failed"] += 1
                bp.mark_completed((n1, n2))  # checkpoint after EVERY pair

            if auto_save and batch_results:
                progress = {
                    "progress_percent": 100.0 * (batch_start + len(batch_pairs))
                    / max(len(pairs), 1),
                }
                save_batch(output_dir, base_name, batch_number, batch_results,
                           config={"feature_type": "+".join(self.methods),
                                   **{k: v for k, v in self.config.items()
                                      if k in ("methods", "max_features")}},
                           progress=progress)
                batch_results = {}
                batch_number += 1

        summary = self._create_batch_summary(stats, summaries,
                                             time.perf_counter() - t_start,
                                             source)
        if auto_save:
            (output_dir / "batch_summary.json").write_text(
                json.dumps(summary, indent=2, default=str))
        if collect_results:
            summary["matches_data"] = collected
            summary["image_info"] = {
                m.name: {"name": m.name, "width": m.width,
                         "height": m.height} for m in metas}
        return summary

    def _create_batch_summary(self, stats, summaries, wall_time,
                              source) -> Dict[str, Any]:
        """Counts, per-method mean quality (and, beyond the reference's
        summary, mean raw matches), the batched engine's device calls,
        cache statistics, config."""
        per_method: Dict[str, List[float]] = {}
        raw: Dict[str, List[int]] = {}
        for s in summaries:
            for m, info in s["methods"].items():
                per_method.setdefault(m, []).append(info["quality_score"])
                raw.setdefault(m, []).append(info["num_raw_matches"])
        return {
            "stats": stats,
            "wall_time_s": wall_time,
            "pairs_per_s": stats["completed"] / wall_time if wall_time > 0 else 0,
            "methods": {m: {"mean_quality": float(np.mean(v)), "pairs": len(v),
                            "mean_raw_matches": float(np.mean(raw[m]))}
                        for m, v in per_method.items()},
            "dispatch_count": self.dispatch_count,
            "cache": source.loader.cache.stats(),
            "config": {k: v for k, v in self.config.items()
                       if k in ("methods", "max_features", "combine_strategy")},
        }


def create_pipeline(preset: str = "balanced",
                    config: Optional[Dict[str, Any]] = None,
                    device=None) -> FeatureProcessingPipeline:
    """A FeatureProcessingPipeline from a preset, on `device`."""
    return FeatureProcessingPipeline(create_config_from_preset(preset, config),
                                     device=device)
