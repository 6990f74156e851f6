"""Result converters: reconstruction-ready exports, CSV summaries,
multi-method containers.

Port of `tpu3drec/io/converters.py`: `MethodReconstructionData`
(Nx4 correspondences, scores, COLMAP export), `MultiMethodReconstruction`
(dict-like, best-method selection, export_all), `save_for_reconstruction`
/ `load_for_reconstruction`, the CSV export, and `VisualizationData`
(plotted by `viz.plot_method_comparison`). Results may hold their
tensors on any device; everything written is numpy.
"""

from __future__ import annotations

import csv
import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class MethodReconstructionData:
    """Per-method reconstruction payload."""

    def __init__(self, method: str, correspondences: np.ndarray,
                 scores: Optional[np.ndarray] = None,
                 inlier_ratio: Optional[float] = None,
                 reprojection_error: Optional[float] = None,
                 homography: Optional[np.ndarray] = None):
        self.method = method
        self.correspondences = np.asarray(correspondences).reshape(-1, 4)
        self.scores = (np.asarray(scores) if scores is not None
                       else np.ones(len(self.correspondences)))
        self.inlier_ratio = inlier_ratio
        self.reprojection_error = reprojection_error
        self.homography = homography

    @classmethod
    def from_method_result(cls, result) -> "MethodReconstructionData":
        m = result.best_matches
        valid = _host(m.mask)
        p1 = _host(result.features1.xy)[_host(m.idx1)][valid]
        p2 = _host(result.features2.xy)[_host(m.idx2)][valid]
        return cls(result.method,
                   np.concatenate([p1, p2], axis=1),
                   scores=_host(m.quality())[valid],
                   inlier_ratio=result.inlier_ratio,
                   reprojection_error=result.reprojection_error,
                   homography=result.homography)

    @property
    def num_correspondences(self) -> int:
        return len(self.correspondences)

    def export_to_colmap(self, output_dir, image1_id="image1",
                         image2_id="image2") -> None:
        from tpu3drec_torch.io.colmap import export_pair_matches
        n = self.num_correspondences
        export_pair_matches(output_dir, image1_id, image2_id,
                            self.correspondences[:, :2],
                            self.correspondences[:, 2:],
                            np.stack([np.arange(n), np.arange(n)], 1))

    def to_dict(self) -> Dict:
        return {
            "method": self.method,
            "correspondences": self.correspondences.tolist(),
            "scores": self.scores.tolist(),
            "inlier_ratio": self.inlier_ratio,
            "reprojection_error": self.reprojection_error,
            "homography": (self.homography.tolist()
                           if self.homography is not None else None),
        }


class MultiMethodReconstruction:
    """Dict-like multi-method container."""

    def __init__(self, methods: Optional[Dict[str, MethodReconstructionData]] = None,
                 image1_id: str = "image1", image2_id: str = "image2"):
        self.methods = methods or {}
        self.image1_id = image1_id
        self.image2_id = image2_id

    @classmethod
    def from_matching_result(cls, result) -> "MultiMethodReconstruction":
        mm = cls(image1_id=result.image1_name or "image1",
                 image2_id=result.image2_name or "image2")
        for name, r in result.items():
            mm.methods[name] = MethodReconstructionData.from_method_result(r)
        return mm

    def __getitem__(self, method):
        return self.methods[method]

    def __contains__(self, method):
        return method in self.methods

    def keys(self):
        return self.methods.keys()

    def get_best_method(self) -> Optional[str]:
        """Most correspondences weighted by inlier ratio."""
        best, best_score = None, -1.0
        for name, d in self.methods.items():
            score = d.num_correspondences * (d.inlier_ratio or 0.5)
            if score > best_score:
                best, best_score = name, score
        return best

    def export_all(self, base_dir) -> None:
        base = Path(base_dir)
        for name, d in self.methods.items():
            d.export_to_colmap(base / f"colmap_{name}",
                               self.image1_id, self.image2_id)

    def to_dict(self) -> Dict:
        return {
            "image1_id": self.image1_id,
            "image2_id": self.image2_id,
            "methods": {n: d.to_dict() for n, d in self.methods.items()},
            "best_method": self.get_best_method(),
        }


def save_for_reconstruction(result, path) -> Path:
    """Pickle a MatchingResult's reconstruction payload."""
    mm = MultiMethodReconstruction.from_matching_result(result)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(mm.to_dict(), f)
    return path


def load_for_reconstruction(path) -> MultiMethodReconstruction:
    """Read a payload written by `save_for_reconstruction` (unpickle only
    files this project wrote: unpickling can run code)."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    mm = MultiMethodReconstruction(image1_id=data["image1_id"],
                                   image2_id=data["image2_id"])
    for name, d in data["methods"].items():
        mm.methods[name] = MethodReconstructionData(
            method=d["method"],
            correspondences=np.asarray(d["correspondences"]),
            scores=np.asarray(d["scores"]),
            inlier_ratio=d["inlier_ratio"],
            reprojection_error=d["reprojection_error"],
            homography=(np.asarray(d["homography"])
                        if d["homography"] is not None else None))
    return mm


def export_results_csv(results: List, path) -> Path:
    """Batch CSV export of MatchingResults."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image1", "image2", "method", "num_matches",
                    "num_raw_matches", "inlier_ratio", "reprojection_error",
                    "quality_score", "detection_time", "matching_time"])
        for res in results:
            for name, r in res.items():
                w.writerow([res.image1_name, res.image2_name, name,
                            r.num_matches, r.num_raw_matches,
                            r.inlier_ratio, r.reprojection_error,
                            f"{r.get_quality_score():.4f}",
                            f"{r.detection_time:.4f}",
                            f"{r.matching_time:.4f}"])
    return path


class VisualizationData:
    """Unified visualization payload: keypoint arrays per image + per-method
    match index pairs. Built from a MatchingResult via
    ResultConverter.to_visualization."""

    def __init__(self, matching_result, image1=None, image2=None):
        self.result = matching_result
        self.image1 = image1
        self.image2 = image2
        self.methods = list(matching_result.keys())
        self.keypoints1 = {}
        self.keypoints2 = {}
        self.matches = {}
        for m in self.methods:
            r = matching_result[m]
            f1, f2 = r.features1, r.features2
            if f1 is not None:
                self.keypoints1[m] = _host(f1.xy)[_host(f1.mask)]
            if f2 is not None:
                self.keypoints2[m] = _host(f2.xy)[_host(f2.mask)]
            mt = r.best_matches
            if mt is not None:
                m_mask = _host(mt.mask)
                self.matches[m] = np.stack(
                    [_host(mt.idx1)[m_mask], _host(mt.idx2)[m_mask]], axis=1)

    @property
    def num_methods(self) -> int:
        return len(self.methods)

    def plot(self, **kw):
        if self.image1 is None or self.image2 is None:
            raise ValueError("images required for plotting")
        from tpu3drec_torch.viz import plot_method_comparison
        return plot_method_comparison(self.image1, self.image2,
                                      self.result, **kw)


class ResultConverter:
    """Conversion facade."""

    @staticmethod
    def to_visualization(matching_result, image1=None,
                         image2=None) -> VisualizationData:
        return VisualizationData(matching_result, image1, image2)

    @staticmethod
    def to_reconstruction(matching_result) -> MultiMethodReconstruction:
        return MultiMethodReconstruction.from_matching_result(
            matching_result)
