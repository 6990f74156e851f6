"""Advanced match-quality metrics vs ground truth.

A copy of `tpu3drec/bench/metrics.py` (numpy; scipy imported lazily).
Rebuild of AdvancedQualityMetrics (reference benchmarking.py:296-489):
homography inlier stats, reprojection error statistics, GT-homography
Frobenius + corner error (:357-395), spatial distribution / convex-hull
coverage (:397-423), pairwise-distance consistency (:425-458), and the
weighted overall quality score (:460-489).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _project(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    ph = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ H.T
    return ph[:, :2] / np.maximum(np.abs(ph[:, 2:3]), 1e-12) * np.sign(
        np.where(ph[:, 2:3] == 0, 1.0, ph[:, 2:3]))


class AdvancedQualityMetrics:
    """benchmarking.py:296-489."""

    @staticmethod
    def reprojection_stats(p1: np.ndarray, p2: np.ndarray,
                           H: np.ndarray, inlier_px: float = 3.0) -> Dict:
        if len(p1) == 0:
            return {"mean_error": float("inf"), "median_error": float("inf"),
                    "inlier_ratio": 0.0, "num_matches": 0}
        err = np.linalg.norm(_project(H, p1) - p2, axis=1)
        return {
            "mean_error": float(err.mean()),
            "median_error": float(np.median(err)),
            "max_error": float(err.max()),
            "inlier_ratio": float((err < inlier_px).mean()),
            "num_matches": int(len(p1)),
        }

    @staticmethod
    def homography_vs_gt(H_est: Optional[np.ndarray], H_gt: np.ndarray,
                         image_shape) -> Dict:
        """Frobenius + corner reprojection error vs GT (:357-395)."""
        if H_est is None:
            return {"frobenius_error": float("inf"),
                    "corner_error": float("inf")}
        h, w = image_shape[:2]
        Ha = np.asarray(H_est, np.float64)
        Hb = np.asarray(H_gt, np.float64)
        Ha /= Ha[2, 2]
        Hb /= Hb[2, 2]
        frob = float(np.linalg.norm(Ha - Hb) / max(np.linalg.norm(Hb), 1e-12))
        corners = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                           np.float64)
        ce = float(np.linalg.norm(_project(Ha, corners)
                                  - _project(Hb, corners), axis=1).mean())
        return {"frobenius_error": frob, "corner_error": ce}

    @staticmethod
    def spatial_distribution(pts: np.ndarray, image_shape) -> Dict:
        """Grid occupancy + convex-hull coverage (:397-423)."""
        h, w = image_shape[:2]
        if len(pts) < 3:
            return {"grid_coverage": 0.0, "hull_coverage": 0.0}
        gx = np.clip((pts[:, 0] / w * 8).astype(int), 0, 7)
        gy = np.clip((pts[:, 1] / h * 8).astype(int), 0, 7)
        grid = len(set(zip(gx.tolist(), gy.tolist()))) / 64.0
        try:
            from scipy.spatial import ConvexHull
            hull = ConvexHull(pts)
            hull_cov = float(hull.volume / (h * w))
        except Exception:
            hull_cov = 0.0
        return {"grid_coverage": grid, "hull_coverage": hull_cov}

    @staticmethod
    def distance_consistency(p1: np.ndarray, p2: np.ndarray,
                             n_pairs: int = 500, seed: int = 0) -> Dict:
        """Pairwise-distance-ratio consistency (:425-458)."""
        if len(p1) < 4:
            return {"distance_consistency": 0.0}
        rng = np.random.default_rng(seed)
        i = rng.integers(0, len(p1), n_pairs)
        j = rng.integers(0, len(p1), n_pairs)
        ok = i != j
        d1 = np.linalg.norm(p1[i[ok]] - p1[j[ok]], axis=1)
        d2 = np.linalg.norm(p2[i[ok]] - p2[j[ok]], axis=1)
        ratios = d2 / np.maximum(d1, 1e-9)
        med = np.median(ratios)
        consistency = float(np.mean(np.abs(ratios - med)
                                    < 0.2 * max(med, 1e-9)))
        return {"distance_consistency": consistency}

    @classmethod
    def comprehensive_quality_assessment(cls, p1: np.ndarray, p2: np.ndarray,
                                         H_est: Optional[np.ndarray],
                                         H_gt: Optional[np.ndarray],
                                         image_shape) -> Dict:
        """Weighted overall quality (:460-489): reprojection .35,
        inlier ratio .25, spatial .20, consistency .20."""
        out: Dict = {}
        if H_gt is not None:
            rep = cls.reprojection_stats(p1, p2, H_gt)
            out.update(rep)
            if H_est is not None:
                out.update(cls.homography_vs_gt(H_est, H_gt, image_shape))
        elif H_est is not None:
            rep = cls.reprojection_stats(p1, p2, H_est)
            out.update(rep)
        else:
            rep = {"mean_error": float("inf"), "inlier_ratio": 0.0}
            out.update(rep)
        out.update(cls.spatial_distribution(p1, image_shape))
        out.update(cls.distance_consistency(p1, p2))

        s_rep = max(0.0, 1.0 - rep.get("mean_error", np.inf) / 10.0)
        s_inl = rep.get("inlier_ratio", 0.0)
        s_spa = out["grid_coverage"]
        s_con = out["distance_consistency"]
        out["overall_quality"] = float(0.35 * s_rep + 0.25 * s_inl
                                       + 0.20 * s_spa + 0.20 * s_con)
        return out
