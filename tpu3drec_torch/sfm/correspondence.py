"""Correspondence management: 2D-3D mining, pre-triangulation, image
selection, failure diagnostics.

Port of `tpu3drec/sfm/correspondence.py`: a pair lookup tolerant to key
order, the nearest-neighbour mining distance shared with the SfM
pipeline, `CorrespondenceFinder` (2D-3D mining with a tolerance ladder),
`PreTriangulator` (two-view triangulation against every registered
camera, on the port's `triangulate_two_view`), `ImageSelector`,
`diagnose_failure` and the `CorrespondenceManager` facade.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu3drec_torch.core.device import resolve_device


@dataclasses.dataclass
class CorrespondenceConfig:
    base_tolerance_px: float = 2.0
    tolerance_ladder: Tuple[float, ...] = (2.0, 4.0, 8.0)
    min_correspondences: int = 15
    min_matches_for_pair: int = 8


def lookup_pair(matches_data: Dict, a: str, b: str) -> Optional[np.ndarray]:
    """Key-order-tolerant pair lookup. Returns Nx4 float64 with columns
    ordered (a_xy, b_xy), or None."""
    if (a, b) in matches_data:
        pd = matches_data[(a, b)]
        corr = np.asarray(pd.get("correspondences", []), np.float64)
        return corr if len(corr) else None
    if (b, a) in matches_data:
        pd = matches_data[(b, a)]
        corr = np.asarray(pd.get("correspondences", []), np.float64)
        if len(corr) == 0:
            return None
        return np.concatenate([corr[:, 2:], corr[:, :2]], axis=1)
    return None


def min_dists(q: np.ndarray, ref: np.ndarray,
              chunk: int = 1024):
    """Per-query nearest neighbour in a 2-D reference set: the mining
    distance shared by the pipeline (2D-3D mining, progressive
    triangulation, track extension) and the facade below. A k-d tree when
    the dense O(N*M) block would be large; chunked dense distances
    otherwise (tree construction dominates small sets)."""
    if len(q) * len(ref) > 1 << 18 and len(ref) >= 32:
        from scipy.spatial import cKDTree
        dist, idx = cKDTree(ref).query(q, k=1)
        return np.asarray(dist, float), np.asarray(idx, int)
    n = len(q)
    dist = np.empty(n)
    idx = np.empty(n, int)
    for s in range(0, n, chunk):
        d = np.linalg.norm(q[s:s + chunk, None, :] - ref[None], axis=2)
        j = d.argmin(axis=1)
        idx[s:s + chunk] = j
        dist[s:s + chunk] = d[np.arange(len(j)), j]
    return dist, idx


class CorrespondenceFinder:
    """2D-3D mining with a tolerance ladder."""

    def __init__(self, config: Optional[CorrespondenceConfig] = None):
        self.config = config or CorrespondenceConfig()

    def find_2d3d(self, recon, new_image: str, matches_data: Dict
                  ) -> Tuple[np.ndarray, np.ndarray, Dict]:
        """Returns (uv (N,2), point_ids (N,), diagnostics). Walks the
        tolerance ladder until min_correspondences are found."""
        diag = {"attempts": []}
        for tol in self.config.tolerance_ladder:
            uv, pids = self._find_at_tolerance(recon, new_image,
                                               matches_data, tol)
            diag["attempts"].append({"tolerance_px": tol, "found": len(uv)})
            if len(uv) >= self.config.min_correspondences:
                diag["tolerance_used"] = tol
                return uv, pids, diag
        diag["tolerance_used"] = None
        return uv, pids, diag

    def _find_at_tolerance(self, recon, new_image, matches_data, tol):
        uv_out, pid_out = [], []
        seen = set()
        for other in recon.cameras:
            corr = lookup_pair(matches_data, new_image, other)
            if corr is None or len(corr) < self.config.min_matches_for_pair:
                continue
            new_xy, other_xy = corr[:, :2], corr[:, 2:]
            obs_pid, obs_uv = recon.camera_obs_arrays(other)
            if len(obs_pid) == 0:
                continue
            dmin, j = min_dists(other_xy, obs_uv)
            hit = dmin <= tol
            hi = np.where(hit)[0]
            cand = obs_pid[j[hi]].astype(int)
            first = np.unique(cand, return_index=True)[1]
            for k in np.sort(first):
                pid = int(cand[k])
                if pid not in seen:
                    seen.add(pid)
                    uv_out.append(new_xy[hi[k]])
                    pid_out.append(pid)
        if not uv_out:
            return np.zeros((0, 2)), np.zeros(0, int)
        return np.stack(uv_out), np.asarray(pid_out, int)


class PreTriangulator:
    """Triangulate a new image's matches against every registered camera
    before PnP."""

    def triangulate_against_all(self, recon, new_image: str,
                                R: np.ndarray, t: np.ndarray,
                                K: np.ndarray, matches_data: Dict,
                                exclude_pids: Optional[set] = None,
                                max_reproj_px: float = 2.0,
                                device=None) -> List[Dict]:
        """One `triangulate_two_view` per registered camera with at least
        8 matches, on `device` (None means CUDA)."""
        from tpu3drec_torch.ops.triangulate import (
            TriangulationConfig, triangulate_two_view,
        )
        dev = resolve_device(device)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        out = []
        for other in recon.cameras:
            if other == new_image:
                continue
            corr = lookup_pair(matches_data, new_image, other)
            if corr is None or len(corr) < 8:
                continue
            cam_o = recon.cameras[other]
            tri = triangulate_two_view(
                f32(corr[:, :2]), f32(corr[:, 2:]), f32(K), f32(cam_o.K),
                f32(R), f32(t), f32(cam_o.R), f32(cam_o.t),
                config=TriangulationConfig(max_reproj_px=max_reproj_px))
            out.append({"other": other,
                        "points": tri.points.cpu().numpy(),
                        "mask": tri.mask.cpu().numpy(),
                        "uv_new": corr[:, :2], "uv_other": corr[:, 2:]})
        return out


class ImageSelector:
    """Next-image scoring through the pair selector's connectivity
    ranking."""

    def __init__(self, config: Optional[CorrespondenceConfig] = None):
        self.config = config or CorrespondenceConfig()

    def rank(self, recon, remaining: Sequence[str],
             matches_data: Dict) -> List[Tuple[str, float]]:
        from tpu3drec_torch.sfm.pair_selector import InitializationPairSelector
        sel = InitializationPairSelector()
        return sel.rank_next_views(list(remaining), list(recon.cameras),
                                   matches_data)


def diagnose_failure(recon, new_image: str, matches_data: Dict,
                     config: Optional[CorrespondenceConfig] = None) -> Dict:
    """Why did a view fail to register?"""
    cfg = config or CorrespondenceConfig()
    pairs_with_processed = []
    total_matches = 0
    for other in recon.cameras:
        corr = lookup_pair(matches_data, new_image, other)
        if corr is not None:
            pairs_with_processed.append((other, len(corr)))
            total_matches += len(corr)
    finder = CorrespondenceFinder(cfg)
    uv, pids, diag = finder.find_2d3d(recon, new_image, matches_data)
    return {
        "image": new_image,
        "connected_processed_views": pairs_with_processed,
        "total_matches_to_processed": total_matches,
        "correspondences_found": len(uv),
        "min_required": cfg.min_correspondences,
        "tolerance_diagnostics": diag,
        "verdict": ("ok" if len(uv) >= cfg.min_correspondences else
                    "insufficient_2d3d" if total_matches > 0 else
                    "no_connectivity"),
    }


class CorrespondenceManager:
    """Facade over the finder, the pre-triangulator and the selector."""

    def __init__(self, config: Optional[CorrespondenceConfig] = None):
        self.config = config or CorrespondenceConfig()
        self.finder = CorrespondenceFinder(self.config)
        self.pre_triangulator = PreTriangulator()
        self.selector = ImageSelector(self.config)

    def find_correspondences(self, recon, new_image, matches_data):
        return self.finder.find_2d3d(recon, new_image, matches_data)

    def select_next_image(self, recon, remaining, matches_data):
        ranked = self.selector.rank(recon, remaining, matches_data)
        return ranked[0][0] if ranked else None

    def diagnose(self, recon, new_image, matches_data):
        return diagnose_failure(recon, new_image, matches_data, self.config)
