"""Iterative two-view refinement: alternating essential-matrix estimation,
triangulation and bounded intrinsics refinement on a relaxing threshold.

Port of `tpu3drec/sfm/refinement.py`: up to `max_iters` rounds of
(E-RANSAC at a threshold relaxing from `threshold_start_px` to
`threshold_end_px` -> pose recovery -> filtered triangulation -> a joint
two-camera bundle step with free intrinsics, the focal length clamped to
[focal_min, focal_max] and the principal point to within `pp_range` of the
image centre), stopping on a small relative change of the quality score;
the best round is returned with the history of all of them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu3drec_torch.core.device import resolve_device
from tpu3drec_torch.ops.ba import (
    BAConfig, BAProblem, bundle_adjust, make_cam_params, unpack_cam_params,
)
from tpu3drec_torch.ops.epipolar import find_essential, recover_pose
from tpu3drec_torch.ops.lie import exp_so3, log_so3
from tpu3drec_torch.ops.triangulate import (
    TriangulationConfig, triangulate_two_view,
)


@dataclasses.dataclass
class RefinementConfig:
    max_iters: int = 6
    threshold_start_px: float = 3.0     # relaxation schedule start
    threshold_end_px: float = 1.0
    focal_min: float = 100.0
    focal_max: float = 5000.0
    pp_range: float = 0.3               # principal point within 30% of centre
    convergence_rtol: float = 0.01
    ba_iters: int = 10


@dataclasses.dataclass
class RefinementResult:
    K1: np.ndarray
    K2: np.ndarray
    R: np.ndarray
    t: np.ndarray
    points: np.ndarray
    point_mask: np.ndarray
    inliers: np.ndarray
    quality: float
    history: List[Dict]


def _clamp_K(K: np.ndarray, size: Tuple[int, int],
             cfg: RefinementConfig) -> np.ndarray:
    """Bounded intrinsics: the focal and principal-point boxes."""
    w, h = size
    K = K.copy()
    K[0, 0] = np.clip(K[0, 0], cfg.focal_min, cfg.focal_max)
    K[1, 1] = np.clip(K[1, 1], cfg.focal_min, cfg.focal_max)
    K[0, 2] = np.clip(K[0, 2], w / 2 * (1 - cfg.pp_range),
                      w / 2 * (1 + cfg.pp_range))
    K[1, 2] = np.clip(K[1, 2], h / 2 * (1 - cfg.pp_range),
                      h / 2 * (1 + cfg.pp_range))
    return K


def iterative_refinement(pts1: np.ndarray, pts2: np.ndarray,
                         K1: np.ndarray, K2: np.ndarray,
                         size1: Tuple[int, int], size2: Tuple[int, int],
                         config: Optional[RefinementConfig] = None,
                         device=None,
                         generator: Optional[torch.Generator] = None
                         ) -> Optional[RefinementResult]:
    """Relaxed iterative refinement of one pair from host arrays: pts (N, 2)
    pixels, K (3, 3), sizes (w, h). Runs on `device` (None means CUDA);
    the RANSAC draws come from `generator` (seed 0 when None). Returns
    None when no round produced a model."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cfg = config or RefinementConfig()
    K1, K2 = np.asarray(K1, np.float64), np.asarray(K2, np.float64)
    n = len(pts1)
    p1 = torch.as_tensor(np.asarray(pts1, np.float32), device=dev)
    p2 = torch.as_tensor(np.asarray(pts2, np.float32), device=dev)
    eye = torch.eye(3, device=dev)
    zero3 = torch.zeros(3, device=dev)
    pm = np.ones((2, 10), np.float32)
    pm[0, :6] = 0.0          # camera 1's pose fixed (gauge)
    pm[1, 3] = 0.0           # and the scale
    obs_cam = torch.repeat_interleave(torch.arange(2, device=dev), n)
    obs_pt = torch.arange(n, device=dev).repeat(2)
    obs_uv = torch.cat([p1, p2])
    param_mask = torch.as_tensor(pm, device=dev)

    best: Optional[RefinementResult] = None
    history: List[Dict] = []
    prev_quality = -np.inf
    for it in range(cfg.max_iters):
        frac = it / max(cfg.max_iters - 1, 1)
        thr = cfg.threshold_start_px * (1 - frac) + cfg.threshold_end_px * frac
        K1t = torch.as_tensor(K1.astype(np.float32), device=dev)
        K2t = torch.as_tensor(K2.astype(np.float32), device=dev)

        eres = find_essential(p1, p2, K1t, K2t, threshold_px=float(thr),
                              generator=generator)
        if not bool(eres.success):
            history.append({"iter": it, "status": "essential_failed"})
            continue
        R, t, _ = recover_pose(eres.E, p1, p2, K1t, K2t, mask=eres.inliers)
        tri = triangulate_two_view(
            p1, p2, K1t, K2t, eye, zero3, R, t, mask=eres.inliers,
            config=TriangulationConfig(max_reproj_px=float(thr) * 2))
        n_pts = int(tri.mask.sum())
        if n_pts < 16:
            history.append({"iter": it, "status": "too_few_points",
                            "points": n_pts})
            continue

        # joint bounded refinement: 2 cameras, free intrinsics, free points
        cams = np.stack([
            make_cam_params(np.zeros(3), np.zeros(3), K1),
            make_cam_params(log_so3(R).cpu().numpy(), t.cpu().numpy(), K2)])
        prob = BAProblem(
            cam_params=torch.as_tensor(cams, device=dev), points=tri.points,
            obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=obs_uv,
            obs_mask=tri.mask.repeat(2), param_mask=param_mask,
            point_mask=tri.mask)
        res = bundle_adjust(prob, BAConfig(max_iters=cfg.ba_iters,
                                           optimize_intrinsics=True))
        _, _, K1j = unpack_cam_params(res.cam_params[0])
        rv, tv, K2j = unpack_cam_params(res.cam_params[1])
        K1 = _clamp_K(K1j.cpu().numpy().astype(np.float64), size1, cfg)
        K2 = _clamp_K(K2j.cpu().numpy().astype(np.float64), size2, cfg)

        reproj = float(res.mean_reproj_px)
        quality = n_pts / max(n, 1) - 0.2 * reproj
        history.append({"iter": it, "threshold_px": thr,
                        "inliers": int(eres.num_inliers),
                        "points": n_pts, "mean_reproj_px": reproj,
                        "quality": quality,
                        "focal1": float(K1[0, 0]), "focal2": float(K2[0, 0])})
        if best is None or quality > best.quality:
            best = RefinementResult(
                K1=K1, K2=K2,
                R=exp_so3(rv).cpu().numpy().astype(np.float64),
                t=tv.cpu().numpy().astype(np.float64),
                points=res.points.cpu().numpy(),
                point_mask=tri.mask.cpu().numpy(),
                inliers=eres.inliers.cpu().numpy(),
                quality=quality, history=history)
        if prev_quality > -np.inf and \
                abs(quality - prev_quality) < cfg.convergence_rtol * abs(prev_quality):
            break
        prev_quality = quality

    if best is not None:
        best.history = history
    return best
