"""Reconstruction quality assessment.

Port of `tpu3drec/sfm/quality.py` (numpy only, copied): reprojection,
coverage, geometric and calibration metrics combined into a weighted
overall score with a quality level, plus a printable report.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def reprojection_errors(recon) -> np.ndarray:
    """(N_obs,) per-observation reprojection error as one batched
    projection over the observation arrays. Behind-camera observations get
    a 1e3 sentinel."""
    ocam, opid, ouv = recon.obs_arrays()
    if len(opid) == 0:
        return np.zeros(0)
    names = recon.camera_names()
    R = np.stack([recon.cameras[n].R for n in names])      # (C,3,3)
    t = np.stack([recon.cameras[n].t for n in names])      # (C,3)
    K = np.stack([recon.cameras[n].K for n in names])
    pts = np.asarray(recon.points)                          # (P,3)
    Xc = np.einsum("nij,nj->ni", R[ocam], pts[opid]) + t[ocam]
    z = Xc[:, 2]
    ok = z > 1e-9
    zs = np.where(ok, z, 1.0)
    proj = np.einsum("nij,nj->ni", K[ocam], Xc / zs[:, None])
    err = np.hypot(proj[:, 0] - ouv[:, 0], proj[:, 1] - ouv[:, 1])
    return np.where(ok, err, 1e3)


def _reprojection_metrics(recon) -> Dict:
    if recon.num_observations == 0:
        return {"mean_reprojection_error": float("inf"),
                "median_reprojection_error": float("inf"),
                "max_reprojection_error": float("inf")}
    errs = reprojection_errors(recon)
    return {
        "mean_reprojection_error": float(errs.mean()),
        "median_reprojection_error": float(np.median(errs)),
        "max_reprojection_error": float(errs.max()),
    }


def _coverage_metrics(recon) -> Dict:
    ocam, opid, _ = recon.obs_arrays()
    track_lens = recon.track_lengths()
    obs_per_cam = np.bincount(ocam, minlength=recon.num_cameras) \
        if len(ocam) else np.zeros(0)
    return {
        "mean_track_length":
            float(track_lens.mean()) if len(track_lens) else 0.0,
        "mean_observations_per_camera":
            float(obs_per_cam.mean()) if len(obs_per_cam) else 0.0,
        "points_per_camera": recon.num_points / max(recon.num_cameras, 1),
    }


def _geometric_metrics(recon) -> Dict:
    """Scene extent and the spread of the camera baselines."""
    pts = recon.points_array()
    if len(pts) == 0:
        return {"scene_extent": 0.0, "baseline_diversity": 0.0,
                "mean_baseline": 0.0}
    extent = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    centers = np.stack([c.center for c in recon.cameras.values()]) \
        if recon.num_cameras else np.zeros((0, 3))
    if len(centers) >= 2:
        d = np.linalg.norm(centers[:, None] - centers[None], axis=2)
        iu = np.triu_indices(len(centers), 1)
        baselines = d[iu]
        mean_b = float(baselines.mean())
        div = float(baselines.std() / max(mean_b, 1e-9))
    else:
        mean_b, div = 0.0, 0.0
    return {"scene_extent": extent, "mean_baseline": mean_b,
            "baseline_diversity": div}


def _calibration_metrics(recon) -> Dict:
    """Focal consistency across cameras."""
    if recon.num_cameras == 0:
        return {"focal_consistency": 0.0}
    ratios = []
    for c in recon.cameras.values():
        f = 0.5 * (c.K[0, 0] + c.K[1, 1])
        dim = max(c.image_size) if max(c.image_size) else 2 * c.K[0, 2]
        ratios.append(f / max(dim, 1))
    ratios = np.asarray(ratios)
    return {"focal_consistency":
            float(1.0 / (1.0 + ratios.std() / max(ratios.mean(), 1e-9)))}


def assess_reconstruction_quality(recon) -> Dict:
    """All metrics and the weighted overall score with its level."""
    rep = _reprojection_metrics(recon)
    cov = _coverage_metrics(recon)
    geo = _geometric_metrics(recon)
    cal = _calibration_metrics(recon)

    # component scores in [0, 1]
    s_rep = max(0.0, 1.0 - rep["mean_reprojection_error"] / 5.0)
    s_cov = min(cov["mean_track_length"] / 4.0, 1.0) * 0.5 \
        + min(cov["points_per_camera"] / 500.0, 1.0) * 0.5
    s_geo = min(geo["baseline_diversity"], 1.0) * 0.5 \
        + (0.5 if geo["scene_extent"] > 0 else 0.0)
    s_cal = cal["focal_consistency"]
    overall = 0.40 * s_rep + 0.25 * s_cov + 0.20 * s_geo + 0.15 * s_cal

    if overall >= 0.8:
        level = "excellent"
    elif overall >= 0.6:
        level = "good"
    elif overall >= 0.4:
        level = "fair"
    else:
        level = "poor"

    return {**rep, **cov, **geo, **cal,
            "overall_score": float(overall), "quality_level": level}


def print_quality_report(quality: Dict) -> str:
    lines = ["=" * 60, "RECONSTRUCTION QUALITY REPORT", "=" * 60]
    for k, v in quality.items():
        if isinstance(v, float):
            lines.append(f"  {k:<36} {v:10.4f}")
        else:
            lines.append(f"  {k:<36} {v}")
    lines.append("=" * 60)
    report = "\n".join(lines)
    print(report)
    return report
