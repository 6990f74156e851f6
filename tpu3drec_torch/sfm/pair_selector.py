"""Initialization pair selection and next-view ordering.

Port of `tpu3drec/sfm/pair_selector.py`. Every candidate pair gets a
weighted score: match count .25, spatial distribution .20, geometric
consistency (the inlier ratio of a fundamental-matrix RANSAC) .25,
baseline adequacy .15, match confidence .15. The RANSACs of all pairs run
as batched `find_fundamental` calls over chunks of pairs. Each pair draws
its uniforms from its own CPU `torch.Generator` seeded with its index in
the sorted pair list (the reference's seed), and the draws move to the
device afterwards, so a pair's result depends neither on its chunk nor
on the device.

Works directly on the inter-stage matches_data dict
({(img1, img2): {correspondences Nx4, ...}}).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu3drec_torch.core.device import resolve_device
from tpu3drec_torch.ops.geometry import find_fundamental
from tpu3drec_torch.ops.ransac import draw_uniform

F_HYPOTHESES = 256   # the reference's fundamental RANSAC size
F_CHUNK = 8          # pairs per batched call


@dataclasses.dataclass
class ScoringConfig:
    w_matches: float = 0.25
    w_distribution: float = 0.20
    w_geometric: float = 0.25
    w_baseline: float = 0.15
    w_confidence: float = 0.15
    target_matches: int = 200
    min_matches: int = 30
    ransac_threshold: float = 2.0


def _spatial_distribution_score(pts: np.ndarray,
                                image_size: Tuple[int, int]) -> float:
    """Coverage of the image by matched points, via an 8x8 occupancy
    grid."""
    if len(pts) == 0:
        return 0.0
    w = max(image_size[0], pts[:, 0].max() + 1)
    h = max(image_size[1], pts[:, 1].max() + 1)
    gx = np.clip((pts[:, 0] / w * 8).astype(int), 0, 7)
    gy = np.clip((pts[:, 1] / h * 8).astype(int), 0, 7)
    occupied = len(set(zip(gx.tolist(), gy.tolist())))
    return occupied / 64.0


def _baseline_score(inlier_ratio: float, median_disp: float,
                    diag: float) -> float:
    """Baseline adequacy: enough displacement for parallax but not so much
    that overlap collapses."""
    rel = median_disp / max(diag, 1.0)
    if rel < 0.01:
        return rel / 0.01 * 0.3           # near-degenerate baseline
    if rel < 0.15:
        return 0.3 + 0.7 * (rel - 0.01) / 0.14
    if rel < 0.4:
        return 1.0
    return max(0.0, 1.0 - (rel - 0.4))


def normalize_match_scores(raw_scores, score_type: str,
                           method: str = "") -> float:
    """Score-type-aware match-confidence normalisation: distances invert
    against a per-method ceiling (SIFT-family 512, Hamming by descriptor
    bit width), confidences pass through, similarities shift from
    [-1, 1]. Returns the mean quality in [0, 1] (0.5 when no scores)."""
    if raw_scores is None or len(raw_scores) == 0:
        return 0.5
    s = np.asarray(raw_scores, np.float64)
    m = (method or "").lower()
    if score_type == "distance":
        if "sift" in m:
            ceil = 512.0          # SIFT descriptors renormalised to 512
        elif "orb" in m or "brisk" in m:
            ceil = 256.0          # 256-bit Hamming
        elif "akaze" in m:
            ceil = 488.0          # M-LDB bits
        else:
            ceil = float(np.percentile(s, 95)) + 1e-6
        norm = 1.0 - np.clip(s / ceil, 0.0, 1.0)
    elif score_type == "confidence":
        norm = np.clip(s, 0.0, 1.0)
    elif score_type == "similarity":
        norm = (np.clip(s, -1.0, 1.0) + 1.0) / 2.0 if s.min() < 0 \
            else np.clip(s, 0.0, 1.0)
    else:
        return 0.5
    return float(norm.mean())


def validate_correspondences(pts1: np.ndarray, pts2: np.ndarray,
                             image_size: Tuple[int, int],
                             min_points: int = 30) -> Dict:
    """Correspondence-validation gate for two-view estimation: point
    count, spatial coverage (std-area fraction per image) and baseline
    displacement, combined into a quality level. `valid` goes False only
    on structural problems (length mismatch, too few points); coverage and
    baseline issues surface as warnings and a lower quality level."""
    out = {"valid": True, "quality_level": "unknown", "warnings": [],
           "errors": [], "statistics": {}}
    pts1 = np.asarray(pts1, np.float64).reshape(-1, 2)
    pts2 = np.asarray(pts2, np.float64).reshape(-1, 2)
    if len(pts1) != len(pts2):
        out["errors"].append("mismatched point array lengths")
        out["valid"] = False
        return out
    w, h = image_size
    n = len(pts1)
    if n < min_points:
        out["errors"].append(f"insufficient points: {n} < {min_points}")
        out["valid"] = False

    cov1 = cov2 = 0.0
    disp_mean = 0.0
    if n >= 2:
        s1 = pts1.std(axis=0)
        s2 = pts2.std(axis=0)
        cov1 = float(s1[0] * s1[1] / max(w * h, 1))
        cov2 = float(s2[0] * s2[1] / max(w * h, 1))
        if cov1 < 0.02:
            out["warnings"].append(
                f"limited coverage in first image ({cov1:.1%})")
        if cov2 < 0.02:
            out["warnings"].append(
                f"limited coverage in second image ({cov2:.1%})")
        disp = np.linalg.norm(pts2 - pts1, axis=1)
        disp_mean = float(disp.mean())
        if disp_mean < 8.0:
            out["warnings"].append(
                f"small baseline ({disp_mean:.1f}px)")
        if disp_mean > min(w, h) * 0.4:
            out["warnings"].append(
                f"large baseline ({disp_mean:.1f}px)")

    factors = []
    if n >= min_points * 1.5:
        factors.append("sufficient_points")
    if cov1 > 0.05 and cov2 > 0.05:
        factors.append("good_coverage")
    if 10.0 <= disp_mean <= min(w, h) * 0.25:
        factors.append("adequate_baseline")
    q = len(factors) / 3.0
    out["quality_level"] = ("excellent" if q >= 0.8 else
                            "good" if q >= 0.6 else
                            "fair" if q >= 0.4 else "poor")
    out["statistics"] = {
        "num_correspondences": n,
        "coverage_ratio_1": cov1, "coverage_ratio_2": cov2,
        "mean_displacement": disp_mean,
        "quality_score": q, "quality_factors": factors,
    }
    return out


def _pair_cap(n: int) -> int:
    """The reference's capacity bucket: 512, 2048, 8192, ... The port pads
    the pairs of a batched F-RANSAC to it (chunk mates of similar size pad
    little), and the SfM pipeline orders its leftover triangulation by it
    as the reference does."""
    cap = 512
    while cap < n:
        cap *= 4
    return cap


def _fundamental_batch(corrs: List[np.ndarray], seeds: List[int], cap: int,
                       threshold: float, device: torch.device
                       ) -> List[Tuple[float, np.ndarray]]:
    """One batched F-RANSAC over pairs padded to `cap`; each pair's
    uniforms come from a CPU generator seeded with its seed. Returns
    (inlier ratio or 0 on failure, inliers[:n]) per pair, from one host
    pull."""
    B = len(corrs)
    P1 = np.zeros((B, cap, 2), np.float32)
    P2 = np.zeros((B, cap, 2), np.float32)
    M = np.zeros((B, cap), bool)
    for g, c in enumerate(corrs):
        c = np.asarray(c, np.float32)
        P1[g, :len(c)], P2[g, :len(c)] = c[:, :2], c[:, 2:]
        M[g, :len(c)] = True
    u = torch.stack([draw_uniform(F_HYPOTHESES, 8,
                                  torch.Generator().manual_seed(int(s)))
                     for s in seeds]).to(device)
    rr = find_fundamental(torch.as_tensor(P1, device=device),
                          torch.as_tensor(P2, device=device),
                          mask=torch.as_tensor(M, device=device),
                          threshold=threshold,
                          num_hypotheses=F_HYPOTHESES, u=u)
    flat = torch.cat([rr.inlier_ratio.float()[:, None],
                      rr.success.float()[:, None],
                      rr.inliers.float()], 1).cpu().numpy()
    return [(float(flat[g, 0]) if flat[g, 1] > 0.5 else 0.0,
             flat[g, 2:2 + len(c)] > 0.5) for g, c in enumerate(corrs)]


def score_pair(correspondences: np.ndarray,
               image_size: Tuple[int, int] = (640, 480),
               config: ScoringConfig = ScoringConfig(),
               confidence: Optional[float] = None,
               key_seed: int = 0,
               precomputed_geom: Optional[Tuple[float, np.ndarray]] = None,
               device=None) -> Dict:
    """Score one pair's Nx4 correspondences; returns component scores.

    precomputed_geom: (inlier_ratio, inlier_mask[:n]) from a batched
    F-RANSAC (score_all_pairs); otherwise one F-RANSAC runs on `device`
    (None means CUDA) with uniforms seeded by `key_seed`."""
    n = len(correspondences)
    if n < config.min_matches:
        return {"total": 0.0, "num_matches": n, "inlier_ratio": 0.0,
                "reason": "too few matches"}
    corr = np.asarray(correspondences, np.float32)
    p1, p2 = corr[:, :2], corr[:, 2:]

    if precomputed_geom is not None:
        inlier_ratio, inl = precomputed_geom
    else:
        inlier_ratio, inl = _fundamental_batch(
            [corr], [key_seed], _pair_cap(n), config.ransac_threshold,
            resolve_device(device))[0]

    s_matches = min(n / config.target_matches, 1.0)
    s_dist = 0.5 * (_spatial_distribution_score(p1, image_size)
                    + _spatial_distribution_score(p2, image_size))
    s_geom = inlier_ratio
    disp = np.linalg.norm(p2 - p1, axis=1)
    med_disp = float(np.median(disp[inl])) if inl.any() else float(np.median(disp))
    diag = float(np.hypot(*image_size))
    s_base = _baseline_score(inlier_ratio, med_disp, diag)
    s_conf = confidence if confidence is not None else inlier_ratio

    total = (config.w_matches * s_matches + config.w_distribution * s_dist
             + config.w_geometric * s_geom + config.w_baseline * s_base
             + config.w_confidence * s_conf)
    return {"total": float(total), "num_matches": n,
            "inlier_ratio": inlier_ratio, "matches_score": s_matches,
            "distribution_score": s_dist, "baseline_score": s_base,
            "median_displacement": med_disp}


class InitializationPairSelector:
    """Scores every pair for the two-view initialisation and ranks the
    next views. The F-RANSACs run on `device` (None means CUDA), resolved
    when pairs are first scored."""

    def __init__(self, config: ScoringConfig = ScoringConfig(), device=None):
        self.config = config
        self.device = device
        self.scores: Dict[Tuple[str, str], Dict] = {}

    def score_all_pairs(self, matches_data: Dict,
                        image_info: Optional[Dict] = None) -> Dict:
        """All pairs' F-RANSACs as batched calls of F_CHUNK pairs, grouped
        by padded length."""
        dev = resolve_device(self.device)
        entries = []
        for i, (pair, pd) in enumerate(sorted(matches_data.items())):
            if "error" in pd:
                continue
            corr = np.asarray(pd.get("correspondences", []))
            size = (640, 480)
            if image_info and pair[0] in image_info:
                info = image_info[pair[0]]
                size = (info.get("width", 640), info.get("height", 480))
            # confidence: score-type-aware normalisation of the raw
            # per-match scores when the matching stage shipped them;
            # quality_score otherwise
            ms = pd.get("match_scores")
            if ms is not None and len(ms) and pd.get("score_type"):
                conf = normalize_match_scores(
                    ms, pd["score_type"], pd.get("method", ""))
            else:
                conf = pd.get("quality_score")
            entries.append((i, pair, corr, size, conf))

        geom: Dict = {}
        by_cap: Dict[int, list] = {}
        for e in entries:
            if len(e[2]) >= self.config.min_matches:
                by_cap.setdefault(_pair_cap(len(e[2])), []).append(e)
        for cap, group in sorted(by_cap.items()):
            for s in range(0, len(group), F_CHUNK):
                part = group[s:s + F_CHUNK]
                out = _fundamental_batch([e[2] for e in part],
                                         [e[0] for e in part], cap,
                                         self.config.ransac_threshold, dev)
                for e, g in zip(part, out):
                    geom[e[1]] = g

        for i, pair, corr, size, conf in entries:
            self.scores[pair] = score_pair(
                corr, size, self.config, confidence=conf, key_seed=i,
                precomputed_geom=geom.get(pair))
        return self.scores

    def get_best_pair(self, matches_data: Dict,
                      image_info: Optional[Dict] = None
                      ) -> Optional[Tuple[Tuple[str, str], Dict]]:
        if not self.scores:
            self.score_all_pairs(matches_data, image_info)
        ranked = sorted(self.scores.items(), key=lambda kv: -kv[1]["total"])
        if not ranked or ranked[0][1]["total"] <= 0:
            return None
        return ranked[0]

    def rank_next_views(self, remaining: List[str],
                        processed: List[str],
                        matches_data: Dict,
                        recon=None) -> List[Tuple[str, float]]:
        """Next-camera ordering.

        With `recon` (the growing Reconstruction): candidates are scored
        by 2D-3D visibility against the existing cloud: 0.5 x
        correspondence potential (min(matches, the registered camera's
        observation count), the matches that can become PnP constraints)
        + 0.3 x match quality + 0.2 x geometric spread. Without `recon`:
        match-count connectivity only."""
        proc = set(processed)
        if recon is None:
            out = []
            for img in remaining:
                total = 0.0
                links = 0
                for pair, pd in matches_data.items():
                    if "error" in pd:
                        continue
                    if img in pair and (set(pair) - {img}) & proc:
                        n = pd.get("num_matches", 0)
                        total += min(n / self.config.target_matches, 1.0)
                        links += 1
                out.append((img, total * (1 + 0.1 * links)))
            return sorted(out, key=lambda kv: -kv[1])

        obs_count = {c: len(recon.camera_obs_arrays(c)[0])
                     for c in proc if c in recon.cameras}
        out = []
        for img in remaining:
            potential = 0.0
            quality, spread, links = [], [], 0
            for pair, pd in matches_data.items():
                if "error" in pd or img not in pair:
                    continue
                other = pair[0] if pair[1] == img else pair[1]
                if other not in obs_count:
                    continue
                n = pd.get("num_matches",
                           len(pd.get("correspondences", [])))
                links += 1
                # matches that can become 2D-3D constraints are bounded
                # by the registered camera's triangulated observations
                potential += min(n, obs_count[other]) * 0.3
                ms = pd.get("match_scores")
                if ms is not None and len(ms) and pd.get("score_type"):
                    quality.append(normalize_match_scores(
                        ms, pd["score_type"], pd.get("method", "")))
                else:
                    quality.append(pd.get("quality_score", 0.7) or 0.7)
                corr = np.asarray(pd.get("correspondences", []))
                if len(corr) >= 4:
                    cand_xy = corr[:, :2] if pair[0] == img else corr[:, 2:]
                    sd = cand_xy.std(axis=0)
                    spread.append(min(1.0, float(sd[0] + sd[1]) / 400.0))
                else:
                    spread.append(0.3)
            if links == 0:
                out.append((img, 0.0))
                continue
            s_pot = min(1.0, potential / 50.0)
            s_q = float(np.mean(quality)) if quality else 0.5
            s_g = float(np.mean(spread)) if spread else 0.0
            out.append((img, 0.5 * s_pot + 0.3 * s_q + 0.2 * s_g))
        return sorted(out, key=lambda kv: -kv[1])
