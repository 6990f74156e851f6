"""Incremental SfM pipeline: two-view init -> incremental view addition
with PnP -> global bundle adjustment -> export.

Port of `tpu3drec/sfm/pipeline.py`:

  Phase 1: best-pair selection, essential RANSAC, pose recovery, camera 1
    at the origin, filtered two-view triangulation, bundle adjustment,
    relaxed re-triangulation of the rejected inliers; progressive
    triangulation against the unprocessed images, track extension.
  Phase 2: 2D-3D-visibility-ranked next view, 2D-3D mining against the
    cloud (a tolerance ladder), PnP, triangulation of new points against
    the registered neighbours, progressive triangulation, track
    extension, windowed local BA.
  Phase 3: global BA (all cameras, the first fixed), point re-validation.
  Phase 4: pickle + JSON + COLMAP + summary report export.

The geometry runs on the pipeline's device through the port's batched ops
(`ops/epipolar`, `ops/pnp`, `ops/triangulate`, `ops/ba`); the
bookkeeping stays in host numpy, as in the reference. Each device step
ends in one host pull of a packed result: per PnP call, per triangulation
batch, per BA solve. Correspondences go to the device at their real count
(batched calls pad to the longest member and mask the rest); the
reference's capacity buckets, compile prewarm and jit caches exist to
spare XLA recompiles and have no counterpart here.

Every RANSAC draw (uniforms, and the Gumbel subsample above 512
correspondences) comes from a CPU `torch.Generator` seeded as the
reference seeds its keys (0 for the init pair, the camera count for PnP,
crc32 of the image name per progressive pair) and moves to the device
afterwards, so the card and the CPU see the same draws.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pickle
import time
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu3drec_torch.core.device import resolve_device
from tpu3drec_torch.ops.ba import BAConfig, bundle_adjust
from tpu3drec_torch.ops.epipolar import (
    SAMPLE_CAP, find_essential, gumbel_subsample, recover_pose,
)
from tpu3drec_torch.ops.five_point import N_ROOTS
from tpu3drec_torch.ops.pnp import solve_pnp_ransac
from tpu3drec_torch.ops.ransac import draw_uniform
from tpu3drec_torch.ops.triangulate import (
    TriangulationConfig, triangulate_two_view,
)
from tpu3drec_torch.parallel.ba import sharded_bundle_adjust
from tpu3drec_torch.parallel.mesh import make_mesh, world_size
from tpu3drec_torch.sfm.correspondence import lookup_pair
from tpu3drec_torch.sfm.correspondence import min_dists as _min_dists
from tpu3drec_torch.sfm.intrinsics import ProgressiveIntrinsicsEstimator
from tpu3drec_torch.sfm.pair_selector import (
    InitializationPairSelector, ScoringConfig, _pair_cap,
    validate_correspondences,
)
from tpu3drec_torch.sfm.reconstruction import Camera, Reconstruction
from tpu3drec_torch.utils.profiling import span

ESSENTIAL_HYPOTHESES = 1024   # find_essential's default, as the reference
PROGRESSIVE_CHUNK = 4         # (anchor, unprocessed) pairs per batched call


@dataclasses.dataclass
class SfMConfig:
    """The reference's configuration, field for field, without its
    compile-prewarm switch."""
    min_init_inliers: int = 30
    min_init_inlier_ratio: float = 0.4
    essential_threshold_px: float = 1.5
    essential_method: str = "5point"
    min_pnp_correspondences: int = 15
    pnp_threshold_px: float = 4.0
    max_reproj_px: float = 2.0
    relaxed_reproj_px: float = 4.0       # re-triangulation relaxation
    min_angle_deg: float = 2.0
    relaxed_angle_deg: float = 1.0
    # 2D-3D mining: widen the pixel gate until enough correspondences
    # are found
    mine_tolerance_ladder: Tuple[float, ...] = (2.0, 4.0, 8.0)
    incremental_ba_window: int = 3       # the last <= 3 cameras
    # windowed BA solves the reduced local problem (window points and
    # their anchoring observations), so per-view BA stays about constant
    use_local_ba: bool = True
    # the final global BA shards point blocks over the ranks of an
    # initialised process group of more than one rank (one process a card:
    # `torchrun --nproc-per-node N`) when the problem is big enough
    use_sharded_global_ba: bool = True
    sharded_ba_min_obs: int = 20_000
    ba_max_iters: int = 20
    global_ba_max_iters: int = 30
    incremental_ba_ftol: float = 1e-4
    # 0 LM iterations in a per-view BA when the window's initial mean
    # reprojection is already below this (px); 0 disables
    incremental_ba_skip_px: float = 0.5
    # adaptive part of the gate: also skip when the initial mean
    # reprojection is within this many px of the last converged value
    incremental_ba_skip_margin_px: float = 0.08
    # carry the previous incremental solve's final LM damping forward
    warm_start_lambda: bool = True
    optimize_intrinsics: bool = False
    post_ba_max_reproj_px: float = 4.0   # point re-validation
    # joint E + K iterative refinement in two-view init
    use_iterative_refinement: bool = False
    # progressive triangulation with unprocessed images (rough-pose
    # bootstrap) and track extension
    enable_progressive: bool = True
    enable_track_extension: bool = True
    progressive_tolerance_px: float = 4.0
    # an unprocessed image that already holds this many pending 2D-3D
    # links is not re-bootstrapped; 0 re-scans every unprocessed image
    # after every registered view
    progressive_min_pending: int = 30
    track_extension_tolerance_px: float = 2.0
    max_points_per_pair: int = 150
    max_bootstrap_points_per_anchor: int = 200

    @property
    def mine_tolerance_px(self) -> float:
        return self.mine_tolerance_ladder[0]


def _essential_draws(seed: int, n: int, method: str
                     ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """One pair's RANSAC draws for `find_essential` over its n valid
    correspondences, from a CPU generator seeded `seed`: the Gumbel
    subsample ((SAMPLE_CAP,) indices into the valid prefix; the prefix
    itself when n <= SAMPLE_CAP) and the uniforms, in the order
    `find_essential` draws them."""
    gen = torch.Generator().manual_seed(int(seed))
    if n > SAMPLE_CAP:
        sub = gumbel_subsample(torch.ones(1, n, dtype=torch.bool), gen)[0]
    else:
        sub = torch.arange(SAMPLE_CAP)
    if method == "5point":
        u = draw_uniform(max(ESSENTIAL_HYPOTHESES // N_ROOTS, 64), 5, gen)
    else:
        u = draw_uniform(ESSENTIAL_HYPOTHESES, 8, gen)
    return sub, u


def _pad_stack(arrays: List[np.ndarray], n: int, tail: Tuple[int, ...]
               ) -> np.ndarray:
    out = np.zeros((len(arrays), n) + tail, np.float32)
    for g, a in enumerate(arrays):
        out[g, :len(a)] = a
    return out


def _progressive_pair_batch(P1, P2, M, K_a, K_bs, R_a, t_a, subs, us,
                            threshold_px: float, method: str,
                            tri_cfg: TriangulationConfig) -> torch.Tensor:
    """Essential RANSAC -> pose recovery -> two-view triangulation for a
    batch of (anchor, unprocessed) pairs (B, N, 2), padded rows masked.
    Returns (B, N*4 + 2) [points.ravel() | mask | success, n_inliers],
    the reference's packed row, for one host pull."""
    B, N = M.shape
    eres = find_essential(P1, P2, K_a, K_bs, mask=M,
                          threshold_px=threshold_px, method=method,
                          num_hypotheses=ESSENTIAL_HYPOTHESES,
                          sub=subs if N > SAMPLE_CAP else None,
                          u=us)
    K_a = K_a.expand(B, 3, 3)
    R_rel, t_rel, _ = recover_pose(eres.E, P1, P2, K_a, K_bs,
                                   mask=eres.inliers)
    R_a = R_a.expand(B, 3, 3)
    t_a = t_a.expand(B, 3)
    R_b = R_rel @ R_a
    t_b = (R_rel @ t_a[..., None])[..., 0] + t_rel   # unit baseline (s = 1)
    tri = triangulate_two_view(P1, P2, K_a, K_bs, R_a, t_a, R_b, t_b,
                               mask=eres.inliers, config=tri_cfg)
    return torch.cat([tri.points.reshape(B, -1), tri.mask.float(),
                      eres.success.float()[:, None],
                      eres.num_inliers.float()[:, None]], 1)


def _leftover_tri_batch(PN, PO, M, K_new, R_new, t_new, K_os, R_os, t_os,
                        tri_cfg: TriangulationConfig) -> torch.Tensor:
    """Two-view triangulation of a freshly registered camera against a
    batch of its registered neighbours (B, N, 2), padded rows masked.
    Returns (B, N, 4) [points | mask] for one host pull."""
    B = PN.shape[0]
    tri = triangulate_two_view(PN, PO, K_new.expand(B, 3, 3), K_os,
                               R_new.expand(B, 3, 3), t_new.expand(B, 3),
                               R_os, t_os, mask=M, config=tri_cfg)
    return torch.cat([tri.points, tri.mask.float()[..., None]], -1)


def _split_packed(packed: torch.Tensor, C: int, P: int):
    """BAResult.packed (one host pull) -> (cam_params (C,10), points
    (P,3), stats (6,)) numpy arrays."""
    flat = packed.cpu().numpy()
    return (flat[:C * 10].reshape(C, 10),
            flat[C * 10:C * 10 + P * 3].reshape(P, 3),
            flat[C * 10 + P * 3:])


class SfMPipeline:
    """Incremental SfM on `device` (None means CUDA; it raises without a
    card unless the caller passes device="cpu")."""

    def __init__(self, config: Optional[SfMConfig] = None, device=None):
        self.config = config or SfMConfig()
        self.device = resolve_device(device)
        self.selector = InitializationPairSelector(ScoringConfig(),
                                                   device=self.device)
        self.intrinsics = ProgressiveIntrinsicsEstimator()
        self.history: List[Dict] = []
        self._view_timings: Dict[str, float] = {}
        # warm-start LM damping carried across incremental BA solves
        self._ba_lambda: Optional[float] = None
        # last converged mean reprojection of an incremental solve: the
        # adaptive skip threshold's noise-floor estimate
        self._ba_mre_last: Optional[float] = None
        # 2D-3D links pre-established for images that are not cameras
        # yet (track extension and bootstrap): image name -> list of
        # (point_id, uv), consumed by _mine_2d3d when the image registers
        self.pending_obs: Dict[str, List[Tuple[int, np.ndarray]]] = {}

    def _t(self, a, dtype=np.float32) -> torch.Tensor:
        """A host array as a tensor on the pipeline's device, cast to
        float32 at the reference's boundary."""
        return torch.as_tensor(np.asarray(a, dtype), device=self.device)

    @contextlib.contextmanager
    def _phase(self, key: str):
        """Times one per-view phase into the add_view history entry
        (`key`, e.g. "pnp_s") and marks it as the profiler range
        "sfm.<phase>"."""
        t0 = time.perf_counter()
        with span("sfm." + key[:-2]):
            yield
        self._view_timings[key] = time.perf_counter() - t0

    # ------------------------------------------------------------------
    def reconstruct(self, matches_data: Dict, image_info: Optional[Dict] = None,
                    output_dir=None, chosen_images: Optional[List[str]] = None,
                    checkpoint_dir=None, resume: bool = True
                    ) -> Reconstruction:
        """Run the four phases on `matches_data` ({(img1, img2):
        {correspondences Nx4, ...}}).

        checkpoint_dir enables crash-safe checkpointing: the full state is
        saved after two-view init and after every registered view, and
        `resume=True` restarts from it.
        """
        image_info = image_info or {}
        if chosen_images:
            matches_data = {k: v for k, v in matches_data.items()
                            if k[0] in chosen_images and k[1] in chosen_images}

        ckpt_path = None
        if checkpoint_dir is not None:
            Path(checkpoint_dir).mkdir(parents=True, exist_ok=True)
            ckpt_path = Path(checkpoint_dir) / "sfm_checkpoint.pkl"

        self.pending_obs = {}
        recon = Reconstruction()
        resumed = False
        if resume and ckpt_path is not None and ckpt_path.exists():
            try:
                recon = Reconstruction.load_state(ckpt_path)
                resumed = recon.num_cameras >= 2
            except (OSError, EOFError, pickle.UnpicklingError, KeyError,
                    ValueError, TypeError):
                # an unreadable checkpoint restarts from scratch
                recon = Reconstruction()
        if resumed:
            self.history.append({"phase": "resume",
                                 "cameras": recon.num_cameras,
                                 "points": recon.num_points})

        # ---- Phase 1: two-view initialisation --------------------------
        if not resumed:
            t0 = time.perf_counter()
            with span("sfm.init"):
                init = self._initialize_two_view(recon, matches_data,
                                                 image_info)
            if init is None:
                raise RuntimeError(
                    "two-view initialization failed: no usable pair")
            self.history.append({"phase": "init", **init,
                                 "time_s": time.perf_counter() - t0})
            # bootstrap progressive triangulation with the unprocessed
            # images, then a post-bootstrap BA
            if self.config.enable_progressive:
                n_boot = self._progressive_triangulate(
                    recon, list(recon.cameras), matches_data, image_info)
                if n_boot > 50:
                    self._run_ba(recon,
                                 optimize_cams=list(recon.cameras)[1:],
                                 max_iters=self.config.ba_max_iters)
                self.history.append({"phase": "bootstrap",
                                     "points_added": n_boot})
            if self.config.enable_track_extension:
                n_ext = self._extend_tracks(recon, matches_data)
                self.history.append({"phase": "track_extension",
                                     "links_added": n_ext})
            if ckpt_path is not None:
                recon.save_state(ckpt_path)

        # ---- Phase 2: incremental view addition ------------------------
        all_images = {n for pair in matches_data for n in pair}
        remaining = sorted(all_images - set(recon.cameras))
        while remaining:
            t_rank = time.perf_counter()
            ranked = self.selector.rank_next_views(
                remaining, list(recon.cameras), matches_data, recon=recon)
            t_rank = time.perf_counter() - t_rank
            if not ranked or ranked[0][1] <= 0:
                break
            name = ranked[0][0]
            t0 = time.perf_counter()
            self._view_timings = {}
            added = self._add_view(recon, name, matches_data, image_info)
            remaining.remove(name)
            self.history.append({"phase": "add_view", "image": name,
                                 "success": added,
                                 "time_s": time.perf_counter() - t0,
                                 "rank_s": t_rank,
                                 **self._view_timings})
            if added and ckpt_path is not None:
                recon.save_state(ckpt_path)

        # ---- Phase 3: global optimisation ------------------------------
        t0 = time.perf_counter()
        with span("sfm.global_ba"):
            stats = self._global_ba(recon)
            self._validate_points(recon)
        self.history.append({"phase": "global_ba", **stats,
                             "time_s": time.perf_counter() - t0})

        # ---- Phase 4: export -------------------------------------------
        if output_dir is not None:
            self.export(recon, output_dir)
        return recon

    # ------------------------------------------------------------------
    def _image_size(self, name: str, image_info: Dict,
                    corr: Optional[np.ndarray] = None) -> Tuple[int, int]:
        info = image_info.get(name, {})
        w, h = info.get("width", 0), info.get("height", 0)
        if w and h:
            return int(w), int(h)
        if corr is not None and len(corr):
            return (int(corr[:, 0].max()) + 1, int(corr[:, 1].max()) + 1)
        return (640, 480)

    def _initialize_two_view(self, recon: Reconstruction,
                             matches_data: Dict, image_info: Dict
                             ) -> Optional[Dict]:
        best = self.selector.get_best_pair(matches_data, image_info)
        if best is None:
            return None
        # correspondence-validation gate on the candidate init pairs:
        # structurally invalid pairs fall through to the next candidate
        ranked = sorted(self.selector.scores.items(),
                        key=lambda kv: -kv[1]["total"])
        chosen = None
        for (name1, name2), score in ranked[:8]:
            if score["total"] <= 0:
                break
            corr = np.asarray(
                matches_data[(name1, name2)]["correspondences"], np.float32)
            size1 = self._image_size(name1, image_info, corr[:, :2])
            val = validate_correspondences(
                corr[:, :2], corr[:, 2:], size1,
                min_points=self.config.min_init_inliers)
            if val["valid"]:
                chosen = ((name1, name2), score, corr, val)
                break
        if chosen is None:
            return None
        (name1, name2), score, corr, val = chosen
        self.history.append({"phase": "init_validation",
                             "pair": (name1, name2),
                             "quality_level": val["quality_level"],
                             "warnings": val["warnings"]})
        size1 = self._image_size(name1, image_info, corr[:, :2])
        size2 = self._image_size(name2, image_info, corr[:, 2:])
        K1 = self.intrinsics.estimate(*size1)
        K2 = self.intrinsics.estimate(*size2)

        if self.config.use_iterative_refinement:
            # refine K1/K2 jointly with the two-view geometry first; the
            # heuristic Ks stay on failure
            from tpu3drec_torch.sfm.refinement import (
                RefinementConfig, iterative_refinement,
            )
            ref = iterative_refinement(corr[:, :2], corr[:, 2:], K1, K2,
                                       size1, size2, RefinementConfig(),
                                       device=self.device,
                                       generator=torch.Generator().manual_seed(0))
            if ref is not None:
                K1, K2 = ref.K1, ref.K2

        n = len(corr)
        p1, p2 = self._t(corr[:, :2]), self._t(corr[:, 2:])
        K1t, K2t = self._t(K1), self._t(K2)
        sub, u = _essential_draws(0, n, self.config.essential_method)
        eres = find_essential(p1, p2, K1t, K2t,
                              threshold_px=self.config.essential_threshold_px,
                              method=self.config.essential_method,
                              num_hypotheses=ESSENTIAL_HYPOTHESES,
                              sub=sub if n > SAMPLE_CAP else None,
                              u=u.to(self.device))
        head = torch.stack([eres.success.float(), eres.num_inliers.float(),
                            eres.inlier_ratio.float()]).cpu().numpy()
        num_inl = int(head[1])
        if (head[0] < 0.5 or num_inl < self.config.min_init_inliers
                or float(head[2]) < self.config.min_init_inlier_ratio):
            return None
        R, t, _ = recover_pose(eres.E, p1, p2, K1t, K2t, mask=eres.inliers)

        tri_cfg = TriangulationConfig(
            min_angle_deg=self.config.min_angle_deg,
            max_reproj_px=self.config.max_reproj_px)
        eye = torch.eye(3, device=self.device)
        zero = torch.zeros(3, device=self.device)
        tri = triangulate_two_view(p1, p2, K1t, K2t, eye, zero, R, t,
                                   mask=eres.inliers, config=tri_cfg)
        flat = torch.cat([R.reshape(-1), t, tri.points.reshape(-1),
                          tri.mask.float(), tri.depths1,
                          eres.inliers.float()]).cpu().numpy()
        Rn = flat[:9].reshape(3, 3).astype(np.float64)
        tn = flat[9:12].astype(np.float64)
        pts = flat[12:12 + 3 * n].reshape(n, 3)
        ok = flat[12 + 3 * n:12 + 4 * n] > 0.5
        depths1 = flat[12 + 4 * n:12 + 5 * n]
        inliers = flat[12 + 5 * n:] > 0.5

        recon.add_camera(Camera(name1, np.eye(3), np.zeros(3), K1, size1))
        recon.add_camera(Camera(name2, Rn, tn, K2, size2))
        p1n, p2n = corr[:, :2], corr[:, 2:]
        sel = np.where(ok)[0]
        ids = recon.add_points_batch(pts[sel])
        recon.add_observations_batch(name1, ids, p1n[sel])
        recon.add_observations_batch(name2, ids, p2n[sel])
        n_first = len(sel)

        # BA over the two views: camera 1 fixed
        self._run_ba(recon, optimize_cams=[name2],
                     max_iters=self.config.ba_max_iters)

        # relaxed re-triangulation of the rejected inliers: wider
        # reprojection and angle gates, depth bounds adapted to the
        # accepted cloud
        rej = inliers & ~ok
        n_rescued = 0
        if rej.any() and n_first > 0:
            lo, hi = np.percentile(depths1[ok], [2, 98])
            relaxed = TriangulationConfig(
                min_angle_deg=self.config.relaxed_angle_deg,
                max_reproj_px=self.config.relaxed_reproj_px)
            cam1, cam2 = recon.cameras[name1], recon.cameras[name2]
            tri2 = triangulate_two_view(
                p1, p2, self._t(cam1.K), self._t(cam2.K), eye, zero,
                self._t(cam2.R), self._t(cam2.t),
                mask=torch.as_tensor(rej, device=self.device), config=relaxed,
                depth_bounds=(np.float32(max(lo * 0.5, 1e-3)),
                              np.float32(hi * 2.0)))
            flat2 = torch.cat([tri2.points.reshape(-1),
                               tri2.mask.float()]).cpu().numpy()
            sel2 = np.where(flat2[3 * n:] > 0.5)[0]
            ids2 = recon.add_points_batch(flat2[:3 * n].reshape(n, 3)[sel2])
            recon.add_observations_batch(name1, ids2, p1n[sel2])
            recon.add_observations_batch(name2, ids2, p2n[sel2])
            n_rescued = len(sel2)

        self.intrinsics.learn(recon.cameras[name1].K, *size1)
        self.intrinsics.learn(recon.cameras[name2].K, *size2)
        return {"pair": (name1, name2), "pair_score": score["total"],
                "essential_inliers": num_inl,
                "points_initial": n_first, "points_rescued": n_rescued}

    # ------------------------------------------------------------------
    def _mine_at_tolerance(self, recon: Reconstruction, new_name: str,
                           matches_data: Dict, tol: float, seen: set
                           ) -> Tuple[List, List, List]:
        uv_new, pids, leftovers = [], [], []
        seen_points = set(seen)
        for pair, pd in matches_data.items():
            if "error" in pd or new_name not in pair:
                continue
            other = pair[0] if pair[1] == new_name else pair[1]
            if other not in recon.cameras:
                continue
            corr = np.asarray(pd.get("correspondences", []), np.float64)
            if len(corr) == 0:
                continue
            if pair[0] == new_name:
                new_xy, other_xy = corr[:, :2], corr[:, 2:]
            else:
                new_xy, other_xy = corr[:, 2:], corr[:, :2]
            obs_pid, obs_uv = recon.camera_obs_arrays(other)
            if len(obs_pid) == 0:
                leftovers.append((other, new_xy, other_xy,
                                  np.ones(len(corr), bool)))
                continue
            dist, j = _min_dists(other_xy, obs_uv)
            hit = dist <= tol
            # first hit per point id, minus points already claimed
            hi = np.where(hit)[0]
            cand = obs_pid[j[hi]].astype(int)
            first = np.unique(cand, return_index=True)[1]
            for k in np.sort(first):
                pid = int(cand[k])
                if pid not in seen_points:
                    seen_points.add(pid)
                    uv_new.append(new_xy[hi[k]])
                    pids.append(pid)
            leftovers.append((other, new_xy, other_xy, ~hit))
        return uv_new, pids, leftovers

    def _mine_2d3d(self, recon: Reconstruction, new_name: str,
                   matches_data: Dict) -> Tuple[np.ndarray, np.ndarray, List]:
        """2D-3D correspondence mining with the tolerance ladder.

        Links pre-established by track extension and bootstrap
        (self.pending_obs) come first; the ladder widens the pixel gate
        until min_pnp_correspondences are found. Also returns the leftover
        2D-2D correspondences for later triangulation.
        """
        pend = self.pending_obs.get(new_name, [])
        n_pts = recon.num_points
        base_pids = []
        base_uv = []
        seen = set()
        for pid, uv in pend:
            pid = int(pid)
            if pid < n_pts and pid not in seen:
                seen.add(pid)
                base_pids.append(pid)
                base_uv.append(np.asarray(uv, np.float64))

        need = self.config.min_pnp_correspondences
        uv_new, pids, leftovers = [], [], []
        for tol in self.config.mine_tolerance_ladder:
            uv_new, pids, leftovers = self._mine_at_tolerance(
                recon, new_name, matches_data, tol, seen)
            if len(uv_new) + len(base_uv) >= need:
                break

        all_uv = base_uv + uv_new
        all_pids = base_pids + pids
        if not all_uv:
            return np.zeros((0, 2)), np.zeros(0, int), leftovers
        return np.stack(all_uv), np.asarray(all_pids, int), leftovers

    def _add_view(self, recon: Reconstruction, name: str,
                  matches_data: Dict, image_info: Dict) -> bool:
        # per-phase wall timings land in the add_view history entry; each
        # phase ends in a host pull, so they include the device's work
        self._view_timings = {}
        with self._phase("mine_s"):
            uv, pids, leftovers = self._mine_2d3d(recon, name, matches_data)
        if len(uv) < self.config.min_pnp_correspondences:
            return False
        size = self._image_size(name, image_info, uv)
        K = self.intrinsics.estimate(*size)

        n = len(uv)
        with self._phase("pnp_s"):
            gen = torch.Generator().manual_seed(len(recon.cameras))
            res = solve_pnp_ransac(self._t(recon.points_array()[pids]),
                                   self._t(uv), self._t(K),
                                   threshold_px=self.config.pnp_threshold_px,
                                   u=draw_uniform(512, 12, gen, self.device))
            # the whole result in one pull:
            # [success, num_inliers, ratio, mean_err, R, t, inliers]
            flat = res.packed.cpu().numpy()
        if flat[0] < 0.5 or int(flat[1]) < self.config.min_pnp_correspondences:
            return False

        R = flat[4:13].reshape(3, 3).astype(np.float64)
        t = flat[13:16].astype(np.float64)
        recon.add_camera(Camera(name, R, t, K, size))
        inl = np.where(flat[16:16 + n] > 0.5)[0]
        recon.add_observations_batch(name, pids[inl], uv[inl])
        self.pending_obs.pop(name, None)

        # triangulate brand-new points against each processed neighbour:
        # one batched call for all of them, one pull
        with self._phase("tri_s"):
            self._triangulate_leftovers(recon, name, K, R, t, leftovers)

        # progressive triangulation of the new camera against the
        # unprocessed images, then track extension
        with self._phase("prog_s"):
            if self.config.enable_progressive:
                self._progressive_triangulate(recon, [name], matches_data,
                                              image_info)
        with self._phase("ext_s"):
            if self.config.enable_track_extension:
                self._extend_tracks(recon, matches_data, only_camera=name)

        # incremental BA: the last <= window cameras free, all their
        # points free (dict order is insertion = processing order)
        with self._phase("ba_s"):
            recent = list(recon.cameras)[-self.config.incremental_ba_window:]
            out = self._run_ba(recon, optimize_cams=recent,
                               max_iters=self.config.ba_max_iters,
                               ftol=self.config.incremental_ba_ftol,
                               skip_if_below_px=self.config
                               .incremental_ba_skip_px,
                               warm_start=self.config.warm_start_lambda)
        self._view_timings["ba_iters"] = out.get("iterations", 0)
        self._view_timings["ba_mre0"] = out.get("initial_mean_reproj_px", -1.0)
        self._view_timings["ba_mre"] = out.get("mean_reproj_px", -1.0)
        self.intrinsics.learn(recon.cameras[name].K, *size)
        return True

    def _triangulate_leftovers(self, recon: Reconstruction, name: str,
                               K: np.ndarray, R: np.ndarray, t: np.ndarray,
                               leftovers: List) -> int:
        """New points from the matches of a freshly registered camera that
        mining left unmatched, against each registered neighbour with at
        least 8 of them."""
        tri_cfg = TriangulationConfig(
            min_angle_deg=self.config.min_angle_deg,
            max_reproj_px=self.config.max_reproj_px)
        # neighbours in the reference's order (grouped by its capacity
        # bucket, first seen first), which numbers the new points
        groups: Dict[int, list] = {}
        for other, new_xy, other_xy, left in leftovers:
            idx = np.where(left)[0]
            if len(idx) >= 8:
                groups.setdefault(_pair_cap(len(idx)), []).append(
                    (other, new_xy, other_xy, idx))
        items = [it for group in groups.values() for it in group]
        if not items:
            return 0
        L = max(len(it[3]) for it in items)
        cams = [recon.cameras[it[0]] for it in items]
        packed = _leftover_tri_batch(
            self._t(_pad_stack([it[1][it[3]] for it in items], L, (2,))),
            self._t(_pad_stack([it[2][it[3]] for it in items], L, (2,))),
            self._t(np.arange(L)[None] < np.asarray(
                [len(it[3]) for it in items])[:, None], bool),
            self._t(K), self._t(R), self._t(t),
            self._t(np.stack([c.K for c in cams])),
            self._t(np.stack([c.R for c in cams])),
            self._t(np.stack([c.t for c in cams])),
            tri_cfg).cpu().numpy()
        n_new = 0
        for (other, new_xy, other_xy, idx), rows in zip(items, packed):
            sel = np.where(rows[:len(idx), 3] > 0.5)[0]
            ids = recon.add_points_batch(rows[sel, :3])
            recon.add_observations_batch(name, ids, new_xy[idx[sel]])
            recon.add_observations_batch(other, ids, other_xy[idx[sel]])
            n_new += len(sel)
        return n_new

    # ------------------------------------------------------------------
    def _progressive_triangulate(self, recon: Reconstruction,
                                 anchors: List[str], matches_data: Dict,
                                 image_info: Dict) -> int:
        """Progressive triangulation with unprocessed images.

        For each anchor camera x unprocessed image with enough fresh
        matches: a rough pose for the unprocessed image (essential RANSAC
        and cheirality), triangulation, and the unknown baseline scale
        resolved by rescaling the new points about the anchor centre so
        their median anchor-frame depth matches the anchor's existing
        cloud. New points get a real observation in the anchor and a
        pending observation for the unprocessed image.
        """
        cfg = self.config
        all_images = {n for pair in matches_data for n in pair}
        unprocessed = sorted(all_images - set(recon.cameras))
        if not unprocessed:
            return 0
        tri_cfg = TriangulationConfig(min_angle_deg=cfg.min_angle_deg,
                                      max_reproj_px=cfg.relaxed_reproj_px)
        total = 0
        for anchor in anchors:
            cam_a = recon.cameras[anchor]
            obs_pid_a, obs_uv_a = recon.camera_obs_arrays(anchor)
            # scale prior: the median anchor-frame depth of the cloud
            pts_all = np.asarray(recon.points)
            if len(pts_all) == 0:
                continue
            ref_ids = (obs_pid_a if len(obs_pid_a)
                       else np.arange(len(pts_all)))
            X = pts_all[ref_ids]
            depth_a = (cam_a.R @ X.T + cam_a.t[:, None])[2]
            pos = depth_a[depth_a > 0]
            if len(pos) == 0:
                continue
            target_depth = float(np.median(pos))
            cands = []
            for boot in unprocessed:
                if (cfg.progressive_min_pending > 0
                        and len(self.pending_obs.get(boot, []))
                        >= cfg.progressive_min_pending):
                    continue   # already richly linked
                corr = lookup_pair(matches_data, anchor, boot)
                if corr is None or len(corr) < 8:
                    continue
                a_xy, b_xy = corr[:, :2], corr[:, 2:]
                if len(obs_uv_a):
                    dist, _ = _min_dists(a_xy, obs_uv_a)
                    fresh = dist > cfg.progressive_tolerance_px
                else:
                    fresh = np.ones(len(corr), bool)
                if fresh.sum() < 8:
                    continue
                a_f = a_xy[fresh].astype(np.float32)
                b_f = b_xy[fresh].astype(np.float32)
                size_b = self._image_size(boot, image_info, b_f)
                K_b = self.intrinsics.estimate(*size_b)
                cands.append((boot, a_f, b_f, K_b))

            # every chunk is queued before any result is pulled, so the
            # device runs ahead of the host
            K_a, R_a, t_a = self._t(cam_a.K), self._t(cam_a.R), self._t(cam_a.t)
            pending = []
            for s in range(0, len(cands), PROGRESSIVE_CHUNK):
                part = cands[s:s + PROGRESSIVE_CHUNK]
                N = max(len(c[1]) for c in part)
                draws = [_essential_draws(zlib.crc32(c[0].encode()) & 0x7FFFFFFF,
                                          len(c[1]), cfg.essential_method)
                         for c in part]
                out = _progressive_pair_batch(
                    self._t(_pad_stack([c[1] for c in part], N, (2,))),
                    self._t(_pad_stack([c[2] for c in part], N, (2,))),
                    self._t(np.arange(N)[None] < np.asarray(
                        [len(c[1]) for c in part])[:, None], bool),
                    K_a, self._t(np.stack([c[3] for c in part])), R_a, t_a,
                    torch.stack([d[0] for d in draws]).to(self.device),
                    torch.stack([d[1] for d in draws]).to(self.device),
                    cfg.essential_threshold_px, cfg.essential_method, tri_cfg)
                pending.append((N, part, out))
            results = {}
            for N, part, out in pending:
                flat = out.cpu().numpy()                  # (B, N*4 + 2)
                pts_g = flat[:, :N * 3].reshape(len(part), N, 3) \
                    .astype(np.float64)
                mask_g = flat[:, N * 3:N * 4] > 0.5
                for g, (boot, a_f, b_f, K_b) in enumerate(part):
                    results[boot] = (pts_g[g], mask_g[g],
                                     bool(flat[g, N * 4] > 0.5),
                                     int(flat[g, N * 4 + 1]), a_f, b_f)

            added_anchor = 0
            for boot in unprocessed:
                if added_anchor >= cfg.max_bootstrap_points_per_anchor:
                    break
                if boot not in results:
                    continue
                pts_all_b, tri_mask, ok, ninl, a_f, b_f = results[boot]
                if not ok or ninl < 15:
                    continue
                sel = np.where(tri_mask)[0]
                if len(sel) == 0:
                    continue
                pts = pts_all_b[sel]
                # resolve the scale about the anchor centre
                depths = (cam_a.R @ pts.T + cam_a.t[:, None])[2]
                med = float(np.median(depths))
                if med <= 1e-9:
                    continue
                s = target_depth / med
                C_a = cam_a.center
                pts = C_a[None] + s * (pts - C_a[None])
                budget = min(cfg.max_points_per_pair,
                             cfg.max_bootstrap_points_per_anchor
                             - added_anchor)
                if len(sel) > budget:
                    sel = sel[:budget]
                    pts = pts[:budget]
                ids = recon.add_points_batch(pts)
                recon.add_observations_batch(anchor, ids, a_f[sel])
                pend = self.pending_obs.setdefault(boot, [])
                pend.extend(zip(ids, b_f[sel]))
                added_anchor += len(sel)
                total += len(sel)
        return total

    def _extend_tracks(self, recon: Reconstruction, matches_data: Dict,
                       only_camera: Optional[str] = None) -> int:
        """Track extension to unprocessed images: pre-link existing 3D
        points to not-yet-registered images through their matches with
        registered cameras; consumed by _mine_2d3d at registration."""
        cfg = self.config
        all_images = {n for pair in matches_data for n in pair}
        cams = [only_camera] if only_camera else list(recon.cameras)
        count = 0
        for boot in sorted(all_images - set(recon.cameras)):
            pend = self.pending_obs.setdefault(boot, [])
            have = {int(p) for p, _ in pend}
            for cam_name in cams:
                if cam_name not in recon.cameras:
                    continue
                corr = lookup_pair(matches_data, boot, cam_name)
                if corr is None:
                    continue
                obs_pid, obs_uv = recon.camera_obs_arrays(cam_name)
                if len(obs_pid) == 0:
                    continue
                dist, j = _min_dists(corr[:, 2:], obs_uv)
                hi = np.where(dist <= cfg.track_extension_tolerance_px)[0]
                cand = obs_pid[j[hi]].astype(int)
                first = np.unique(cand, return_index=True)[1]
                for k in first:
                    pid = int(cand[k])
                    if pid not in have:
                        have.add(pid)
                        pend.append((pid, corr[hi[k], :2].copy()))
                        count += 1
        return count

    # ------------------------------------------------------------------
    def _ba_cfg(self, max_iters: int, ftol: float,
                skip_if_below_px: float) -> BAConfig:
        """BAConfig for a pipeline solve. Every config is gated
        (skip_if_below_px > 0); a gate of 0 px keeps the ungated
        semantics exactly, since the initial mean reprojection is never
        below it."""
        return BAConfig(max_iters=max_iters, ftol=ftol,
                        optimize_intrinsics=self.config.optimize_intrinsics,
                        skip_if_below_px=max(skip_if_below_px, 1e-12))

    def _run_ba(self, recon: Reconstruction,
                optimize_cams: Optional[List[str]] = None,
                max_iters: int = 20, ftol: float = 1e-6,
                skip_if_below_px: float = 0.0,
                warm_start: bool = False) -> Dict:
        if recon.num_points == 0 or recon.num_observations < 10:
            return {"skipped": True}
        ocam_names = set(recon.cameras)
        window_has_obs = optimize_cams is not None and any(
            n in ocam_names and len(recon.camera_obs_arrays(n)[0])
            for n in optimize_cams)
        cfg = self._ba_cfg(max_iters, ftol, skip_if_below_px)
        lam0 = (self._ba_lambda if (warm_start and
                                    self._ba_lambda is not None)
                else cfg.lambda_init)
        # adaptive skip threshold: once solves converge around some mean
        # reprojection, a view whose initial error is already there has
        # nothing for LM to recover. Floor = the config value.
        skip_thr = skip_if_below_px
        if skip_if_below_px > 0 and self._ba_mre_last is not None:
            skip_thr = max(skip_if_below_px,
                           self._ba_mre_last
                           + self.config.incremental_ba_skip_margin_px)
        if window_has_obs and self.config.use_local_ba:
            # windowed incremental BA on the reduced problem
            prob, names, pids = recon.to_local_ba_problem(
                optimize_cams, fix_first=True,
                optimize_intrinsics=self.config.optimize_intrinsics,
                device=self.device)
            res = bundle_adjust(prob, cfg, lambda0=lam0,
                                skip_below_px=skip_thr)
            cams_np, pts_np, stats = _split_packed(
                res.packed, len(names), len(pids))
            recon.update_from_local_ba(cams_np, pts_np, names, pids)
        else:
            prob, names = recon.to_ba_problem(
                optimize_cams=optimize_cams, fix_first=True,
                optimize_intrinsics=self.config.optimize_intrinsics,
                device=self.device)
            res = bundle_adjust(prob, cfg, lambda0=lam0,
                                skip_below_px=skip_thr)
            cams_np, pts_np, stats = _split_packed(
                res.packed, len(names), recon.num_points)
            recon.update_from_ba(cams_np, pts_np, names)
        if warm_start and int(stats[2]) > 0:
            self._ba_lambda = float(stats[4])
        if skip_if_below_px > 0 and int(stats[2]) > 0:
            self._ba_mre_last = float(stats[3])
        return {"cost_initial": float(stats[0]),
                "cost_final": float(stats[1]),
                "iterations": int(stats[2]),
                "mean_reproj_px": float(stats[3]),
                "initial_mean_reproj_px": float(stats[5])}

    def _global_ba(self, recon: Reconstruction) -> Dict:
        """Global BA, all cameras free but the first.

        Inside a process group of more than one rank (one process a card,
        `torchrun --nproc-per-node N`; every rank runs the pipeline), a
        big enough problem runs the sharded Schur-CG solve
        (`parallel/ba.py`): points and observations split over the ranks,
        cameras replicated; the history records `"sharded": world size`.
        Outside a group the single-card solve runs, whatever the count of
        cards."""
        world = world_size()
        if (self.config.use_sharded_global_ba and world > 1
                and recon.num_observations
                >= self.config.sharded_ba_min_obs
                and recon.num_points >= 10
                and recon.num_observations >= 10):
            prob, names = recon.to_ba_problem(
                optimize_cams=None, fix_first=True,
                optimize_intrinsics=self.config.optimize_intrinsics,
                device=self.device)
            res = sharded_bundle_adjust(
                prob, make_mesh(shape=(world, 1)), BAConfig(
                    max_iters=self.config.global_ba_max_iters,
                    schur_solver="cg",
                    optimize_intrinsics=self.config.optimize_intrinsics))
            cams_np, pts_np, stats = _split_packed(
                res.packed, len(names), recon.num_points)
            recon.update_from_ba(cams_np, pts_np, names)
            return {"cost_initial": float(stats[0]),
                    "cost_final": float(stats[1]),
                    "iterations": int(stats[2]),
                    "mean_reproj_px": float(stats[3]),
                    "sharded": world}
        return self._run_ba(recon, optimize_cams=None,
                            max_iters=self.config.global_ba_max_iters)

    def _validate_points(self, recon: Reconstruction) -> int:
        """Post-BA point re-validation: drop points with excessive mean
        reprojection error, a behind-camera observation or fewer than two
        observations. One batched projection over the observation arrays
        and bincount segment sums."""
        if recon.num_points == 0:
            return 0
        ocam, opid, ouv = recon.obs_arrays()
        P = recon.num_points
        bad = np.zeros(P, bool)
        if len(opid):
            names = recon.camera_names()
            R = np.stack([recon.cameras[n].R for n in names])
            t = np.stack([recon.cameras[n].t for n in names])
            K = np.stack([recon.cameras[n].K for n in names])
            pts = np.asarray(recon.points)
            Xc = np.einsum("nij,nj->ni", R[ocam], pts[opid]) + t[ocam]
            z = Xc[:, 2]
            behind = z <= 1e-6
            zs = np.where(behind, 1.0, z)
            proj = np.einsum("nij,nj->ni", K[ocam], Xc / zs[:, None])
            e = np.hypot(proj[:, 0] - ouv[:, 0], proj[:, 1] - ouv[:, 1])
            np.logical_or.at(bad, opid[behind], True)
            ok = ~behind
            errs = np.bincount(opid[ok], weights=e[ok], minlength=P)
            counts = np.bincount(opid[ok], minlength=P)
        else:
            errs = np.zeros(P)
            counts = np.zeros(P)
        mean_err = errs / np.maximum(counts, 1)
        bad |= mean_err > self.config.post_ba_max_reproj_px
        bad |= counts < 2
        if bad.any():
            recon.remove_points(np.where(bad)[0])
        return int(bad.sum())

    # ------------------------------------------------------------------
    def export(self, recon: Reconstruction, output_dir) -> Dict:
        """Phase 4: pickle + JSON + COLMAP + summary report."""
        from tpu3drec_torch.sfm.quality import assess_reconstruction_quality
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        legacy = recon.to_legacy_format()
        with open(out / "optimized_camera_poses.pkl", "wb") as f:
            pickle.dump(legacy, f)
        (out / "camera_poses.json").write_text(
            json.dumps(legacy["camera_poses"], indent=2))
        recon.export_colmap(out / "colmap")
        report = {
            "statistics": recon.stats(),
            "quality": assess_reconstruction_quality(recon),
            "history": self.history,
        }
        (out / "reconstruction_report.json").write_text(
            json.dumps(report, indent=2, default=str))
        return report


def reconstruct_scene(matches, image_info: Optional[Dict] = None,
                      output_dir=None,
                      config: Optional[SfMConfig] = None,
                      chosen_images: Optional[List[str]] = None,
                      device=None) -> Reconstruction:
    """Public SfM entry point on `device` (None means CUDA).

    `matches` is either the matches_data dict ({(img1, img2):
    {correspondences Nx4, ...}}), a path to batch pickles, or a glob
    pattern of them.
    """
    pipe = SfMPipeline(config, device=device)
    if isinstance(matches, (str, Path)):
        from tpu3drec_torch.io.batch_pickle import load_and_validate_pickle
        loaded = load_and_validate_pickle(str(matches))
        matches_data = loaded["matches_data"]
        image_info = image_info or loaded["image_info"]
    else:
        matches_data = matches
    return pipe.reconstruct(matches_data, image_info, output_dir,
                            chosen_images)
