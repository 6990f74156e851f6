#!/usr/bin/env python3
"""On-card smoke run of the tpu3drec_torch port (one NVIDIA H100).

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  1. the card's name and power limit; build every kernel in
     tpu3drec_torch/csrc with nvcc (one process per source, in parallel);
  2. each kernel against its plain PyTorch version on the card, on the
     inputs the main path gives it: `ori_desc` on all five octaves of the
     full batch (its support boxes equal `support_boxes`, its device
     slot list holds the valid slots, two launches give the same bits,
     every slot outside the bars listed with its histogram's peaks) and
     on an all-valid stress meta at the octave-0 and octave-4 shapes
     (borders, the detector's scale range, slots beyond it on the
     uncached path, which may not miss), `knn2` int8 bit for bit on the
     full batch of pairs, on a full-occupancy stress input (the path's
     shape, every column valid) and on `KNN2_CASES` (scattered masks,
     duplicate columns, no or one valid column, ragged N and M, D 64 to
     1024, `hamming_pm1`, norms too wide for the packed fold), each twice
     for identical bits, and float32 on two pairs; `knn2` is timed at the
     path's input and at full occupancy beside two yardsticks (f32 matmul
     + topk, a bf16 tensor-core GEMM + topk);
  3. the main path: `make_pair_fn(max_features=2048, num_hypotheses=256)`
     on 96 pairs of 480x640 images, each a synthetic photo and a known
     similarity warp of it. Launch counts are read around one call, then
     five timed calls give pairs/s; the result must pass a quality bar,
     recover the known warps, and agree on one pair with the same step
     run on the CPU through the plain versions;
  4. the dense stage at `bench.py:bench_dense`'s configuration: 3 views
     of 480x640 (a synthetic photo rolled by -12, 0 and 12 px, f = 600,
     so a fronto-parallel plane at depth 6), 64 disparities, weighted
     fusion, TSDF at 64. The `sgm` kernel is held bit for bit against
     its plain version on the 4 cost volumes this run hands it and at
     `SGM_SHAPES` (D 16..128, one and three volumes, odd H and W), each
     twice; launch counts are
     read around one `run_complete_pipeline` call, then three timed calls
     give MP-depth/s of the stereo stage and each stage's seconds; the
     result must pass a quality bar and the stereo stage must agree with
     the same stage run on the CPU through the plain versions; one
     profiled call of the stereo stage and one of the whole pipeline;
  5. SfM geometry and bundle adjustment through the public functions
     (no TPU kernel lies on this path): the two-view chain (find_essential
     with the 5-point and the 8-point solver -> recover_pose ->
     triangulate_two_view) on a batch of 4 pairs of 2,048 correspondences
     (f = 700, 0.1-0.3 rad, 20% outliers, 0.5 px noise), solve_pnp_ransac
     on 2,048 points, iterative_refinement from a focal 20% off, and global
     BA at bench.py:bench_ba's 50 cams / 100k points / 500k observations
     (Schur-CG, 10 LM iterations): each against its bars, the ms of each,
     BA ms/LM-iter and peak memory; then pair 0, PnP, the dryrun BA problem
     and a 3-camera dense-Schur window against the CPU plain path with the
     same draws;
  6. the incremental SfM pipeline (`SfMPipeline(SfMConfig()).reconstruct`)
     at bench.py:bench_sfm's folder: 50 views of 640x480 around 15,000
     points (the port's `make_sfm_scene`). One cold run, with the kernels'
     launch counts read around it (0: no TPU kernel lies on this path),
     then one steady run give views/s; every view must register, the
     final mean reprojection
     stay under 1 px and every consecutive relative rotation within 1 deg
     of the truth; the per-phase split of the steady run; one profiled run
     of a 6-view cut (busy share, the sfm.* ranges' host and device
     time, device time by kernel); tests/test_sfm_pipeline.py's 5-view
     scene on the card against the CPU plain path;
  7. the folder chain images -> matches -> SfM -> mesh:
     `reconstruct_folder(folder, out, preset="balanced",
     pair_mode="consecutive", pair_window=2, dense=True)`, the CLI `auto
     --dense` command's defaults (SIFT + ORB at 2,000 features), on 24
     views of 640x480 rendered by tests/test_end_to_end.py's splat
     renderer (written as .npy). One cold run, with the launches of
     `ori_desc`, `knn2` (on both its SIFT and its ORB input) and `sgm`
     read around it (any zero fails), then one timed run: images/s,
     matching pairs/s, each stage's seconds, the batched engine's device
     calls (2 x methods x batches), each method's pairs and mean raw
     matches, views registered, reprojection, rotations against the
     renderer's, cloud points and mesh faces (the mesh reported, not
     held: near-empty in both packages on this scene), against their bars; no
     engine fallback, failed pair or method error. The first batch of 8
     pairs on the card against the CPU plain path (the same pairs, raw
     match counts within max(2, 2%), the same best method where the CPU's
     scores differ by more than 0.02), the card's SfM again on the
     steady run's matches (the same views, points and poses, bit for
     bit), the CPU's SfM on the card's matches, the dense stage on a 7-view cut of the card's registered
     views (card and CPU), the views a 4-view cut registers on both, and
     `knn2` on one batch's ORB operands bit for bit against its plain
     version, twice, timed beside its bound;
  8. the same folder through the CLI `auto --preset accurate --dense`
     chain: `reconstruct_folder(..., preset="accurate", dense=True)`
     (SIFT at contrast 0.03, AKAZE at 0.0005 and BRISK at 20/255, each
     at 3,000 features). One cold run with the launches of `ori_desc`,
     `knn2` (counted by method: SIFT l2_int8, AKAZE and BRISK
     hamming_pm1) and `sgm` read around it (any zero fails), then one
     timed run: images/s, pairs/s, each stage's seconds, the engine's
     device calls (2 x 3 x batches), each method's slot fill and mean
     raw matches (at least 20 a pair), views registered, reprojection,
     rotations against the renderer's (and the neighbouring views off
     by 1 deg or more), cloud points and mesh faces; no fallback, failed
     pair or method error. The first batch on the card against the CPU
     plain path (raw counts, best method, AKAZE's and BRISK's keypoints
     and bits per image by the CPU tests' shares); each detector's
     seconds and a profiled AKAZE call; Harris and GoodFeatures pairs and
     SIFT's gather sampler and `upscale`, card against CPU; `ori_desc`
     at the batch's SIFT octaves and `knn2` at its AKAZE (486 wide,
     padded to 512) and BRISK operands against their plain versions;
  9. the rest of the dense stage on the sparse input and images phase
     7's chain handed its dense stage (24 views of 640x480, ~52,000
     cloud points): `DenseReconstructionPipeline(mesh_method=m)` for
     poisson, ball_pivot and alpha at the defaults (meshes at 96, the
     union-of-balls fields on up to 16,384 points), each with its stage
     seconds, cloud, mesh method used (it must be m; ball pivoting may
     degrade to the depth grid only where its own mesh is empty, as in
     both packages' CPU runs of this folder), faces and mesh quality;
     `run_multi_reference(num_refs=3, mesh_method="poisson")` with
     per-reference and merged points and each ICP step's rotation,
     translation and median displacement of the points it moves
     (printed, not held: the reference's ICP turns these clouds by
     degrees, in both packages); `plane_sweep_depth` and
     `plane_sweep_depth_blockwise` at 480x640 with 64 planes on
     tests/test_plane_sweep.py's scene scaled to that size, against the
     test's bars, timed; `sgm` at the plane-sweep volume (1, 64, 480,
     640) bit for bit against its plain version, twice, timed beside
     its bound; the sgm launches around each call (any zero fails, the
     blockwise sweep runs no SGM); against the CPU plain path: Poisson
     (chi, iso, faces, Chamfer) on the card's cloud, alpha and ball
     pivoting (at a radius of 4 voxels, non-empty) on a 2,048-point
     subsample of it, their distance grids on both devices held to the
     exact float64 distances (argmin too, where the second-nearest
     point is clear of the rounding bound), and each ICP merge step,
     step by step (correspondences equal but for near-ties within the
     rounding window, Kabsch on the card's correspondences within
     1e-3 deg and 1e-4 of the extent; the end-to-end gap printed);
  10. the deep models on phase 7's folder, with random full-width
     parameters from a seeded generator written as converted
     checkpoints into a temporary directory (the phase points
     `models.WEIGHTS_DIR` there and restores it): SuperPoint, DISK,
     ALIKED-n16 and LightGlue (dim 256, 9 layers) for 256-d and 128-d
     descriptors. `create_pipeline("deep_learning").match_folder` at its
     defaults (SuperPoint + DISK, consecutive pairs, 8 a batch; kNN
     through `knn2`'s float32 path, its launches counted by method and
     the first batch's operands kept), cold then timed: images/s,
     pairs/s, each detector's seconds on one batch, a profiled batch;
     the per-pair path with LightGlue on 3 pairs with SuperPoint, DISK
     and ALIKED-n16, LightGlue's ms per pair at 2,048 keypoints and a
     profiled call; SuperPoint and DISK on two images and LightGlue on
     their pair, card against the CPU plain path at "highest" (the same
     clear keypoints, scores and descriptors within the CPU tests' bars,
     log-assignment within 8x the CPU's own float32 error against a
     float64 run, matches equal off near-ties) and at "default" (TF32:
     differences printed, LightGlue's match count within 5%); `knn2`'s
     float32 kernel at the SuperPoint (x 256) and DISK (x 128) operands
     against its plain version, timed beside its bound and f32 `bmm` +
     topk. SfM and dense are not run on random features;
  11. the user surface on the same folder: the CLI `auto --dense`
     through `cli.main` in this process (the `ori_desc`, `knn2` and `sgm`
     launches read around it, each must be non-zero, and >= 90% of the
     views registered) and once as `python -m tpu3drec_torch auto
     --dense` in a new process (exit 0, the same number of cameras);
     a live `MatchServer` (480x640, 1,024 features) on localhost:
     /health and /methods, 16 concurrent SIFT /match requests from 8
     threads (phase 3's photos and their known warps in 8-bit levels;
     every 4th as base64 PNG files, the rest as lists), which must all
     answer 200, be batched (fewer dispatches than requests, a batch
     wider than one), launch `ori_desc` and `knn2`, and map the corners
     within 2 px of the known warp on >= 90% of the answers; one
     /detect and one ORB /match (the unbatched path); requests/s, p50 /
     p99 latency and the server's split of each request's time (body,
     decode, wait, compute); `ori_desc` and `knn2` on the widest served
     batch's operands, kept as it ran, against their plain versions
     (phase 2's bars; knn2 bit for bit), timed; phase 3's pair 0, in
     float and in the requests' 8-bit levels, through the card's
     batcher against a CPU one with the same draws: row by row (no row
     clear of a near-tie may differ, and >= 60% of the CPU's rows must
     be clear), inliers and corners to phase 3's bars, and the raw
     match count too on the float pair; the CLI `benchmark` subcommand (SIFT
     and ORB, 2 runs) with no method error and `knn2` launched by its
     throughput task; `trace_to` leaving a trace and
     `device_memory_stats` reporting the card;
  12. one JSON line with every kernel's launches (by path), error, time,
     bound and the plain and library yardsticks; each phase's seconds;
  13. last line: {"ok": true, "device": {...}}.

Without CUDA, or without the package beside it, it fails before printing
any result. It imports nothing of JAX.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

H, W = 480, 640
BATCH = 96
MAX_FEATURES = 2048
NUM_HYPOTHESES = 256
REPS = 5
SEED = 0

# the dense stage: bench.py:bench_dense's folder and pipeline settings
DENSE_BX = (-0.12, 0.0, 0.12)
DENSE_F = 600.0
DENSE_DEPTH = DENSE_F * 0.12 / 12      # 6.0: 12 px of disparity
NUM_DISPARITIES = 64
TSDF_RESOLUTION = 64
DENSE_REPS = 3
DENSE_VALID_BAR = 0.95      # fused valid fraction (CPU run: PERF.md)
SGM_FLOPS_PER_ELEMENT = 39  # 9 per DP step x 4 directions + 3 sums

# the SfM phase: a chunk of pairs as the pipeline batches them
# (sfm/pipeline.py CHUNK), bench.py:bench_ba's global BA
SFM_PAIRS = 4
SFM_N = 2048
SFM_F = 700.0
SFM_W, SFM_H = 640, 480
SFM_NOISE = 0.5
SFM_OUTLIERS = 0.2
SFM_HYPOTHESES = 1024
SFM_THRESHOLD_PX = 1.5
# per method: rotation (deg), translation direction (deg), inlier recall.
# The 8-point chain (the reference's: one 8-point refit of the winning
# minimal sample) misses the 5-point bars on some draws of such scenes;
# the 5-point chain, the SfM pipeline's default, holds them
TWO_VIEW_BARS = {"5point": (0.5, 2.0, 0.9), "8point": (2.0, 10.0, 0.5)}
PNP_N = 2048
PNP_HYPOTHESES = 512
BA_CAMS, BA_PTS, BA_OBS_PER_PT = 50, 100_000, 5

# the SfM pipeline: bench.py:bench_sfm's folder (the port's
# bench/synthetic.py:make_sfm_scene, 640x480, pair_window 2, 0.4 px noise,
# 0.85 visibility) and its default SfMConfig
PIPE_VIEWS, PIPE_POINTS = 50, 15000
PIPE_PROFILE_VIEWS = 6
PIPE_REPROJ_BAR = 1.0       # final mean reprojection (px); the noise is 0.4
PIPE_ROT_BAR_DEG = 1.0      # consecutive relative rotations vs the truth
# card against the CPU plain path on tests/test_sfm_pipeline.py's scene
PIPE_CPU_POINTS_RTOL = 0.10
PIPE_CPU_REPROJ_PX = 0.1
PIPE_CPU_ROT_DEG = 0.25
PIPE_PHASES = ("rank_s", "mine_s", "pnp_s", "tri_s", "prog_s", "ext_s", "ba_s")

# the folder chain: the CLI `auto --dense` command's defaults (preset
# "balanced": SIFT + ORB at 2,000 features, flann 0.7 / bf 0.75, pairs in
# batches of 8; consecutive pairs, window 2; SfMConfig(); dense at its
# defaults) on tests/test_end_to_end.py's splat renderer, 24 views of
# 640x480. Two settings differ from that test: FOLDER_F is the focal the
# SfM assumes for a 640x480 image without EXIF (0.85 x 640,
# sfm/intrinsics.py:fov_heuristic_ratio), so the recovered rotations can
# be held against the renderer's (at the test's f = 700 both packages
# read 1-3 deg on every pair), and 600 splats, which fill half of SIFT's
# 2,000 slots on the median view (1,002). The bars rest on runs of both
# packages on this folder (`tests/folder_chain_cpu.py`; PERF.md): the
# port registered 23-24 views on the CPU, the reference 23, at 0.32-0.34
# px. Weak views register a few degrees off in every run, and which ones
# turns on float order: the port's CPU runs read 86.4% of the
# neighbouring registered views within 1 deg at 1 thread and 95.7% at 2,
# 4 and 8, the card 82.6-87.0% (19-20 of 23 pairs), the reference 77.3%.
# So the rotation bars hold the median and a share of 78%, one pair of 23
# under the lowest reading of the port on either device. The CPU's SfM on
# the card's own matches must meet the same bars
FOLDER_VIEWS = 24
FOLDER_POINTS = 600
FOLDER_F = 544.0
FOLDER_PAIR_WINDOW = 2
FOLDER_BATCH = 8
FOLDER_CUT = 4
FOLDER_REGISTERED_BAR = 0.9   # share of the views registered
FOLDER_REPROJ_BAR = 1.5       # final mean reprojection (px)
FOLDER_ROT_BAR_DEG = 1.0      # consecutive relative rotations vs the renderer:
FOLDER_ROT_SHARE_BAR = 0.78   # the median, and this share of the pairs
FOLDER_SCORE_GAP = 0.02       # best method compared where scores differ more
# the dense stage stereo-matches every view against the middle one, across
# up to 60 deg here, and its TSDF meshes the fused depth into a handful of
# faces or none in both packages (port 28 on the CPU, 0-12 on the card;
# reference 0), so the mesh is reported, not barred. The bars hold the
# artifacts, the cloud and the fused depth's valid share, 12% under the
# lowest reading (cloud: port 59,013 on the CPU, 51,728-54,381 on the
# card, reference 51,164 points; valid share: port 0.780 and 0.686-0.719,
# reference 0.682), and the card's dense stage is held to the CPU plain
# path's on the same sparse views and images: phase 4's mask agreement
# (99.9%) as a difference of valid shares, and the cloud within 1%
FOLDER_CLOUD_BAR = 45_000
FOLDER_VALID_BAR = 0.6
FOLDER_DENSE_VALID_ABS = 0.001
FOLDER_DENSE_CLOUD_RTOL = 0.01
FOLDER_DENSE_CUT = 7          # views of the card-vs-CPU dense comparison
FOLDER_METRIC_BY_DEPTH = {128: "l2_int8", 256: "hamming_pm1"}

# phase 8: the same folder through the CLI `auto --preset accurate
# --dense` chain (SIFT + AKAZE + BRISK at 3,000 features; flann 0.7 for
# SIFT, bf 0.75 for AKAZE and BRISK). The bars rest on runs of both
# packages on this folder on the CPU (tests/folder_chain_cpu.py --dense
# --preset accurate; PERF.md): each registered all 24 views at
# 0.355 / 0.367 px with every one of the 23 neighbouring pairs within
# 1 deg (median 0.047 / 0.038 deg); the port read 147.1 / 59.3 / 315.2
# mean raw matches a pair for SIFT / AKAZE / BRISK, and AKAZE and BRISK
# fill all 3,000 slots of every view (SIFT 1,314 on the median view). The
# views and reprojection bars are phase 7's; the rotation share is one
# pair of 23 under the lowest reading (100%)
ACC_PRESET = "accurate"
ACC_METRIC = {"SIFT": "l2_int8", "AKAZE": "hamming_pm1", "BRISK": "hamming_pm1"}
ACC_DEPTH_METHOD = {128: "SIFT", 486: "AKAZE", 512: "BRISK"}
ACC_RAW_MATCHES_BAR = 20      # each method's mean raw matches a pair
ACC_ROT_SHARE_BAR = 0.95      # share of neighbouring views within 1 deg
ACC_SHARE = 0.99              # AKAZE / BRISK keypoints and bits, card vs CPU

# phase 9: the rest of the dense stage on phase 7's folder
IMPLICIT_METHODS = ("poisson", "ball_pivot", "alpha")
# faces of each method's mesh: about half the fewest of both packages'
# CPU runs of this folder (PERF.md §6). Ball pivoting may come out
# empty here, as it does in both packages' CPU runs: the cloud's far
# tail of stereo outliers sets a voxel far wider than the ball, so the
# ball's support holds almost no cell; the pipeline then degrades to the
# depth-grid mesh, and the phase checks that the mesher's own result
# was empty. The mesher itself is held non-empty on the subsample below,
# at a radius of CPU_BALL_RADIUS_VOXELS voxels
IMPLICIT_FACES_BAR = {"poisson": 700, "ball_pivot": 1, "alpha": 400}
MULTI_REFS = 3
MULTI_FACES_BAR = 500         # the merged Poisson mesh, the same way
# ICP's steps in multi-reference mode are printed (rotation, translation,
# the median displacement of the points they move), not held: the
# reference's ICP turns phase 7's clouds by degrees in both packages,
# their far tails of stereo outliers driving Kabsch (PERF.md §6), so
# the card's ICP is held to the CPU plain path's on the same operands,
# step by step (`icp_check`): one correspondence flipped at a near-tie
# changes every later step, so the end-to-end gap is only printed
CPU_SUBSAMPLE = 2048          # alpha / ball pivot, card vs CPU
CPU_BALL_RADIUS_VOXELS = 4    # ball pivoting's radius there (voxels)
CPU_FACES_RTOL = 0.01         # faces, card vs CPU, on the same cloud
CPU_CHAMFER_VOXELS = 0.01     # symmetric mean vertex Chamfer (voxels)
CPU_CHI_ATOL = 1e-5           # x max |chi| (FFT libraries and atomics)
CPU_ISO_RTOL = 1e-4
# distance grids (float32 |g|^2 + |p|^2 - 2 g.p) on each device against
# the exact float64 distances at the same float32 centres: |d^2 - exact|
# within this many eps32 (|g| + max |p|)^2 (the expanded form's first-
# order rounding bound is 2.5), argmin exact wherever the second-nearest
# point is farther by twice that, which must hold for this share of the
# cells at least
CPU_DIST2_EPS = 4.0
CPU_CLEAR_SHARE = 0.5
CPU_ICP_ROT_DEG = 1e-3        # ICP's Kabsch step, card vs CPU on the
CPU_ICP_SHIFT = 1e-4          # same correspondences (t over the extent)
SWEEP_H, SWEEP_W, SWEEP_PLANES = 480, 640, 64
SWEEP_F, SWEEP_B = 500.0, 0.4   # tests/test_plane_sweep.py's scene x5
SWEEP_VALID_BAR = 0.3         # the test's own bars
SWEEP_REL_ERR_BAR = 0.08

# phase 10: the deep models on phase 7's folder, with random full-width
# parameters from one seeded generator (no checkpoint can be fetched):
# SuperPoint (2,048 features, NMS 4, threshold 0.005), DISK (128-d),
# ALIKED-n16 and LightGlue (dim 256, 9 layers, 4 heads) for 256-d and
# 128-d descriptors. The folder engine at the `deep_learning` preset's
# defaults (consecutive pairs, window 1, 8 pairs a batch) matches both
# methods by kNN (knn2's float32 path), as the reference's engine does;
# LightGlue runs on the per-pair path. Random features carry no
# geometry, so SfM and dense are not run on them. The card is held to the
# CPU plain path at matmul_precision "highest" with the CPU tests' bars
# (tests/test_torch_models.py): scores within DEEP_SCORE_BAR (DISK's
# relative to its heat's largest magnitude), keypoints the same where a
# score clears its window neighbours, the k-th score and the threshold by
# more than that, descriptors at cosine > DEEP_COS_BAR; LightGlue's
# log-assignment within DEEP_LG_ERR_X times the CPU's own float32 error
# (against a float64 run of the same network and inputs: two float32
# runs sit within twice it, and the card sums in other orders), matches
# equal away from near-ties. At "default" (TF32) the differences are
# printed, and LightGlue's mutual matches over the per-pair path's pairs
# with both detectors (~150 with these weights, so that 5% is several
# matches) held within DEEP_TF32_COUNT_RTOL of the count at "highest"
DEEP_PRESET = "deep_learning"
DEEP_SEED = 10
DEEP_LG = dict(dim=256, n_layers=9, heads=4)
DEEP_PERPAIR = 3              # pairs through the per-pair path
DEEP_PERPAIR_METHODS = ("SuperPoint", "DISK", "ALIKED")
DEEP_SCORE_BAR = {"SuperPoint": 1e-7, "DISK": 5e-5}
DEEP_COS_BAR = 0.9999
DEEP_LG_ERR_X = 8.0
DEEP_TF32_COUNT_RTOL = 0.05
DEEP_DEPTH_METHOD = {256: "SuperPoint", 128: "DISK"}
KNN2_F32_TOL = 1e-4           # csrc/knn2.cu's stated float32 bar

# NVIDIA H100 SXM data-sheet peaks (dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS = 67e12
PEAK_INT8_OPS = 1979e12


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def synthetic_photo(h, w, seed):
    """Rectangles and discs on a noisy background, normalised to [0, 1]."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for _ in range(60):
        y, x = rng.integers(5, h - 40), rng.integers(5, w - 40)
        hh, ww = rng.integers(8, 80), rng.integers(8, 80)
        img[y:y + hh, x:x + ww] += rng.uniform(-0.4, 0.4)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(20):
        cy, cx = rng.integers(20, h - 20), rng.integers(20, w - 20)
        r = rng.integers(5, 30)
        img += rng.uniform(-0.3, 0.3) * (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r)
    img += 0.02 * rng.standard_normal((h, w)).astype(np.float32)
    img -= img.min()
    img /= img.max()
    return img.astype(np.float32)


def warp_batch(torch, imgs, seed):
    """Similarity warps about the image centre: returns (warped, H) with
    H (B, 3, 3) mapping img1 pixel coords to img2's."""
    B, h, w = imgs.shape
    rng = np.random.default_rng(seed)
    ang = np.deg2rad(rng.uniform(-12, 12, B))
    sc = rng.uniform(0.9, 1.05, B)
    tx, ty = rng.uniform(-10, 10, B), rng.uniform(-10, 10, B)
    c = np.array([(w - 1) / 2, (h - 1) / 2])
    Hs = np.zeros((B, 3, 3))
    for i in range(B):
        A = sc[i] * np.array([[np.cos(ang[i]), -np.sin(ang[i])],
                              [np.sin(ang[i]), np.cos(ang[i])]])
        Hs[i, :2, :2] = A
        Hs[i, :2, 2] = c - A @ c + [tx[i], ty[i]]
        Hs[i, 2, 2] = 1
    Hinv = torch.tensor(np.linalg.inv(Hs), dtype=torch.float32, device=imgs.device)
    ys, xs = torch.meshgrid(torch.arange(h, device=imgs.device, dtype=torch.float32),
                            torch.arange(w, device=imgs.device, dtype=torch.float32),
                            indexing="ij")
    p = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    src = torch.einsum("bij,nj->bni", Hinv, p)
    sx = src[..., 0] / src[..., 2]
    sy = src[..., 1] / src[..., 2]
    grid = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], -1)
    out = torch.nn.functional.grid_sample(
        imgs[:, None], grid.reshape(B, h, w, 2), mode="bilinear",
        padding_mode="zeros", align_corners=True)[:, 0]
    return out.contiguous(), Hs


def cuda_ms(torch, fn, reps=REPS):
    """Mean ms per call from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_counts(pm, ps, psg):
    return {"ori_desc": ps.ori_desc.launches, "knn2": pm.knn2_raw.launches,
            "sgm": psg.sgm_aggregate_batch.launches}


def reset_counts(pm, ps, psg):
    ps.ori_desc.launches = pm.knn2_raw.launches = 0
    psg.sgm_aggregate_batch.launches = 0


def corner_error(Hest, Hgt, h, w):
    """Max distance (px) between the two maps over the image corners."""
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], float).T
    a = Hest @ c
    b = Hgt @ c
    return float(np.max(np.linalg.norm(a[:2] / a[2] - b[:2] / b[2], axis=0)))


def ori_desc_work(torch, oc, angle, chunk=4096):
    """What this run's valid slots need of `ori_desc`, counted from their
    own meta and angles with the plain version's geometry: band pixels
    that pass the orientation mask |u|,|v| <= 4.5, core pixels inside the
    descriptor support, the 4x4 cells that hold such a pixel, and the
    distinct stack pixels all of those read. Pixels outside the octave
    image are zeros and count as no work.
    Returns (n_band, n_core, n_cell, n_stack_px)."""
    from tpu3drec_torch.ops import pallas_sample as ps
    L, h, w = oc.dxs.shape
    dev = oc.dxs.device
    needed = torch.zeros(L * h * w, dtype=torch.bool, device=dev)
    n_band = n_core = n_cell = 0
    jj = torch.arange(ps.CORE_W, device=dev)
    valid = torch.nonzero(oc.meta[:, 3] >= 0)[:, 0]
    for s in range(0, valid.numel(), chunk):
        sel = valid[s:s + chunk]
        k = sel.numel()
        x, y, scl, lay, xs0, ys0, ysb = ps._geometry(oc.meta[sel], oc.hp, oc.fb)
        cols = xs0[:, None] + jj                                     # (k, 128)
        col_in = (cols >= 0) & (cols < w)
        rows_b = ysb[:, None] + torch.arange(ps.ORI_H, device=dev)   # (k, 56)
        rows_c = ys0[:, None] + torch.arange(ps.CORE_H, device=dev)  # (k, 88)
        rx = cols.to(torch.float32) - x[:, None]
        ub = rx / scl[:, None]
        vb = (rows_b.to(torch.float32) - y[:, None]) / scl[:, None]
        band = (((ub.abs() <= ps.ORI_RADIUS_FCTR) & col_in)[:, None, :]
                & ((vb.abs() <= ps.ORI_RADIUS_FCTR)
                   & (rows_b >= 0) & (rows_b < h))[:, :, None])
        ca = torch.cos(angle[sel])[:, None, None]
        sa = torch.sin(angle[sel])[:, None, None]
        inv_hw = (1.0 / (ps.DESC_SCL_FCTR * scl))[:, None, None]
        ry = (rows_c.to(torch.float32) - y[:, None])[:, :, None]
        ud = (ca * rx[:, None, :] + sa * ry) * inv_hw
        vd = (-sa * rx[:, None, :] + ca * ry) * inv_hw
        core = ((vd + 1.5 > -1) & (vd + 1.5 < ps.DESC_D)
                & (ud + 1.5 > -1) & (ud + 1.5 < ps.DESC_D)
                & col_in[:, None, :] & ((rows_c >= 0) & (rows_c < h))[:, :, None])
        n_band += int(band.sum())
        n_core += int(core.sum())
        n_cell += int(core.reshape(k, ps.CH, ps.CELL, ps.CW, ps.CELL)
                      .any(4).any(2).sum())
        for rows, m in ((rows_b, band), (rows_c, core)):
            idx = (lay[:, None, None] * (h * w)
                   + rows.clamp(0, h - 1)[:, :, None] * w
                   + cols.clamp(0, w - 1)[:, None, :])
            needed[idx[m]] = True
    return n_band, n_core, n_cell, int(needed.sum())


def ori_desc_bars(torch, ps, a_k, r_k, a_p, r_p, meta):
    """Invalid slots all zero, everything finite; returns, over the valid
    slots in slot order, their indices, the angle difference (rad), the
    descriptor cosine, the mask of those inside angle < 1e-3 rad &
    cos > 0.9999, and the max |desc err| on those."""
    valid = meta[:, 3] >= 0
    inv = ~valid
    if not (torch.all(a_k[inv] == 0) and torch.all(r_k[inv] == 0)):
        fail("ori_desc: invalid slots are not zero")
    if not (torch.isfinite(a_k).all() and torch.isfinite(r_k).all()):
        fail("ori_desc: non-finite output")
    d_k = ps.normalize_descriptors(r_k)[valid]
    d_p = ps.normalize_descriptors(r_p)[valid]
    da = (a_k[valid] - a_p[valid]).abs()
    da = torch.minimum(da, 2 * math.pi - da)
    cos = (d_k * d_p).sum(1) / torch.clamp(
        d_k.norm(dim=1) * d_p.norm(dim=1), min=1e-9)
    # a support with no gradient (a blank corner of a warped photo) gives
    # the zero descriptor on both sides: equal, so a cosine of 1
    both_zero = (d_k.abs().amax(1) == 0) & (d_p.abs().amax(1) == 0)
    cos = torch.where(both_zero, torch.ones_like(cos), cos)
    good = (da < 1e-3) & (cos > 0.9999)
    err = float((d_k[good] - d_p[good]).abs().max()) if good.any() else 0.0
    return dict(slots=torch.nonzero(valid)[:, 0], da=da, cos=cos, good=good,
                err=err, n_zero=int(both_zero.sum()))


def ori_desc_misses(torch, ps, dxs, dys, meta, hp, fb, a_k, bars, uncached,
                    show=12):
    """Prints every valid slot outside the bars with what explains it: the
    plain version's smoothed histogram's two highest peaks, their relative
    gap, and whether the kernel's angle sits at the second peak (an
    argmax near-tie that the two summation orders break differently)."""
    bad = torch.nonzero(~bars["good"])[:, 0]
    if bad.numel() == 0:
        return
    slots = bars["slots"][bad]
    _, h, w = dxs.shape
    hist = ps._band_histogram(dxs.reshape(-1), dys.reshape(-1), meta[slots],
                              hp, fb, h, w)
    peak = (hist >= hist.roll(1, 1)) & (hist >= hist.roll(-1, 1))
    top = torch.where(peak, hist, torch.full_like(hist, -1.0)).topk(2, dim=1)
    gap = (top.values[:, 0] - top.values[:, 1]) / top.values[:, 0].clamp(
        min=1e-30)
    bins = (a_k[slots] / (2 * math.pi) + 0.5) * ps.ORI_BINS
    off = (bins - top.indices[:, 1]).remainder(ps.ORI_BINS)
    second = torch.minimum(off, ps.ORI_BINS - off) <= 1.0
    scl = meta[slots, 2].float() / 1024
    ns = int(second.sum())
    print(f"  {bad.numel()} slots outside the bars: {ns} with the kernel's "
          f"angle at the plain histogram's second peak (peaks within "
          f"{float(gap[second].max()) if ns else 0.0:.2e} relative), "
          f"{int(uncached[bad].sum())} on the uncached path")
    for i in range(min(show, bad.numel())):
        print(f"    slot {int(slots[i])}: scl {float(scl[i]):.3f}, "
              f"{'uncached' if bool(uncached[bad[i]]) else 'cached'}, angle "
              f"diff {float(bars['da'][bad[i]]):.3e} rad, cos "
              f"{float(bars['cos'][bad[i]]):.6f}, peaks within "
              f"{float(gap[i]):.2e}, at the second peak {bool(second[i])}")


def kernel_boxes_and_list(torch, ps, dxs, dys, meta, hp, fb):
    """One launch into outputs filled with NaN and a marked work buffer:
    every slot must be written, the device's valid-slot list must hold
    exactly `nonzero(meta[:, 3] >= 0)`, and the kernel's support boxes
    must equal `support_boxes` (the crop the CPU tests check). Returns
    the valid slots' boxes."""
    K = meta.shape[0]
    _, h, w = dxs.shape
    dev = dxs.device
    valid = meta[:, 3] >= 0
    boxes = torch.zeros(K, 4, dtype=torch.int32, device=dev)
    work = torch.full((K + 2,), -7, dtype=torch.int32, device=dev)
    a = torch.full((K,), float("nan"), device=dev)
    r = torch.full((K, 16, 8), float("nan"), device=dev)
    ps.launch_kernel(dxs, dys, meta, hp, fb, a, r, work, boxes)
    ref = torch.nonzero(valid)[:, 0].to(torch.int32)
    n = int(work[0])
    if n != ref.numel() or not torch.equal(
            torch.sort(work[2:2 + n]).values, ref):
        fail(f"ori_desc: the device's slot list ({n} entries) is not the "
             f"{ref.numel()} valid slots")
    if not (torch.isfinite(a).all() and torch.isfinite(r).all()):
        fail("ori_desc: the kernel left a slot's output unwritten")
    if not (torch.all(a[~valid] == 0) and torch.all(r[~valid] == 0)):
        fail("ori_desc: an invalid slot's output is not zero")
    if not torch.equal(boxes[valid], ps.support_boxes(meta, hp, fb, h, w)[valid]):
        fail("ori_desc: the kernel's support boxes differ from support_boxes")
    return boxes[valid]


def stress_meta(torch, ps, dxs, n, seed):
    """n all-valid slots on the (L, h, w) stack `dxs`: keypoints anywhere
    in the image, the four corners and the edge midpoints among them,
    scales across the detector's range (1.6 * 2**(ls/3), ls in
    [0.5, 3.5]) and 16 at 5 px, beyond it (their support boxes exceed the
    kernel's cache on large octaves), layers 1..3 of random images."""
    from tpu3drec_torch.ops.sift import N_LAYERS
    L, h, w = dxs.shape
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, w - 1, n)
    ys = rng.uniform(0, h - 1, n)
    edge_x = [0, w - 1, 0, w - 1, (w - 1) / 2, (w - 1) / 2, 0, w - 1]
    edge_y = [0, 0, h - 1, h - 1, 0, h - 1, (h - 1) / 2, (h - 1) / 2]
    xs[:8], ys[:8] = edge_x, edge_y
    scl = 1.6 * 2 ** (rng.uniform(0.5, 3.5, n) / 3)
    scl[:8] = 1.6 * 2 ** (3.5 / 3)
    scl[8:24] = 5.0
    S = N_LAYERS + 3                        # stack layers per image
    layer = rng.integers(0, L // S, n) * S + rng.integers(1, 4, n)
    dev = dxs.device
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)
    return ps.prep_meta(t(xs, torch.float32), t(ys, torch.float32),
                        t(layer, torch.int32), t(scl, torch.float32),
                        torch.ones(n, dtype=torch.bool, device=dev),
                        *ps.pad_dims(h, w))


def empty_slot_ms(torch, n_images=2 * BATCH, caps=(640, 320, 160, 80, 64)):
    """ms of one `ori_desc` call at each of the main path's octave shapes
    (n_images images of 6 stack layers, the detector's slot caps) when no
    slot holds a keypoint: what the route costs before any keypoint.
    It calls only `ori_desc`'s public signature, so it also times another
    tree's kernel when that tree's package is the one imported."""
    from tpu3drec_torch.ops import pallas_sample as ps
    out = []
    for o, cap in enumerate(caps):
        h, w = H >> o, W >> o
        dxs = torch.zeros(n_images * 6, h, w, dtype=torch.bfloat16,
                          device="cuda")
        meta = torch.zeros(n_images * cap, 4, dtype=torch.int32,
                           device="cuda")
        meta[:, 3] = -1
        hp, wp = ps.pad_dims(h, w)
        out.append(cuda_ms(torch, lambda: ps.ori_desc(
            dxs, dxs, meta, hp, ps.frac_bits(hp, wp)), reps=10))
        del dxs, meta
    return out


def device_ms_by_kernel(torch, fn):
    """Device ms of each kernel and memset, by name, in one profiled call
    of `fn` after a warm-up call. The profiler lists the kernels that the
    ctypes libraries launch (no host op owns them)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            out[ev.key] = out.get(ev.key, 0.0) + _device_us(ev, True) / 1e3
    return out


def ms_of(by_kernel, part):
    """Summed ms of the entries of `device_ms_by_kernel` whose name holds
    `part`, or None when the profiler recorded none."""
    ms = [v for k, v in by_kernel.items() if part in k]
    return sum(ms) if ms else None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.3f} ms"


def ori_desc_octaves(torch, ps, samples, profile=True):
    """Each octave's `ori_desc` launch held against the plain version:
    two launches bit-identical, the oracle bars on every valid slot,
    every slot written, the device's slot list and support boxes; each
    octave timed (CUDA events; with `profile`, its kernels' device time
    from one profiled call) and its work counted from its own data.
    Returns the sums over the octaves."""
    t = dict(n_valid=0, n_bad=0, max_err=0.0, ms=0.0, plain_ms=0.0,
             bytes=0.0, ops=0.0, work=[0, 0, 0, 0], box_px=[],
             parts={"ori_desc_kernel": 0.0, "list_slots_kernel": 0.0,
                    "Memset": 0.0})
    for oc in samples:
        args = (oc.dxs, oc.dys, oc.meta, oc.hp, oc.fb)
        a_k, r_k = ps.ori_desc(*args)
        a_k2, r_k2 = ps.ori_desc(*args)
        a_p, r_p = ps.ori_desc_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(a_k, a_k2) and torch.equal(r_k, r_k2)):
            fail(f"ori_desc: two launches differ on octave {oc.octave}")
        bars = ori_desc_bars(torch, ps, a_k, r_k, a_p, r_p, oc.meta)
        nv = bars["slots"].numel()
        t["n_valid"] += nv
        t["n_bad"] += nv - int(bars["good"].sum())
        t["max_err"] = max(t["max_err"], bars["err"])
        box = kernel_boxes_and_list(torch, ps, *args)
        area = (box[:, 1] - box[:, 0]) * (box[:, 3] - box[:, 2])
        t["box_px"].append(int(area.max()) if nv else 0)
        ori_desc_misses(torch, ps, *args, a_k, bars, area > ps.CACHE_PX)
        t["ms"] += cuda_ms(torch, lambda: ps.ori_desc(*args))
        parts = t["parts"]
        by_kernel = (device_ms_by_kernel(torch, lambda: ps.ori_desc(*args))
                     if profile else {})
        for name in parts:
            if parts[name] is not None:
                got = ms_of(by_kernel, name)
                parts[name] = None if got is None else parts[name] + got
        t["plain_ms"] += cuda_ms(torch, lambda: ps.ori_desc_plain(*args), reps=1)
        n_band, n_core, n_cell, n_px = ori_desc_work(torch, oc, a_p)
        t["work"] = [a + b for a, b in
                     zip(t["work"], (n_band, n_core, n_cell, n_px))]
        K = oc.meta.shape[0]
        # meta in, angle and raw out for every slot; each needed pixel of
        # both bf16 stacks read once
        t["bytes"] += K * (16 + 4 + 128 * 4) + n_px * 2 * 2
        # ~20 flops per band pixel in the mask (offsets, weight, magnitude,
        # atan2, two bins), ~45 per core pixel in the support (rotation,
        # weight, magnitude, atan2, 8 tents), 3 per (cell, output) for the
        # <= 4 spatial bins x 8 orientations a cell feeds, and ~700 per
        # slot for the two smoothings and the peak
        t["ops"] += n_band * 20 + n_core * 45 + n_cell * 32 * 3 + nv * 700
    t_bytes = t["bytes"] / PEAK_BYTES_PER_S * 1e3
    t_ops = t["ops"] / PEAK_F32_OPS * 1e3
    t["bound_ms"] = max(t_bytes, t_ops)
    t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    t["frac_bad"] = t["n_bad"] / max(t["n_valid"], 1)
    return t


def check_ori_desc(torch, samples):
    """ori_desc kernel vs plain on every octave, and on an all-valid
    stress meta at the octave-0 and octave-4 shapes; every launch twice,
    bit-identical; the device's slot list checked on the path's (mixed),
    the stress (all valid) and an all-invalid meta. Returns the kernel
    line fields (time and bound summed over the octaves of one call)."""
    from tpu3drec_torch.ops import pallas_sample as ps
    t = ori_desc_octaves(torch, ps, samples)
    n_valid, n_bad, max_err = t["n_valid"], t["n_bad"], t["max_err"]
    ms, plain_ms, parts, work = t["ms"], t["plain_ms"], t["parts"], t["work"]
    bytes_, ops, box_px = t["bytes"], t["ops"], t["box_px"]
    frac_bad = n_bad / max(n_valid, 1)
    print(f"ori_desc vs plain: {n_valid} valid slots over {len(samples)} "
          f"octaves; {n_bad} outside angle<1e-3 rad & cos>0.9999 "
          f"({100 * frac_bad:.3f}%, bar <= 0.5%); max |desc err| on the rest "
          f"{max_err:.3e}; two launches bit-identical; every slot written; "
          f"the device's slot list is the valid slots; the kernel's support "
          f"boxes equal support_boxes; largest {max(box_px)} px (cache "
          f"{ps.CACHE_PX})")
    print(f"ori_desc: {ms:.3f} ms per pair-step call (5 octaves, CUDA "
          f"events); device time in one profiled call per octave: main "
          f"kernel {fmt_ms(parts['ori_desc_kernel'])}, slot listing "
          f"{fmt_ms(parts['list_slots_kernel'])}, counter memset "
          f"{fmt_ms(parts['Memset'])}; plain {plain_ms:.3f} ms")
    print(f"ori_desc work this run needs: {work[0]} band px in the mask, "
          f"{work[1]} core px in the support, {work[2]} cells, {work[3]} "
          f"distinct stack px; {bytes_ / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP")
    if n_valid == 0 or frac_bad > 0.005:
        fail("ori_desc disagrees with its plain version")

    # the compaction and the crop at full occupancy, borders included; the
    # last case crops the smallest octave to an odd width (scalar loads).
    # Slots whose box exceeds the cache take the uncached path: none of
    # them may miss the bars.
    first, last = samples[0], samples[-1]
    for dxs, dys in ((first.dxs, first.dys), (last.dxs, last.dys),
                     (last.dxs[..., :-1].contiguous(),
                      last.dys[..., :-1].contiguous())):
        _, h, w = dxs.shape
        hp, wp = ps.pad_dims(h, w)
        meta = stress_meta(torch, ps, dxs, 16384, SEED + w)
        args = (dxs, dys, meta, hp, ps.frac_bits(hp, wp))
        a_k, r_k = ps.ori_desc(*args)
        a_k2, r_k2 = ps.ori_desc(*args)
        a_p, r_p = ps.ori_desc_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(a_k, a_k2) and torch.equal(r_k, r_k2)):
            fail("ori_desc: two launches differ on the stress meta")
        bars = ori_desc_bars(torch, ps, a_k, r_k, a_p, r_p, meta)
        box = kernel_boxes_and_list(torch, ps, *args)
        uncached = (box[:, 1] - box[:, 0]) * (box[:, 3] - box[:, 2]) > ps.CACHE_PX
        nv = bars["slots"].numel()
        nb = nv - int(bars["good"].sum())
        nu = int(uncached.sum())
        nbu = int((uncached & ~bars["good"]).sum())
        print(f"ori_desc stress, all {nv} slots valid on stacks "
              f"{tuple(dxs.shape)}: {nb} outside the bars "
              f"({100 * nb / nv:.3f}%, bar <= 0.5%), of them {nbu} of the "
              f"{nu} slots on the uncached path (bar 0); {bars['n_zero']} "
              f"slots with no gradient in their support, zero on both "
              f"sides; max |desc err| {bars['err']:.3e}; two launches "
              f"bit-identical")
        ori_desc_misses(torch, ps, *args, a_k, bars, uncached)
        if nb > 0.005 * nv or nbu > 0:
            fail("ori_desc disagrees with its plain version on the stress meta")
    meta[:, 3] = -1
    kernel_boxes_and_list(torch, ps, *args)
    print("ori_desc, all 16384 slots invalid: every slot written with "
          "zeros, the device's slot list empty")

    empty = empty_slot_ms(torch)
    print(f"ori_desc with every slot empty, at the 5 octave shapes: "
          f"{sum(empty):.4f} ms per pair-step call ("
          + " + ".join(f"{t:.4f}" for t in empty) + ")")

    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                library_ms=None)


# knn2 beyond the main path's input, each held bit for bit against the
# plain version: (label, metric, pairs, N, M, D, masks). Masks: "scattered"
# (random, about 30% valid, so the device list is not a prefix),
# "duplicates" (exact copies of valid columns, rows of A equal to them:
# value ties), "edge" (pair 0 no valid column, pair 1 one in the middle,
# pair 2 only column 0, pair 3 scattered), "wide_norms" (scattered; pair 1's
# norms raised by 2**24, too wide for the kernel's packed (value, column)
# keys, so it takes the other fold)
KNN2_CASES = [
    ("scattered masks", "l2_int8", 8, 2048, 2048, 128, "scattered"),
    ("duplicate columns", "l2_int8", 4, 512, 640, 128, "duplicates"),
    ("no / one valid column", "l2_int8", 4, 256, 300, 128, "edge"),
    ("N, M on no tile", "l2_int8", 3, 1000, 777, 128, "scattered"),
    ("D 64", "l2_int8", 2, 300, 500, 64, "scattered"),
    ("D 100, padded to 128", "l2_int8", 2, 300, 500, 100, "scattered"),
    ("D 1024", "l2_int8", 2, 300, 500, 1024, "scattered"),
    ("hamming_pm1, D 256", "hamming_pm1", 4, 1024, 1024, 256, "scattered"),
    ("norms past the packed range", "l2_int8", 2, 300, 500, 128, "wide_norms"),
]
# the full-occupancy stress input: the path's shape, every column valid
KNN2_FULL = (BATCH, MAX_FEATURES, MAX_FEATURES, 128)


def sift_like_int8(torch, shape, gen):
    """Quantised SIFT-like descriptors: 0..255 values, mostly small (an
    exponential of mean 30, clipped), shifted by -128 to int8 as
    `quantize_u8` does."""
    u = torch.rand(shape, generator=gen, device=gen.device).clamp_(min=1e-12)
    return ((-30.0 * torch.log(u)).round_().clamp_(0, 255) - 128).to(torch.int8)


def knn2_operands(torch, metric, B, N, M, D, masks, seed, dev="cuda"):
    """(a, b, bnorm, mask2) on `dev`. Half of B's columns are noisy copies
    of rows of A, so rows have real nearest neighbours."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if metric == "hamming_pm1":
        a = (torch.randint(0, 2, (B, N, D), generator=gen, device=dev)
             * 2 - 1).to(torch.int8)
        b = (torch.randint(0, 2, (B, M, D), generator=gen, device=dev)
             * 2 - 1).to(torch.int8)
    else:
        a = sift_like_int8(torch, (B, N, D), gen)
        b = sift_like_int8(torch, (B, M, D), gen)
        k = min(N, M // 2)
        src = torch.randint(0, N, (B, k), generator=gen, device=dev)
        noise = torch.randint(-3, 4, (B, k, D), generator=gen, device=dev)
        rows = a.gather(1, src[..., None].expand(B, k, D)).to(torch.int32)
        b[:, :k] = (rows + noise).clamp_(-128, 127).to(torch.int8)
    if masks == "all":
        m2 = torch.ones(B, M, dtype=torch.bool, device=dev)
    else:
        m2 = torch.rand(B, M, generator=gen, device=dev) < 0.3
    if masks == "duplicates":
        # columns 100.. copied to 300.. and 301.. (every 2nd); rows 0..31
        # of A equal to columns 100..131
        b[:, 300:364:2] = b[:, 100:132]
        b[:, 301:365:2] = b[:, 100:132]
        m2[:, 100:132] = m2[:, 300:365] = True
        a[:, :32] = b[:, 100:132]
    elif masks == "edge":
        m2[:3] = False
        m2[1, M // 2] = True
        m2[2, 0] = True
    if metric == "hamming_pm1":
        n2 = torch.zeros(B, M, dtype=torch.int32, device=dev)
    else:
        n2 = b.to(torch.int32).square().sum(-1, dtype=torch.int32)
    if masks == "wide_norms":
        n2[1] += 1 << 24
    return a, b, n2, m2


def knn2_equal(torch, pm, a, b, n2, m2, label):
    """Kernel vs plain, indices and raw values on every row, bit for bit;
    a second launch bit-identical."""
    i_k, v_k = pm.knn2_raw(a, b, n2, m2)
    i_k2, v_k2 = pm.knn2_raw(a, b, n2, m2)
    i_p, v_p = pm.knn2_plain(a, b, n2, m2)
    torch.cuda.synchronize()
    if not (torch.equal(i_k, i_k2) and torch.equal(v_k, v_k2)):
        fail(f"knn2: two launches differ at {label}")
    if not (torch.equal(i_k, i_p) and torch.equal(v_k, v_p)):
        bad = int(((i_k != i_p) | (v_k != v_p)).any(-1).sum())
        fail(f"knn2 int8: {bad} rows differ from the plain version at {label}")
    return float((v_k.double() - v_p.double()).abs().max())


def knn2_bound(a, b, m2):
    """(bound ms, bound_by): A, each valid column of B and its norm read
    once, the mask read once, the top-2 written once; the products of
    every row with every valid column on the int8 tensor cores."""
    Bp, N, D = a.shape
    M = b.shape[1]
    m_valid = int(m2.sum())
    bytes_ = Bp * N * D + m_valid * (D + 4) + Bp * M + Bp * N * 2 * 8
    ops = 2.0 * N * m_valid * D
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def knn2_library(torch, a, b, n2, m2):
    """The two yardsticks as functions of no argument: (f32 matmul + topk,
    (bf16 tensor-core GEMM + topk, its form)). int8 values are exact in
    bf16 and float32 sums of D <= 1024 of their products stay below 2**24,
    so both compute the same dot products exactly."""
    af, bf = a.to(torch.float32), b.to(torch.float32).transpose(1, 2)
    ah, bh = a.to(torch.bfloat16), b.to(torch.bfloat16).transpose(1, 2)
    keep = m2[:, None, :]

    def top2(dot):
        d = n2[:, None, :] - 2 * dot
        d = torch.where(keep, d, torch.full_like(d, 3.4e38))
        return torch.topk(d, 2, dim=-1, largest=False)

    def f32():
        return top2(torch.matmul(af, bf))

    try:
        torch.bmm(ah[:1, :8], bh[:1, :, :8], out_dtype=torch.float32)

        def bf16():
            return top2(torch.bmm(ah, bh, out_dtype=torch.float32))
        form = "torch.bmm(bf16, bf16, out_dtype=torch.float32) + topk"
    except (TypeError, RuntimeError):
        def bf16():
            return top2(torch.stack([torch._int_mm(a[i], b[i].t())
                                     for i in range(a.shape[0])]).float())
        form = ("torch._int_mm per pair + topk (this torch's bmm has no "
                "out_dtype)")
    return f32, (bf16, form)


def knn2_times(torch, pm, a, b, n2, m2, label, reps=REPS):
    """ms of the kernel route and, from one profiled call, of its listing
    and main kernels; ms of both yardsticks; the bound. Prints one line."""
    ms = cuda_ms(torch, lambda: pm.knn2_raw(a, b, n2, m2), reps=reps)
    by_kernel = device_ms_by_kernel(torch, lambda: pm.knn2_raw(a, b, n2, m2))
    f32, (bf16, form) = knn2_library(torch, a, b, n2, m2)
    f32_ms = cuda_ms(torch, f32, reps=2)
    bf16_ms = cuda_ms(torch, bf16, reps=2)
    bound, by = knn2_bound(a, b, m2)
    parts = {}
    for key, v in by_kernel.items():
        name = re.search(r"knn2_\w+", key)
        name = name.group() if name else key[:40]
        parts[name] = parts.get(name, 0.0) + v
    kernel_ms = ms_of(parts, "knn2")
    print(f"knn2 at {label} ({int(m2.sum())} of {m2.numel()} columns valid): "
          f"{ms:.4f} ms per call (CUDA events); device ms in one profiled "
          f"call: " + (", ".join(f"{k} {v:.4f}" for k, v in sorted(parts.items()))
                       or "not measured (the profiler recorded no kernel)")
          + f"; bound {bound:.4f} ms ({by}); f32 matmul + topk {f32_ms:.3f} "
          f"ms; {form} {bf16_ms:.3f} ms")
    return dict(ms=ms, kernel_ms=kernel_ms, bound_ms=bound, bound_by=by,
                library_ms=f32_ms, library_bf16_ms=bf16_ms)


def check_knn2(torch, desc, mask, B):
    """knn2 kernel vs plain: int8 bit for bit (indices and raw values on
    every row, two launches identical) on all B pairs of the path, on the
    full-occupancy stress input and on `KNN2_CASES`; float32 on two pairs
    (indices equal except near-ties, values within 1e-4). Times the path's
    input and the stress input."""
    from tpu3drec_torch.ops import match as mt
    from tpu3drec_torch.ops import pallas_match as pm
    q = mt.quantize_u8(desc)
    a, b = q[:B].contiguous(), q[B:].contiguous()
    n2 = b.to(torch.int32).square().sum(-1, dtype=torch.int32)
    m2 = mask[B:].contiguous()
    max_err = knn2_equal(torch, pm, a, b, n2, m2, "the path's input")
    print(f"knn2 int8 vs plain at {tuple(a.shape)} x {tuple(b.shape)}: "
          f"indices and squared distances bit-equal on every row (max |err| "
          f"{max_err}); two launches bit-identical")
    full = knn2_operands(torch, "l2_int8", *KNN2_FULL, "all", SEED + 11)
    knn2_equal(torch, pm, *full, "full occupancy")
    for i, (label, metric, *shape) in enumerate(KNN2_CASES):
        knn2_equal(torch, pm, *knn2_operands(torch, metric, *shape, SEED + i),
                   label)
    print(f"knn2 int8 vs plain, bit-equal on every row and bit-identical "
          f"twice: full occupancy {KNN2_FULL}; "
          + "; ".join(f"{c[0]} {tuple(c[2:6])}" for c in KNN2_CASES))

    f1, f2 = desc[:2].contiguous(), desc[B:B + 2].contiguous()
    sq2 = (f2 * f2).sum(-1)
    mf = mask[B:B + 2].contiguous()
    fi_k, fv_k = pm.knn2_raw(f1, f2, sq2, mf)
    fi_p, fv_p = pm.knn2_plain(f1, f2, sq2, mf)
    sq1 = (f1 * f1).sum(-1)[..., None]
    dk = torch.sqrt(torch.clamp(fv_k + sq1, min=0))
    dp = torch.sqrt(torch.clamp(fv_p + sq1, min=0))
    if not torch.allclose(dk, dp, rtol=1e-4, atol=1e-4):
        fail("knn2 f32: distances differ from the plain version")
    # padded (all-zero) rows of desc1 tie exactly: judge valid rows only
    gap = dp[..., 1] - dp[..., 0]
    clear = (gap > 1e-4 * dp[..., 1] + 1e-4) & mask[:2]
    if not torch.equal(fi_k[..., 0][clear], fi_p[..., 0][clear]):
        fail("knn2 f32: best indices differ away from near-ties")
    print(f"knn2 f32 vs plain at {tuple(f1.shape)}: distances within rtol/atol "
          f"1e-4; best indices equal on all {int(clear.sum())} valid rows "
          f"without a near-tie (of {int(mask[:2].sum())} valid rows)")

    path = knn2_times(torch, pm, a, b, n2, m2, "the path's input")
    plain_ms = cuda_ms(torch, lambda: pm.knn2_plain(a, b, n2, m2), reps=2)
    stress = knn2_times(torch, pm, *full, f"full occupancy {KNN2_FULL}")
    del full
    return dict(max_abs_err=max_err, ms=path["ms"], plain_ms=plain_ms,
                bound_ms=path["bound_ms"], bound_by=path["bound_by"],
                library_ms=path["library_ms"],
                library_bf16_ms=path["library_bf16_ms"],
                kernel_ms=path["kernel_ms"], full_kernel_ms=stress["kernel_ms"],
                full_ms=stress["ms"], full_bound_ms=stress["bound_ms"],
                full_bound_by=stress["bound_by"],
                full_library_ms=stress["library_ms"],
                full_library_bf16_ms=stress["library_bf16_ms"])


def _device_us(ev, self_only):
    name = "self_device_time_total" if self_only else "device_time_total"
    us = getattr(ev, name, None)
    if us is None:
        us = getattr(ev, name.replace("device", "cuda"), 0)
    return us


def profile_call(torch, fn, prefix, top=12):
    """One profiled call (torch.profiler): its wall time, the summed device
    time of its kernels and so the device's busy share of that same call,
    the stage ranges whose names start with `prefix`, and device time by
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rows, stages = [], []
    for ev in prof.key_averages():
        on_device = str(getattr(ev, "device_type", "")).endswith("CUDA")
        if ev.key.startswith(prefix):
            # a host range: host span, and the device time of the kernels
            # launched inside it; a device-side range: its span there
            stages.append((ev.key, "device span" if on_device else "host range",
                           ev.cpu_time_total / 1e3,
                           _device_us(ev, on_device) / 1e3))
            continue
        if not on_device:
            continue        # host-side ops; their kernels are listed apart
        us = _device_us(ev, True)
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    if not rows:
        print("profiler: no device time recorded")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profiled call: {wall:.1f} ms wall, {busy:.1f} ms summed kernel "
          f"time ({100 * busy / wall:.1f}% busy, {wall - busy:.1f} ms idle, "
          f"this call under the profiler)")
    for key, kind, host_ms, dev_ms in sorted(stages):
        print(f"  stage {key} ({kind}): host {host_ms:.3f} ms, device "
              f"{dev_ms:.3f} ms")
    print("top device time by kernel:")
    for ms, n, name in rows[:top]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {name[:100]}")


# (B, D, H, W) beyond the main path's: D across the kernel's register
# tiers, one and three volumes, odd and ragged H and W
SGM_SHAPES = [(1, 16, 97, 131), (3, 48, 61, 203), (1, 100, 45, 77),
              (3, 128, 33, 67), (2, 64, 17, 5), (3, 64, 481, 641)]


def sgm_equal(torch, psg, vols, label):
    """Kernel route vs plain: bit-equal, and bit-identical on a second
    launch; returns the max |difference| (0.0)."""
    got = psg.sgm_aggregate_batch(vols)
    again = psg.sgm_aggregate_batch(vols)
    ref = psg.sgm_aggregate_batch_plain(vols)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"sgm: non-finite output at {label}")
    if not torch.equal(got, again):
        fail(f"sgm: two launches differ at {label}")
    if not torch.equal(got, ref):
        fail(f"sgm: not bit-equal to its plain version at {label} (max "
             f"|err| {float((got - ref).abs().max())})")
    return float((got - ref).abs().max())


def check_sgm(torch, vols):
    """sgm kernel vs plain (torch.equal) on the main path's own volumes
    (B, D, H, W) and at SGM_SHAPES; returns the kernel line fields. `ms`
    is the whole CUDA route (output allocation and the one call, which
    enqueues the vertical and the horizontal kernel); each kernel's device
    time comes from one profiled call."""
    from tpu3drec_torch.ops import pallas_sgm as psg
    max_err = sgm_equal(torch, psg, vols, tuple(vols.shape))
    gen = torch.Generator(device=vols.device).manual_seed(SEED)
    for shape in SGM_SHAPES:
        v = torch.rand(shape, generator=gen, device=vols.device) * 2
        sgm_equal(torch, psg, v, shape)
    print(f"sgm vs plain: bit-equal (torch.equal) at {tuple(vols.shape)} and "
          f"at {SGM_SHAPES}; two launches bit-identical at each")
    ms = cuda_ms(torch, lambda: psg.sgm_aggregate_batch(vols))
    by_kernel = device_ms_by_kernel(
        torch, lambda: psg.sgm_aggregate_batch(vols))
    v_ms = ms_of(by_kernel, "sgm_v_kernel")
    h_ms = ms_of(by_kernel, "sgm_h_kernel")
    plain_ms = cuda_ms(torch, lambda: psg.sgm_aggregate_batch_plain(vols),
                       reps=1)
    n = vols.numel()
    # the volumes read once and the result written once, float32
    bytes_ = 2 * n * 4
    ops = SGM_FLOPS_PER_ELEMENT * n
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS * 1e3
    print(f"sgm: {ms:.3f} ms per call on the native layout, no layout copy "
          f"(CUDA events); device time in one profiled call: vertical "
          f"kernel {fmt_ms(v_ms)}, 5 volume passes, horizontal kernel "
          f"{fmt_ms(h_ms)}, 6 passes; "
          f"plain {plain_ms:.3f} ms; bound {bytes_ / 1e6:.1f} MB -> "
          f"{t_bytes:.4f} ms, {ops / 1e9:.2f} GFLOP -> {t_ops:.4f} ms; 11 "
          f"passes at {PEAK_BYTES_PER_S / 1e12} TB/s -> "
          f"{11 * n * 4 / PEAK_BYTES_PER_S * 1e3:.4f} ms")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def dense_folder(h, w, seed):
    """bench_dense's folder: one photo rolled by round(100 bx) px for each
    baseline bx, identity rotations, f = 600."""
    K = np.array([[DENSE_F, 0, w / 2], [0, DENSE_F, h / 2], [0, 0, 1]])
    base = synthetic_photo(h, w, seed)
    images, cams = {}, {}
    for i, bx in enumerate(DENSE_BX):
        name = f"v{i}.png"
        images[name] = np.roll(base, int(round(bx * 100)), axis=1)
        cams[name] = {"camera_matrix": K.tolist(),
                      "rotation": np.eye(3).tolist(),
                      "translation": [bx, 0.0, 0.0]}
    sparse = {"camera_poses": cams, "points_3d": [[0.0, 0.0, DENSE_DEPTH]]}
    return sparse, images, f"v{len(DENSE_BX) // 2}.png"


def stereo_inputs(torch, sparse, images, ref, device):
    """The arguments `run_complete_pipeline` hands
    `stereo_depth_pairs_fused` for this folder."""
    cams = sparse["camera_poses"]
    others = [n for n in cams if n != ref]
    K = np.asarray(cams[ref]["camera_matrix"], np.float32)
    t_ref = np.asarray(cams[ref]["translation"], np.float32)
    ts = np.stack([np.asarray(cams[n]["translation"], np.float32) - t_ref
                   for n in others])
    eye = np.stack([np.eye(3, dtype=np.float32)] * len(others))
    return (torch.tensor(images[ref], device=device),
            torch.tensor(np.stack([images[n] for n in others]), device=device),
            torch.tensor(K), torch.tensor(np.stack([K] * len(others))),
            torch.tensor(eye), torch.tensor(ts))


def capture_sgm_inputs(torch, args):
    """The volumes the fused stereo stage hands `sgm_aggregate_batch`,
    recorded during one call."""
    from tpu3drec_torch.ops import stereo as st
    seen = []
    real = st.sgm_aggregate_batch

    def recorder(volumes, *a, **kw):
        seen.append(volumes.clone())
        return real(volumes, *a, **kw)

    st.sgm_aggregate_batch = recorder
    try:
        st.stereo_depth_pairs_fused(*args, num_disparities=NUM_DISPARITIES)
    finally:
        st.sgm_aggregate_batch = real
    if len(seen) != 1:
        fail(f"expected one SGM call in the stereo stage, saw {len(seen)}")
    return seen[0]


def run_dense(torch, kind, dev):
    """Phase 4: the dense stage on the card; returns the sgm kernel line
    fields with this run's launches."""
    import tpu3drec_torch
    from tpu3drec_torch.ops import pallas_match as pm
    from tpu3drec_torch.ops import pallas_sample as ps
    from tpu3drec_torch.ops import pallas_sgm as psg
    from tpu3drec_torch.ops import stereo as st

    sparse, images, ref = dense_folder(H, W, SEED + 7)
    args = stereo_inputs(torch, sparse, images, ref, dev)
    fields = check_sgm(torch, capture_sgm_inputs(torch, args))

    pipe = tpu3drec_torch.DenseReconstructionPipeline(
        num_disparities=NUM_DISPARITIES, fusion_method="weighted",
        tsdf_resolution=TSDF_RESOLUTION)
    pipe.run_complete_pipeline(sparse, images, reference_view=ref)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(DENSE_REPS):
        if i == 0:
            reset_counts(pm, ps, psg)
        res = pipe.run_complete_pipeline(sparse, images, reference_view=ref)
        torch.cuda.synchronize()
        if i == 0:
            counts = kernel_counts(pm, ps, psg)
            fields["launches"] = counts["sgm"]
        runs.append(res["timings_s"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"launches in one dense run: sgm {fields['launches']}, ori_desc "
          f"{counts['ori_desc']}, knn2 {counts['knn2']}")
    if fields["launches"] == 0:
        fail("the dense path never launched the sgm kernel")
    mp = W * H * (len(DENSE_BX) - 1) / 1e6
    rates = sorted(mp / r["stereo"] for r in runs)
    print(f"dense stereo stage: {float(np.median(rates))} MP-depth/s "
          f"(median of {DENSE_REPS}, spread {rates[0]} .. {rates[-1]}; "
          f"{len(DENSE_BX) - 1} pairs of {W}x{H}, {NUM_DISPARITIES} "
          f"disparities) on {kind}; peak device memory {peak_gb:.2f} GB")
    for key in runs[0]:
        print(f"  stage {key}: " + ", ".join(f"{r[key]:.4f}" for r in runs)
              + " s")

    arr = pipe._arrays
    depth = arr["depth"]
    valid = depth > 0
    med = float(np.median(depth[valid])) if valid.any() else 0.0
    frac = res["depth"]["valid_fraction"]
    print(f"fused depth: valid fraction {frac:.4f} (bar > "
          f"{DENSE_VALID_BAR}), median {med:.5f} (plane at {DENSE_DEPTH}); "
          f"{res['point_cloud']['num_points']} points; mesh "
          f"{res['mesh']['method']} with {res['mesh']['num_faces']} faces")
    if not np.isfinite(depth).all() or depth.shape != (H, W) \
            or not np.isfinite(arr["points"]).all():
        fail("non-finite or misshapen dense output")
    if abs(med - DENSE_DEPTH) > 0.01 * DENSE_DEPTH or frac <= DENSE_VALID_BAR:
        fail("quality bar: the fused depth must be valid on more than "
             f"{DENSE_VALID_BAR} of the view with its median within 1% of "
             f"{DENSE_DEPTH}")
    if res["mesh"]["method"] != "tsdf" or res["mesh"]["num_faces"] <= 1000 \
            or res["point_cloud"]["num_points"] <= 10000:
        fail("quality bar: a TSDF mesh of > 1000 faces and > 10000 points")

    # the same stereo stage on the CPU, through the plain versions
    t0 = time.perf_counter()
    cpu = st.stereo_depth_pairs_fused(*(a.cpu() for a in args),
                                      num_disparities=NUM_DISPARITIES)
    cpu_s = time.perf_counter() - t0
    card = st.stereo_depth_pairs_fused(*args, num_disparities=NUM_DISPARITIES)
    dv, cv = card["fused_valid"].cpu().numpy(), cpu["fused_valid"].numpy()
    dd, cd = card["fused_depth"].cpu().numpy(), cpu["fused_depth"].numpy()
    agree = float((dv == cv).mean())
    both = dv & cv
    close = bool(np.allclose(dd[both], cd[both], rtol=1e-4, atol=1e-4))
    print(f"stereo stage, card vs CPU plain path ({cpu_s:.1f} s on the "
          f"CPU): valid masks agree on {100 * agree:.4f}% (bar > 99.9%), "
          f"CPU valid fraction {float(cv.mean()):.4f}, max |depth diff| "
          f"where both valid {float(np.abs(dd - cd)[both].max()):.3e} "
          f"(bar rtol/atol 1e-4)")
    if agree <= 0.999 or not close:
        fail("the card's stereo stage disagrees with the CPU plain path")

    print("profiled stereo stage (stereo_depth_pairs_fused + the host "
          "pull of its meta):")
    profile_call(torch, lambda: st.stereo_depth_pairs_fused(
        *args, num_disparities=NUM_DISPARITIES)["meta"].cpu(), "dense.")
    print("profiled pipeline call (run_complete_pipeline):")
    profile_call(torch, lambda: pipe.run_complete_pipeline(
        sparse, images, reference_view=ref), "dense.", top=6)
    return fields


def rot_err_deg(Ra, Rb):
    """Angle of Ra Rb^T in degrees, atan2(sin, cos) from its skew part and
    trace (arccos of the trace alone reads ~1e-3 rad between two equal
    float32 rotations)."""
    d = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    s = np.linalg.norm([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    return float(np.degrees(np.arctan2(s / 2, (np.trace(d) - 1) / 2)))


def sfm_K():
    return np.array([[SFM_F, 0, SFM_W / 2], [0, SFM_F, SFM_H / 2], [0, 0, 1]])


def corrupt(rng, uv, frac):
    """Moves a `frac` share of the rows of uv by 20-100 px each way;
    returns (uv, ground-truth inlier mask)."""
    n = len(uv)
    out = rng.permutation(n)[:int(round(frac * n))]
    uv = uv.copy()
    uv[out] += rng.uniform(20, 100, (len(out), 2)) \
        * np.sign(rng.standard_normal((len(out), 2)))
    gt = np.ones(n, bool)
    gt[out] = False
    return uv, gt


def two_view_scenes(seed):
    """SFM_PAIRS pairs of SFM_N correspondences: points at depth 6-12 seen
    by camera 1 = [I | 0] anywhere in its 640x480 view and by camera 2,
    rotated 0.1-0.3 rad about a random axis, unit baseline mostly along x;
    0.5 px noise, 20% outliers. Returns (p1, p2, R, t, gt inliers)."""
    from tpu3drec_torch.ops.lie import exp_so3_np
    rng = np.random.default_rng(seed)
    K = sfm_K()
    out = []
    for _ in range(SFM_PAIRS):
        ax = rng.normal(size=3)
        R = exp_so3_np(ax / np.linalg.norm(ax) * rng.uniform(0.1, 0.3))
        t = np.array([1.0, 0.0, 0.0]) + 0.2 * rng.normal(size=3)
        t /= np.linalg.norm(t)
        uv1 = rng.uniform([0, 0], [SFM_W, SFM_H], (SFM_N, 2))
        X = np.c_[uv1, np.ones(SFM_N)] @ np.linalg.inv(K).T \
            * rng.uniform(6, 12, (SFM_N, 1))
        x2 = (X @ R.T + t) @ K.T
        p1 = uv1 + SFM_NOISE * rng.standard_normal((SFM_N, 2))
        p2 = x2[:, :2] / x2[:, 2:] + SFM_NOISE * rng.standard_normal((SFM_N, 2))
        p2, gt = corrupt(rng, p2, SFM_OUTLIERS)
        out.append((p1, p2, R, t, gt))
    return [np.stack(a) for a in zip(*out)]


def pnp_scene(seed):
    """PNP_N world points at depth 6-12 in front of a camera rotated by
    ~0.35 rad; 0.5 px noise, 20% outliers. Returns (X, uv, R, t, gt)."""
    from tpu3drec_torch.ops.lie import exp_so3_np
    rng = np.random.default_rng(seed)
    K = sfm_K()
    R = exp_so3_np(np.array([0.1, -0.3, 0.05]))
    t = np.array([0.4, -0.2, 0.6])
    uv = rng.uniform([0, 0], [SFM_W, SFM_H], (PNP_N, 2))
    Xc = np.c_[uv, np.ones(PNP_N)] @ np.linalg.inv(K).T \
        * rng.uniform(6, 12, (PNP_N, 1))
    X = (Xc - t) @ R                                   # R^T (Xc - t)
    uv, gt = corrupt(rng, uv + SFM_NOISE * rng.standard_normal((PNP_N, 2)),
                     SFM_OUTLIERS)
    return X, uv, R, t, gt


def bench_ba_problem(seed):
    """bench.py:bench_ba's problem (50 cameras on an arc facing a cloud of
    100,000 points, 5 observations a point at random cameras, 0.5 px noise;
    cameras perturbed by 0.01 rad / 0.02, points by 0.05; the first camera
    and the second's tx frozen, intrinsics fixed), with the draws in
    bench_ba's order and the projection written out in numpy."""
    from tpu3drec_torch.ops.ba import make_cam_params
    from tpu3drec_torch.ops.lie import exp_so3_np
    rng = np.random.default_rng(seed)
    C, P = BA_CAMS, BA_PTS
    M = P * BA_OBS_PER_PT
    X = rng.uniform(-10, 10, (P, 3)) + np.array([0, 0, 30.0])
    K = np.array([[700, 0, 320], [0, 700, 240], [0, 0, 1]], np.float64)
    ang = (np.arange(C) / max(C - 1, 1) - 0.5) * 0.8
    rvec = np.stack([np.zeros(C), ang, np.zeros(C)], 1)
    R = exp_so3_np(rvec)
    center = np.stack([20 * np.sin(ang), 0.1 * np.arange(C),
                       30 - 20 * np.cos(ang)], 1)
    tvec = -np.einsum("cij,cj->ci", R, center)
    obs_pt = np.repeat(np.arange(P, dtype=np.int32), BA_OBS_PER_PT)
    obs_cam = rng.integers(0, C, M).astype(np.int32)
    Xc = np.einsum("mij,mj->mi", R[obs_cam], X[obs_pt]) + tvec[obs_cam]
    uv = (Xc[:, :2] / Xc[:, 2:] * 700.0 + [320.0, 240.0]).astype(np.float32)
    uv += 0.5 * rng.standard_normal((M, 2)).astype(np.float32)
    cams = np.stack([make_cam_params(r + 0.01 * rng.standard_normal(3),
                                     t + 0.02 * rng.standard_normal(3), K)
                     for r, t in zip(rvec, tvec)])
    pm = np.ones((C, 10), np.float32)
    pm[0] = 0.0
    pm[1, 3] = 0.0
    pm[:, 6:] = 0.0
    pts = X.astype(np.float32) \
        + 0.05 * rng.standard_normal(X.shape).astype(np.float32)
    return dict(cam_params=cams, points=pts, obs_cam=obs_cam, obs_pt=obs_pt,
                obs_uv=uv, param_mask=pm)


def small_ba_problem(C, seed):
    """The multichip dryrun's BA problem shape (`__graft_entry__.py`
    `_dryrun_ba_phase`: 400 points, 4 observations each at random cameras,
    f = 120, 0.3 px noise, cameras 2.. perturbed by 0.01 rad) with C
    cameras: 6 for the CG solver, 3 for the dense-Schur window."""
    from tpu3drec_torch.ops.ba import make_cam_params
    from tpu3drec_torch.ops.lie import exp_so3_np
    rng = np.random.default_rng(seed)
    Pn, OBS = 400, 4
    K = np.array([[120, 0, 64], [0, 120, 48], [0, 0, 1]], np.float32)
    X = rng.uniform(-2, 2, (Pn, 3)).astype(np.float32) \
        + np.array([0, 0, 8.0], np.float32)
    cam = np.stack([make_cam_params(np.array([0.0, 0.05 * c, 0.0]),
                                    np.array([0.4 * c - 1.0, 0.0, 0.0]), K)
                    for c in range(C)])
    obs_pt = np.repeat(np.arange(Pn, dtype=np.int32), OBS)
    obs_cam = rng.integers(0, C, obs_pt.shape[0]).astype(np.int32)
    Rs = exp_so3_np(cam[:, :3])
    Xc = np.einsum("mij,mj->mi", Rs[obs_cam], X[obs_pt]) + cam[obs_cam, 3:6]
    z = np.maximum(Xc[:, 2], 1e-6)
    uv = np.stack([Xc[:, 0] / z * K[0, 0] + K[0, 2],
                   Xc[:, 1] / z * K[1, 1] + K[1, 2]], 1)
    uv += 0.3 * rng.standard_normal(uv.shape).astype(np.float32)
    pm = np.ones((C, 10), np.float32)
    pm[0] = 0.0
    pm[1, 3] = 0.0
    pm[:, 6:] = 0.0
    cam[2:, :3] += 0.01 * rng.standard_normal((C - 2, 3)).astype(np.float32)
    return dict(cam_params=cam,
                points=X + 0.02 * rng.standard_normal(X.shape).astype(np.float32),
                obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=uv, param_mask=pm)


def two_view_chain(torch, tv, p1, p2, K, method, **draws):
    """find_essential -> recover_pose -> triangulate_two_view on a batch
    (B, N, 2) of pairs with one K."""
    e = tv.find_essential(p1, p2, K, method=method,
                          num_hypotheses=SFM_HYPOTHESES,
                          threshold_px=SFM_THRESHOLD_PX, **draws)
    R, t, _ = tv.recover_pose(e.E, p1, p2, K, mask=e.inliers)
    B = p1.shape[0]
    eye = torch.eye(3, device=p1.device).expand(B, 3, 3)
    tri = tv.triangulate_two_view(p1, p2, K, K, eye,
                                  torch.zeros(B, 3, device=p1.device), R, t,
                                  mask=e.inliers)
    return e, R, t, tri


def run_sfm(torch, card, dev):
    """Phase 5: SfM geometry and bundle adjustment on the card through the
    public functions, each against its bars and the CPU plain path."""
    import tpu3drec_torch as tv
    from tpu3drec_torch.ops import pallas_match as pm
    from tpu3drec_torch.ops import pallas_sample as ps
    from tpu3drec_torch.ops import pallas_sgm as psg
    from tpu3drec_torch.ops.epipolar import gumbel_subsample
    from tpu3drec_torch.ops.ransac import draw_uniform

    reset_counts(pm, ps, psg)
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    K = f32(sfm_K())

    # ---- (a) the two-view chain on a batch of SFM_PAIRS pairs
    p1n, p2n, Rgt, tgt, gt = two_view_scenes(SEED + 20)
    p1, p2 = f32(p1n), f32(p2n)
    times = {}
    for method in ("5point", "8point"):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        e, R, t, tri = two_view_chain(torch, tv, p1, p2, K, method,
                                      generator=gen)
        torch.cuda.synchronize()
        inl = e.inliers.cpu().numpy()
        Rn, tn = R.cpu().double().numpy(), t.cpu().double().numpy()
        rep = tri.reproj_err.cpu().numpy()
        tmask = tri.mask.cpu().numpy()
        for i in range(SFM_PAIRS):
            rerr = rot_err_deg(Rn[i], Rgt[i])
            terr = float(np.degrees(np.arccos(np.clip(
                abs(tn[i] @ tgt[i]) / np.linalg.norm(tn[i]), -1, 1))))
            tp_ = (inl[i] & gt[i]).sum()
            prec, rec = tp_ / max(inl[i].sum(), 1), tp_ / gt[i].sum()
            med = float(np.median(rep[i][tmask[i]])) if tmask[i].any() else np.inf
            print(f"two-view {method} pair {i}: rotation error {rerr:.4f} deg, "
                  f"translation direction {terr:.4f} deg, inlier precision "
                  f"{prec:.4f} recall {rec:.4f}, {int(tmask[i].sum())} points "
                  f"triangulated, median reprojection {med:.4f} px")
            if not (np.isfinite(Rn[i]).all() and np.isfinite(tn[i]).all()):
                fail(f"two-view {method}: non-finite pose on pair {i}")
            r_bar, t_bar, rec_bar = TWO_VIEW_BARS[method]
            if rerr >= r_bar or terr >= t_bar or prec <= 0.9 \
                    or rec <= rec_bar or med >= 1.0:
                fail(f"two-view {method} pair {i}: bars are rotation < "
                     f"{r_bar} deg, translation < {t_bar} deg, precision > "
                     f"0.9, recall > {rec_bar}, median triangulated "
                     f"reprojection < 1 px")
        times[method] = cuda_ms(torch, lambda: two_view_chain(
            torch, tv, p1, p2, K, method, generator=gen), reps=3)

    # ---- (b) PnP
    Xn, uvn, Rp, tp0, gtp = pnp_scene(SEED + 21)
    X, uv = f32(Xn), f32(uvn)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pnp = tv.solve_pnp_ransac(X, uv, K, num_hypotheses=PNP_HYPOTHESES,
                              threshold_px=4.0, generator=gen)
    torch.cuda.synchronize()
    prerr = rot_err_deg(pnp.R.cpu().numpy(), Rp)
    pinl = pnp.inliers.cpu().numpy()
    prec_ = (pinl & gtp).sum() / gtp.sum()
    print(f"PnP ({PNP_N} points, {PNP_HYPOTHESES} hypotheses, 4 px): rotation "
          f"error {prerr:.4f} deg, translation error "
          f"{float(np.linalg.norm(pnp.t.cpu().numpy() - tp0)):.5f}, inlier "
          f"recall {prec_:.4f}, {int(pnp.num_inliers)} inliers, mean "
          f"reprojection {float(pnp.mean_reproj_px):.4f} px, packed "
          f"{tuple(pnp.packed.shape)}")
    if not bool(pnp.success) or prerr >= 0.5 or prec_ <= 0.9:
        fail("PnP: bars are success, rotation < 0.5 deg, inlier recall > 0.9")
    times["pnp"] = cuda_ms(torch, lambda: tv.solve_pnp_ransac(
        X, uv, K, num_hypotheses=PNP_HYPOTHESES, threshold_px=4.0,
        generator=gen), reps=3)

    # ---- (c) iterative refinement of pair 0 from a focal 20% off
    size = (SFM_W, SFM_H)
    K0 = sfm_K()
    K0[0, 0] = K0[1, 1] = 1.2 * SFM_F
    refs = {}
    for where in (dev.type, "cpu"):
        t0 = time.perf_counter()
        refs[where] = tv.iterative_refinement(
            p1n[0].astype(np.float32), p2n[0].astype(np.float32), K0, K0,
            size, size, device=where,
            generator=torch.Generator().manual_seed(SEED))
        refs[where + "_s"] = time.perf_counter() - t0
    ref = refs[dev.type]
    if ref is None or refs["cpu"] is None:
        fail("iterative_refinement returned no model")
    f_err = max(abs(ref.K1[0, 0] - SFM_F), abs(ref.K2[0, 0] - SFM_F)) / SFM_F
    r_err = rot_err_deg(ref.R, Rgt[0])
    reproj = ref.history[-1].get("mean_reproj_px", np.inf)
    dk = max(np.abs(ref.K1 - refs["cpu"].K1).max() / SFM_F,
             np.abs(ref.K2 - refs["cpu"].K2).max() / SFM_F)
    dr = rot_err_deg(ref.R, refs["cpu"].R)
    print(f"iterative_refinement (pair 0, focal started at {1.2 * SFM_F}): "
          f"focals {ref.K1[0, 0]:.2f} / {ref.K2[0, 0]:.2f} (truth {SFM_F}, "
          f"{100 * f_err:.2f}% off; two-view focal is not observable with "
          f"free intrinsics, the reference keeps it near its start too), "
          f"rotation error {r_err:.4f} deg, last mean reprojection "
          f"{reproj:.4f} px, {int(ref.point_mask.sum())} points, "
          f"{len(ref.history)} rounds in {refs[dev.type + '_s']:.2f} s; vs the CPU "
          f"plain path ({refs['cpu_s']:.2f} s): K within {100 * dk:.4f}% of "
          f"f, R within {dr:.5f} deg")
    in_box = all(100 <= k[0, 0] <= 5000 and abs(k[0, 2] - SFM_W / 2)
                 <= SFM_W / 2 * 0.3 + 1e-6 for k in (ref.K1, ref.K2))
    if reproj >= 1.0 or r_err >= 3.0 or ref.point_mask.sum() <= 100 \
            or not in_box:
        fail("iterative_refinement: bars (the reference test's) are mean "
             "reprojection < 1 px, rotation < 3 deg, > 100 points, K in its box")
    if dk > 0.02 or dr > 0.2:
        fail("iterative_refinement disagrees with the CPU plain path "
             "(K within 2%, R within 0.2 deg)")

    # ---- (d) global BA at bench_ba's configuration
    cfg = tv.BAConfig(max_iters=10, schur_solver="cg")
    prob = tv.BAProblem.from_numpy(**bench_ba_problem(SEED), device=dev)
    res = tv.bundle_adjust(prob, cfg)                     # warm-up solve
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = tv.bundle_adjust(prob, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    iters = int(res.iterations)
    stats = res.stats.cpu().numpy()
    ba_ms = dt / max(iters, 1) * 1e3
    print(f"global BA ({BA_CAMS} cams, {BA_PTS} pts, "
          f"{BA_PTS * BA_OBS_PER_PT} obs, Schur-CG, max_iters 10): "
          f"{ba_ms:.3f} ms/LM-iter ({dt * 1e3:.1f} ms for {iters} "
          f"iterations, after one warm-up solve), mean reprojection "
          f"{stats[5]:.4f} -> {stats[3]:.4f} px, cost {stats[0]:.1f} -> "
          f"{stats[1]:.1f}, final lambda {stats[4]:.3e}; peak device memory "
          f"{peak_gb:.2f} GB; on {card}")
    if not (np.isfinite(stats).all() and torch.isfinite(res.points).all()):
        fail("global BA: non-finite result")
    if not stats[1] < stats[0] or stats[3] >= 0.6:
        fail("global BA: bars are cost_final < cost_initial and a final "
             "mean reprojection under 0.6 px")
    print("profiled global BA solve:")
    profile_call(torch, lambda: tv.bundle_adjust(prob, cfg), "sfm.", top=8)
    del prob, res

    launches = kernel_counts(pm, ps, psg)
    print(f"launches in the SfM phase: {launches} (no TPU kernel lies on "
          f"this path: the reference computes it in plain XLA)")

    # ---- (e) the card against the CPU plain path, with the same draws
    host = torch.Generator().manual_seed(SEED + 1)
    for method, s, hyp in (("5point", 5, max(SFM_HYPOTHESES // 10, 64)),
                           ("8point", 8, SFM_HYPOTHESES)):
        draws = dict(u=draw_uniform(hyp, s, host),
                     sub=gumbel_subsample(torch.ones(1, SFM_N, dtype=torch.bool),
                                          host)[0])
        (ec, Rc, _, trc), (eh, Rh, _, trh) = (
            two_view_chain(torch, tv, p1[:1].to(d), p2[:1].to(d), K.to(d),
                           method, **draws) for d in (dev, torch.device("cpu")))
        dn = abs(int(ec.num_inliers[0]) - int(eh.num_inliers[0]))
        dR = np.radians(rot_err_deg(Rc[0].cpu().numpy(), Rh[0].numpy()))
        dt_ = abs(int(trc.mask.sum()) - int(trh.mask.sum()))
        print(f"two-view {method}, pair 0, card vs CPU plain path (same "
              f"uniforms and subsample): inliers {int(ec.num_inliers[0])} vs "
              f"{int(eh.num_inliers[0])}, R within {dR:.2e} rad, triangulated "
              f"{int(trc.mask.sum())} vs {int(trh.mask.sum())}")
        tol = max(2, 0.01 * int(eh.num_inliers[0]))
        if dn > tol or dt_ > tol or dR > 1e-3:
            fail(f"two-view {method}: the card disagrees with the CPU plain "
                 f"path (inliers within max(2, 1%), R within 1e-3 rad)")
    u = draw_uniform(PNP_HYPOTHESES, 12, host)
    pc = tv.solve_pnp_ransac(X, uv, K, num_hypotheses=PNP_HYPOTHESES, u=u)
    ph = tv.solve_pnp_ransac(X.cpu(), uv.cpu(), K.cpu(),
                             num_hypotheses=PNP_HYPOTHESES, u=u)
    dn = abs(int(pc.num_inliers) - int(ph.num_inliers))
    dR = np.radians(rot_err_deg(pc.R.cpu().numpy(), ph.R.numpy()))
    print(f"PnP, card vs CPU plain path (same uniforms): inliers "
          f"{int(pc.num_inliers)} vs {int(ph.num_inliers)}, R within "
          f"{dR:.2e} rad")
    if dn > max(2, 0.01 * int(ph.num_inliers)) or dR > 1e-3:
        fail("PnP: the card disagrees with the CPU plain path")
    for label, C, cfg in (
            ("dryrun problem (6 cams / 400 pts / 1,600 obs, CG)", 6,
             tv.BAConfig(max_iters=3, schur_solver="cg", cg_iters=24, ftol=0.0)),
            # 6 iterations: later ones sit on the cost's float32 noise
            # floor, where another summation order (the card's chunked
            # segment sums) moves this window's cameras by ~1e-3
            ("3-camera window (dense Schur)", 3,
             tv.BAConfig(max_iters=6, schur_solver="dense"))):
        arrays = small_ba_problem(C, 11)
        rc = tv.bundle_adjust(tv.BAProblem.from_numpy(**arrays, device=dev), cfg)
        rh = tv.bundle_adjust(tv.BAProblem.from_numpy(**arrays, device="cpu"), cfg)
        dcam = float((rc.cam_params.cpu() - rh.cam_params).abs().max())
        dpx = abs(float(rc.mean_reproj_px) - float(rh.mean_reproj_px))
        print(f"BA {label}, card vs CPU plain path: cameras within {dcam:.2e} "
              f"(bar 5e-3), mean reprojection {float(rc.mean_reproj_px):.4f} "
              f"vs {float(rh.mean_reproj_px):.4f} px (bar 1e-2), iterations "
              f"{int(rc.iterations)} vs {int(rh.iterations)}")
        if dcam > 5e-3 or dpx > 1e-2 or not float(rc.cost_final) < float(rc.cost_initial):
            fail(f"BA {label}: the card disagrees with the CPU plain path")

    print(f"SfM phase on {card}: two-view chain (find_essential -> "
          f"recover_pose -> triangulate_two_view, {SFM_PAIRS} x {SFM_N}) "
          f"{times['5point']:.3f} ms per batch with 5point, "
          f"{times['8point']:.3f} ms with 8point; PnP {times['pnp']:.3f} ms "
          f"per call; global BA {ba_ms:.3f} ms/LM-iter (CUDA events over 3 "
          f"calls after a warm-up; BA by the host clock)")
    print("profiled two-view chain (5point):")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    profile_call(torch, lambda: two_view_chain(torch, tv, p1, p2, K, "5point",
                                               generator=gen), "sfm.", top=6)


def small_sfm_scene(n_views=5, n_pts=250, noise=0.4, seed=0):
    """tests/test_sfm_pipeline.py:make_scene's folder (cameras on an arc
    looking at a point cloud, consecutive-pair matches), its rotations
    from the port's Rodrigues. Returns (matches_data, image_info, views,
    names)."""
    from tpu3drec_torch.ops.lie import exp_so3_np
    rng = np.random.default_rng(seed)
    Wd, Hd = 640, 480
    K = np.array([[700, 0, Wd / 2], [0, 700, Hd / 2], [0, 0, 1]], np.float64)
    X = rng.uniform(-4, 4, size=(n_pts, 3)) + np.array([0, 0, 12.0])
    views = []
    for i in range(n_views):
        ang = (i - n_views / 2) * 0.12
        R = exp_so3_np(np.array([0.0, ang, 0.0]))
        c = np.array([6 * np.sin(ang), 0.2 * i, 12 - 6 * np.cos(ang) + 0.0])
        views.append((R, -R @ c))

    def project(R, t):
        Xc = (R @ X.T + t[:, None]).T
        uv = (K @ Xc.T).T
        uv = uv[:, :2] / uv[:, 2:3]
        vis = (Xc[:, 2] > 0.5) & (uv[:, 0] > 0) & (uv[:, 0] < Wd) \
            & (uv[:, 1] > 0) & (uv[:, 1] < Hd)
        return uv, vis

    names = [f"img_{i:02d}.png" for i in range(n_views)]
    matches_data = {}
    for i in range(n_views - 1):
        for j in (i + 1, i + 2):
            if j >= n_views:
                continue
            uv_i, vis_i = project(*views[i])
            uv_j, vis_j = project(*views[j])
            vis = vis_i & vis_j
            corr = np.concatenate([
                uv_i[vis] + noise * rng.standard_normal((vis.sum(), 2)),
                uv_j[vis] + noise * rng.standard_normal((vis.sum(), 2)),
            ], axis=1)
            matches_data[(names[i], names[j])] = {
                "correspondences": corr.tolist(),
                "num_matches": int(vis.sum()), "quality_score": 0.8}
    image_info = {n: {"name": n, "width": Wd, "height": Hd} for n in names}
    return matches_data, image_info, views, names


def consecutive_rotation_errors(recon, Rs, names):
    """Angle (deg) between the relative rotation of each two registered
    views that are neighbours in `names` once the unregistered ones are
    left out, and the one of the rotations Rs (one per name). Pairs
    across an unregistered view are kept: a block of views registered
    off from the rest shows there."""
    reg = [(n, R) for n, R in zip(names, Rs) if n in recon.cameras]
    out = []
    for (na, Ra), (nb, Rb) in zip(reg, reg[1:]):
        R_est = recon.cameras[nb].R @ recon.cameras[na].R.T
        out.append(rot_err_deg(R_est, Rb @ Ra.T))
    return np.asarray(out)


def phase_split(history):
    """bench.py:bench_sfm's per-phase sums over one run's history."""
    prof = {}
    for h in history:
        if h.get("phase") != "add_view":
            continue
        for k in PIPE_PHASES:
            prof[k] = round(prof.get(k, 0.0) + h.get(k, 0.0), 3)
        prof["ba_iters"] = prof.get("ba_iters", 0) + int(h.get("ba_iters", 0))
        prof["views"] = prof.get("views", 0) + 1
    for h in history:
        if h.get("phase") in ("init", "global_ba", "bootstrap"):
            prof[h["phase"] + "_s"] = round(h.get("time_s", 0.0), 3)
    return prof


def sfm_pipeline_run(torch, matches_data, image_info, device):
    """One SfMPipeline(SfMConfig()).reconstruct on `device`; returns
    (pipeline, reconstruction, seconds)."""
    import tpu3drec_torch as tv
    pipe = tv.SfMPipeline(tv.SfMConfig(), device=device)
    t0 = time.perf_counter()
    recon = pipe.reconstruct(dict(matches_data), image_info)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return pipe, recon, time.perf_counter() - t0


def run_pipeline(torch, card, dev):
    """Phase 6: the incremental SfM pipeline at bench_sfm's 50 views on
    the card, against its bars, profiled on a 12-view cut, and held
    against the CPU plain path on the 5-view test scene."""
    from tpu3drec_torch.bench.synthetic import make_sfm_scene
    from tpu3drec_torch.ops import pallas_match as pm
    from tpu3drec_torch.ops import pallas_sample as ps
    from tpu3drec_torch.ops import pallas_sgm as psg
    from tpu3drec_torch.sfm.quality import reprojection_errors

    t_phase = time.perf_counter()
    md, info, gt = make_sfm_scene(n_views=PIPE_VIEWS, n_pts=PIPE_POINTS)
    reset_counts(pm, ps, psg)
    pipe, recon, cold = sfm_pipeline_run(torch, md, info, dev)
    launches = kernel_counts(pm, ps, psg)
    print(f"launches in the SfM pipeline run: {launches} (no TPU kernel "
          f"lies on this path: the reference computes it in plain XLA)")
    if any(launches.values()):
        fail("the SfM pipeline launched a kernel of another path")
    print(f"SfM pipeline cold run ({PIPE_VIEWS} views, {PIPE_POINTS} points): "
          f"{recon.num_cameras / cold:.4f} views/s ({cold:.2f} s)")
    pipe, recon, steady = sfm_pipeline_run(torch, md, info, dev)
    errs = reprojection_errors(recon)
    mre = float(np.mean(errs)) if len(errs) else np.inf
    rot = consecutive_rotation_errors(recon, [R for R, _ in gt["views"]],
                                      gt["names"])
    init = next(h for h in pipe.history if h["phase"] == "init")
    print(f"SfM pipeline steady: {recon.num_cameras / steady:.4f} views/s "
          f"(one run, {steady:.2f} s); cold "
          f"{recon.num_cameras / cold:.4f} views/s; on {card}")
    print(f"SfM pipeline result: {recon.num_cameras} cameras, "
          f"{recon.num_points} points, {recon.num_observations} observations, "
          f"final mean reprojection {mre:.4f} px, consecutive relative "
          f"rotations within {rot.max() if len(rot) else np.inf:.4f} deg of "
          f"the truth, init pair {tuple(init['pair'])}")
    print(json.dumps({"metric": "sfm per-phase profile (last steady run)",
                      **phase_split(pipe.history)}))
    if recon.num_cameras != PIPE_VIEWS:
        fail(f"the SfM pipeline registered {recon.num_cameras} of "
             f"{PIPE_VIEWS} views")
    if not mre < PIPE_REPROJ_BAR:
        fail(f"SfM pipeline: final mean reprojection must be under "
             f"{PIPE_REPROJ_BAR} px")
    if len(rot) != PIPE_VIEWS - 1 or not rot.max() < PIPE_ROT_BAR_DEG:
        fail(f"SfM pipeline: every consecutive relative rotation must be "
             f"within {PIPE_ROT_BAR_DEG} deg of the truth")
    del pipe, recon

    # one steady run of a 12-view cut, profiled
    md12, info12, _ = make_sfm_scene(n_views=PIPE_PROFILE_VIEWS,
                                     n_pts=PIPE_POINTS)
    print(f"profiled SfM pipeline run ({PIPE_PROFILE_VIEWS} views, "
          f"{PIPE_POINTS} points; the sfm.* ranges sum over the views):")
    profile_call(torch, lambda: sfm_pipeline_run(torch, md12, info12, dev),
                 "sfm.", top=15)

    # the card against the CPU plain path on the 5-view test scene
    smd, sinfo, sviews, snames = small_sfm_scene()
    (pc, rc, dc), (ph, rh, dh) = (sfm_pipeline_run(torch, smd, sinfo, d)
                                  for d in (dev, torch.device("cpu")))
    mc = float(np.mean(reprojection_errors(rc)))
    mh = float(np.mean(reprojection_errors(rh)))
    drot = consecutive_rotation_errors(rc, [rh.cameras[n].R for n in snames],
                                       snames)
    ic = next(h for h in pc.history if h["phase"] == "init")["pair"]
    ih = next(h for h in ph.history if h["phase"] == "init")["pair"]
    print(f"SfM pipeline, 5-view test scene, card vs CPU plain path: init "
          f"pair {tuple(ic)} vs {tuple(ih)}, cameras {sorted(rc.cameras)} vs "
          f"{sorted(rh.cameras)}, points {rc.num_points} vs {rh.num_points}, "
          f"mean reprojection {mc:.4f} vs {mh:.4f} px, consecutive relative "
          f"rotations within {drot.max() if len(drot) else np.inf:.4f} deg "
          f"({dc:.2f} s vs {dh:.2f} s)")
    if tuple(ic) != tuple(ih) or sorted(rc.cameras) != sorted(rh.cameras) \
            or abs(rc.num_points - rh.num_points) > PIPE_CPU_POINTS_RTOL * rh.num_points \
            or abs(mc - mh) > PIPE_CPU_REPROJ_PX \
            or len(drot) != len(snames) - 1 or not drot.max() < PIPE_CPU_ROT_DEG:
        fail(f"SfM pipeline: the card disagrees with the CPU plain path "
             f"(same init pair and views, points within "
             f"{100 * PIPE_CPU_POINTS_RTOL:.0f}%, mean reprojection within "
             f"{PIPE_CPU_REPROJ_PX} px, rotations within {PIPE_CPU_ROT_DEG} deg)")
    print(f"SfM pipeline phase on {card}: {time.perf_counter() - t_phase:.1f} s")


def render_splat_views(folder, n_views, n_pts, seed=0, f=FOLDER_F):
    """tests/test_end_to_end.py:render_splat_views at focal `f`, written
    as .npy (no image codec needed): each 3D point a unique random 6x6
    texture patch, scaled with 1/depth, painted far to near. Returns the
    file names and each view's rotation."""
    rng = np.random.default_rng(seed)
    Wf, Hf = 640, 480
    K = np.array([[f, 0, Wf / 2], [0, f, Hf / 2], [0, 0, 1]])
    X = rng.uniform(-4, 4, (n_pts, 3)) + np.array([0, 0, 12.0])
    base_size = rng.uniform(10.0, 18.0, n_pts)
    patches = rng.uniform(0.15, 1.0, (n_pts, 6, 6)).astype(np.float32)
    names, Rs = [], []
    for i in range(n_views):
        ang = (i - n_views / 2) * 0.09
        R = np.array([[np.cos(ang), 0, np.sin(ang)],
                      [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        c = np.array([6 * np.sin(ang), 0.1 * i, 12 - 6 * np.cos(ang)])
        Xc = (R @ X.T + (-R @ c)[:, None]).T
        z = Xc[:, 2]
        uv = (K @ Xc.T).T
        uv = uv[:, :2] / uv[:, 2:3]
        img = np.zeros((Hf, Wf), np.float32)
        for j in np.argsort(-z):            # far splats first
            if z[j] < 1:
                continue
            s = int(round(base_size[j] * 12.0 / z[j]))
            if s < 4:
                continue
            idx = (np.arange(s) * 6 // s)
            patch = patches[j][np.ix_(idx, idx)]
            x0 = int(round(uv[j, 0])) - s // 2
            y0 = int(round(uv[j, 1])) - s // 2
            xa, ya = max(0, x0), max(0, y0)
            xb, yb = min(Wf, x0 + s), min(Hf, y0 + s)
            if xa >= xb or ya >= yb:
                continue
            img[ya:yb, xa:xb] = patch[ya - y0:yb - y0, xa - x0:xb - x0]
        name = f"view_{i:02d}.npy"
        np.save(os.path.join(folder, name),
                (np.clip(img, 0, 1) * 255).astype(np.uint8))
        names.append(name)
        Rs.append(R)
    return names, Rs


def folder_sfm_bars(recon, Rs, names, label, share_bar=FOLDER_ROT_SHARE_BAR):
    """The folder chain's SfM bars on one reconstruction of the folder:
    views registered, final mean reprojection, and the relative rotations
    of neighbouring registered views against the renderer's (median, and
    `share_bar` of them within FOLDER_ROT_BAR_DEG). Prints them; returns
    the rotation errors (deg)."""
    from tpu3drec_torch.sfm.quality import reprojection_errors
    errs = reprojection_errors(recon)
    mre = float(np.mean(errs)) if len(errs) else np.inf
    rot = consecutive_rotation_errors(recon, Rs, names)
    within = float(np.mean(rot < FOLDER_ROT_BAR_DEG)) if len(rot) else 0.0
    med = float(np.median(rot)) if len(rot) else np.inf
    print(f"folder chain SfM ({label}): {recon.num_cameras}/{len(names)} "
          f"views registered (missing {sorted(set(names) - set(recon.cameras))}), "
          f"{recon.num_points} points, final mean reprojection {mre:.4f} px; "
          f"relative rotations of neighbouring registered views vs the "
          f"renderer's: median {med:.4f} deg, {100 * within:.1f}% of "
          f"{len(rot)} within {FOLDER_ROT_BAR_DEG} deg, errors (deg): "
          f"{', '.join(f'{r:.3f}' for r in rot)}")
    if recon.num_cameras < FOLDER_REGISTERED_BAR * len(names):
        fail(f"folder chain ({label}): under "
             f"{100 * FOLDER_REGISTERED_BAR:.0f}% of the views registered")
    if not mre < FOLDER_REPROJ_BAR:
        fail(f"folder chain ({label}): final mean reprojection must be "
             f"under {FOLDER_REPROJ_BAR} px")
    if not med < FOLDER_ROT_BAR_DEG or within < share_bar:
        fail(f"folder chain ({label}): the median relative rotation and "
             f"{100 * share_bar:.0f}% of them must be within "
             f"{FOLDER_ROT_BAR_DEG} deg of the renderer's")
    return rot


def folder_chain(torch, folder, out, device, dense=True, preset="balanced"):
    """One `reconstruct_folder` at the CLI auto command's defaults (with
    `preset`) on `device`; returns (result, seconds)."""
    import tpu3drec_torch as tv
    t0 = time.perf_counter()
    res = tv.reconstruct_folder(folder, out, preset=preset,
                                pair_mode="consecutive",
                                pair_window=FOLDER_PAIR_WINDOW, dense=dense,
                                device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def folder_checks(res, label):
    """Fail on any fallback, failed pair or method error of the matching
    stage; return its summary."""
    m = res["matching"]
    st = m["stats"]
    if st["engine_fallbacks"] or st["failed"] or st["method_errors"]:
        fail(f"folder chain ({label}): {st['engine_fallbacks']} engine "
             f"fallbacks, {st['failed']} failed pairs, {st['method_errors']} "
             f"method results with an error")
    return m


def folder_fill(torch, folder, names, dev, preset="balanced"):
    """Valid keypoints per view of each of the preset's methods, from one
    batched detection on the card."""
    from tpu3drec_torch.api import (
        _detector_params, _get_detector_registry, prepare_image,
    )
    from tpu3drec_torch.core.config import create_config_from_preset
    cfg = create_config_from_preset(preset)
    stack = torch.stack([prepare_image(np.load(os.path.join(folder, n)), dev)
                         for n in names])
    out = {}
    for method in cfg["methods"]:
        feats = _get_detector_registry()[method](
            stack, **_detector_params(method, cfg, None))
        out[method] = feats.mask.sum(1).cpu().numpy()
    return out, cfg["max_features"]


def batch_results(torch, images, pairs, device, preset="balanced"):
    """The batched engine's MatchingResults for `pairs` on `device`, with
    the chain's config (the preset, no homography filtering)."""
    import tpu3drec_torch as tv
    pipe = tv.create_pipeline(preset, {
        "filtering": {"use_adaptive_filtering": False}}, device=device)
    return pipe._match_pairs_batched(images, pairs)


def folder_knn2(torch, pm, ops, label):
    """`knn2` on operands the folder chain handed it: bit for bit against
    the plain version (twice), timed beside the plain version, both
    yardsticks and the bound. Prints one line; returns the fields."""
    a, b, n2, m2 = ops
    err = knn2_equal(torch, pm, a, b, n2, m2, label)
    ms = cuda_ms(torch, lambda: pm.knn2_raw(a, b, n2, m2))
    plain = cuda_ms(torch, lambda: pm.knn2_plain(a, b, n2, m2), reps=2)
    f32, (bf16, form) = knn2_library(torch, a, b, n2, m2)
    lib_ms, lib_bf16_ms = cuda_ms(torch, f32, reps=2), cuda_ms(torch, bf16, reps=2)
    bound, by = knn2_bound(a, b, m2)
    print(f"knn2 at {label} {tuple(a.shape)} x {tuple(b.shape)} "
          f"({int(m2.sum())} of {m2.numel()} columns valid): bit-equal to "
          f"the plain version, twice; {ms:.4f} ms per call (CUDA events), "
          f"plain {plain:.3f} ms, bound {bound:.4f} ms ({by}); f32 matmul + "
          f"topk {lib_ms:.3f} ms; {form} {lib_bf16_ms:.3f} ms")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                max_abs_err=err, library_ms=lib_ms,
                library_bf16_ms=lib_bf16_ms)


def spy_kernel_inputs(mt, ps):
    """Spies on the matcher's `knn2` entry and the SIFT detector's
    `ori_desc` entry (they launch nothing themselves): the count of knn2
    calls by descriptor depth, the first call's operands at each depth,
    and the first detection call's octaves (until octave 0's shape comes
    again). Returns (calls, operands, octaves, restore)."""
    from types import SimpleNamespace
    calls, ops, octaves, first = {}, {}, [], [True]
    knn2_entry, windows_entry = mt.knn2_raw, ps.ori_desc_windows

    def knn2_spy(a, b, bnorm, mask2):
        d = a.shape[-1]
        calls[d] = calls.get(d, 0) + 1
        if d not in ops:
            ops[d] = tuple(t.clone() for t in (a, b, bnorm, mask2))
        return knn2_entry(a, b, bnorm, mask2)

    def windows_spy(dxs, dys, meta, hp, fb):
        if first[0] and octaves and dxs.shape[1:] == octaves[0].dxs.shape[1:]:
            first[0] = False
        if first[0]:
            octaves.append(SimpleNamespace(
                octave=len(octaves), dxs=dxs.clone(), dys=dys.clone(),
                meta=meta.clone(), hp=hp, fb=fb))
        return windows_entry(dxs, dys, meta, hp, fb)

    def restore():
        mt.knn2_raw, ps.ori_desc_windows = knn2_entry, windows_entry

    mt.knn2_raw, ps.ori_desc_windows = knn2_spy, windows_spy
    return calls, ops, octaves, restore


def run_folder(torch, card, dev, tmp, names, Rs):
    """Phase 7: the folder chain images -> matches -> SfM -> mesh at the
    CLI auto command's defaults, on the 24 rendered views of 640x480 in
    `tmp`/imgs (`names`, the renderer's rotations `Rs`); its
    kernels' launches, bars, the card against the CPU plain path (the
    first batch's matching, the SfM stage on the card's own matches, the
    dense stage on a 7-view cut of the card's registered views, a 4-view
    cut of the chain), and
    `ori_desc` and `knn2` (both metrics) on the first batch's operands
    against their plain versions."""
    import copy
    import tpu3drec_torch.pipelines.dense as pdense
    from tpu3drec_torch.io.images import FolderImageSource
    from tpu3drec_torch.ops import match as mt
    from tpu3drec_torch.ops import pallas_match as pm
    from tpu3drec_torch.ops import pallas_sample as ps
    from tpu3drec_torch.ops import pallas_sgm as psg
    from tpu3drec_torch.ops.sift import N_LAYERS
    from tpu3drec_torch.sfm import SfMPipeline

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    folder = os.path.join(tmp, "imgs")
    fill, cap = folder_fill(torch, folder, names, dev)
    print(f"folder: {FOLDER_VIEWS} views of 640x480, {FOLDER_POINTS} "
          f"splats, f = {FOLDER_F}; keypoints per view of {cap} slots: "
          + "; ".join(f"{m} median {int(np.median(v))} ({100 * np.median(v) / cap:.1f}%), "
                      f"min {int(v.min())}, max {int(v.max())}"
                      for m, v in fill.items()))
    if np.median(fill["SIFT"]) < cap / 2:
        fail("folder: SIFT fills under half of its slots on the median view")

    # the kernels' inputs as the path hands them
    calls, knn2_ops, octaves, restore = spy_kernel_inputs(mt, ps)
    try:
        reset_counts(pm, ps, psg)
        res, cold = folder_chain(torch, folder, os.path.join(tmp, "cold"), dev)
        launches = kernel_counts(pm, ps, psg)
    finally:
        restore()
    by_metric = {FOLDER_METRIC_BY_DEPTH.get(d, d): n
                 for d, n in sorted(calls.items())}
    print(f"launches in the folder chain's cold run: {launches}; knn2 "
          f"calls by metric: {by_metric}")
    for name, n in launches.items():
        if n == 0:
            fail(f"the folder chain never launched the {name} kernel")
    if set(by_metric) != {"l2_int8", "hamming_pm1"}:
        fail("the folder chain did not run knn2 on both the SIFT and "
             "the ORB input")
    folder_checks(res, "cold")
    cold_names = sorted(res["reconstruction"].cameras)
    cold_views = res["reconstruction"].num_cameras
    cold_points = res["reconstruction"].num_points

    # the steady run; spies keep what its SfM and dense stages were
    # handed, for the CPU plain path below
    handed = {}
    sfm_entry, dense_entry = (SfMPipeline.reconstruct,
                              pdense.run_dense_reconstruction)

    def sfm_spy(self, matches_data, image_info, *a, **k):
        handed["sfm"] = copy.deepcopy((matches_data, image_info))
        return sfm_entry(self, matches_data, image_info, *a, **k)

    def dense_spy(sparse, images, *a, **k):
        handed["dense"] = copy.deepcopy((sparse, images))
        return dense_entry(sparse, images, *a, **k)

    SfMPipeline.reconstruct = sfm_spy
    pdense.run_dense_reconstruction = dense_spy
    try:
        res, steady = folder_chain(torch, folder,
                                   os.path.join(tmp, "steady"), dev)
    finally:
        SfMPipeline.reconstruct = sfm_entry
        pdense.run_dense_reconstruction = dense_entry
    m = folder_checks(res, "steady")
    recon = res["reconstruction"]
    n_pairs = m["stats"]["total_pairs"]
    n_methods = len(m["config"]["methods"])
    n_batches = -(-n_pairs // FOLDER_BATCH)
    t = res["timings_s"]
    dense = res.get("dense") or {}
    mesh = dense.get("mesh", {})
    cloud = dense.get("point_cloud", {})
    valid = dense.get("depth", {}).get("valid_fraction", 0.0)
    print(f"folder chain: {FOLDER_VIEWS / steady:.4f} images/s end to end "
          f"({steady:.2f} s steady; cold {cold:.2f} s, "
          f"{FOLDER_VIEWS / cold:.4f} images/s); matching "
          f"{n_pairs / t['matching']:.3f} pairs/s; seconds: matching "
          f"{t['matching']:.3f}, SfM {t['sfm']:.3f}, dense "
          f"{t.get('dense', float('nan')):.3f}; on {card}")
    print(f"folder chain matching: {n_pairs} pairs in {n_batches} batches, "
          f"dispatch_count {m['dispatch_count']}; per method: "
          + "; ".join(f"{k} {v['pairs']} pairs, mean raw matches "
                      f"{v['mean_raw_matches']:.1f}, mean quality "
                      f"{v['mean_quality']:.4f}"
                      for k, v in m["methods"].items()))
    print(f"folder chain dense: {cloud.get('num_points', 0)} cloud "
          f"points, fused depth valid on {valid:.4f} of the reference "
          f"view, {mesh.get('num_faces', 0)} mesh faces "
          f"({mesh.get('method')}, reference view "
          f"{dense.get('reference_view')})")
    if m["dispatch_count"] != 2 * n_methods * n_batches:
        fail(f"folder chain: {m['dispatch_count']} engine calls, not "
             f"2 x {n_methods} methods x {n_batches} batches")
    folder_sfm_bars(recon, Rs, names, "the card")
    dense_dir = os.path.join(tmp, "steady", "dense")
    if cloud.get("num_points", 0) < FOLDER_CLOUD_BAR \
            or not valid > FOLDER_VALID_BAR or not all(
            os.path.exists(os.path.join(dense_dir, f)) for f in
            ("fused_depth.npy", "point_cloud.ply", "mesh.obj")):
        fail(f"folder chain: dense artifacts missing, fewer than "
             f"{FOLDER_CLOUD_BAR} cloud points or the fused depth valid "
             f"on no more than {FOLDER_VALID_BAR} of the reference view")

    # the card's SfM again on the steady run's matches: BA sums its
    # segments in a fixed order on the card (ops/ba.py), so the same
    # matches give the same reconstruction, camera for camera (with float
    # atomics there, 23 and 24 views came out of one set of matches)
    md, info = handed.pop("sfm")
    _, ra, _ = sfm_pipeline_run(torch, md, info, dev)
    rot_a = consecutive_rotation_errors(ra, Rs, names)
    same_views = sorted(ra.cameras) == sorted(recon.cameras)
    dpose = max((float(np.abs(ra.cameras[n].R - recon.cameras[n].R).max()
                       + np.abs(ra.cameras[n].t - recon.cameras[n].t).max())
                 for n in recon.cameras), default=0.0) \
        if same_views else np.inf
    print(f"folder chain SfM, the card again on the same matches: "
          f"{ra.num_cameras} views (missing "
          f"{sorted(set(names) - set(ra.cameras))}), {ra.num_points} "
          f"points, {100 * float(np.mean(rot_a < FOLDER_ROT_BAR_DEG)):.1f}% "
          f"within {FOLDER_ROT_BAR_DEG} deg; the steady run: "
          f"{recon.num_cameras} views, {recon.num_points} points; largest "
          f"pose difference {dpose:.3e}; the cold run (its own matching): "
          f"{cold_views} views, {cold_points} points, "
          f"{'the same' if cold_names == sorted(recon.cameras) else 'other'}"
          f" views")
    if not same_views or ra.num_points != recon.num_points or dpose != 0.0:
        fail("folder chain: the card's SfM on the same matches gave "
             "another reconstruction")
    del ra

    # the SfM stage on the CPU plain path, on the card's own matches:
    # the card's matches must carry the CPU's SfM over the same bars,
    # and the two must agree on the median relative rotation of the
    # neighbouring views both registered. Which weak views register,
    # and how far off, turns on float order (the CPU's own runs differ
    # with its thread count, and cuSOLVER's null-space basis is not
    # LAPACK's), so the views and the worst pair are compared, not held
    # equal
    t0 = time.perf_counter()
    _, rh, _ = sfm_pipeline_run(torch, md, info, cpu)
    sfm_cpu_s = time.perf_counter() - t0
    folder_sfm_bars(rh, Rs, names, "the CPU plain path on the card's "
                    "matches")
    common = [n for n in names if n in recon.cameras and n in rh.cameras]
    drot = consecutive_rotation_errors(
        recon, [rh.cameras[n].R for n in common], common)
    print(f"folder chain SfM, card vs CPU plain path on the card's "
          f"matches: views only on the card "
          f"{sorted(set(recon.cameras) - set(rh.cameras))}, only on the "
          f"CPU {sorted(set(rh.cameras) - set(recon.cameras))}; points "
          f"{recon.num_points} vs {rh.num_points}; relative rotations of "
          f"neighbouring common views within "
          f"{drot.max() if len(drot) else np.inf:.4f} deg of each other, "
          f"median {np.median(drot) if len(drot) else np.inf:.4f} "
          f"({sfm_cpu_s:.1f} s on the CPU)")
    if not len(drot) or not np.median(drot) < PIPE_CPU_ROT_DEG:
        fail(f"folder chain: the card's SfM and the CPU plain path's on "
             f"the same matches differ by {PIPE_CPU_ROT_DEG} deg or more "
             f"in the median relative rotation of neighbouring views")
    del rh

    # the dense stage on the card and on the CPU plain path, on a cut of
    # the card's own registered views and images: the FOLDER_DENSE_CUT
    # views nearest the chain's reference view by name, with that
    # reference (the CPU's stage over every view was most of this
    # phase's time)
    sparse, dimgs = handed.pop("dense")
    dense_input = (sparse, dimgs)
    ref_view = dense.get("reference_view")
    posed = sorted(n for n in sparse["camera_poses"] if n in dimgs)
    at = posed.index(ref_view)
    lo = max(0, min(at - FOLDER_DENSE_CUT // 2, len(posed) - FOLDER_DENSE_CUT))
    cut_imgs = {n: dimgs[n] for n in posed[lo:lo + FOLDER_DENSE_CUT]}
    dc = pdense.run_dense_reconstruction(sparse, cut_imgs,
                                         reference_view=ref_view, device=dev)
    t0 = time.perf_counter()
    dh = pdense.run_dense_reconstruction(sparse, cut_imgs,
                                         reference_view=ref_view, device=cpu)
    dense_cpu_s = time.perf_counter() - t0
    vc, vh = dc["depth"]["valid_fraction"], dh["depth"]["valid_fraction"]
    cc, ch = dc["point_cloud"]["num_points"], dh["point_cloud"]["num_points"]
    print(f"folder chain dense, card vs CPU plain path on the same "
          f"{dh['num_views']} of the card's registered views (reference "
          f"{dh['reference_view']}): fused depth valid on {vc:.4f} vs "
          f"{vh:.4f} of the reference view (bar: within "
          f"{FOLDER_DENSE_VALID_ABS}), cloud {cc} vs {ch} points (bar: within "
          f"{100 * FOLDER_DENSE_CLOUD_RTOL:.0f}%), mesh "
          f"{dc['mesh']['num_faces']} vs {dh['mesh']['num_faces']} faces "
          f"({dense_cpu_s:.1f} s on the CPU)")
    if dh["reference_view"] != dc["reference_view"] \
            or dh["num_views"] != dc["num_views"] \
            or not abs(vc - vh) <= FOLDER_DENSE_VALID_ABS \
            or not abs(cc - ch) <= FOLDER_DENSE_CLOUD_RTOL * ch:
        fail("folder chain: the card's dense stage disagrees with the "
             "CPU plain path on the same views")
    del res, recon, dc, dh

    # the card against the CPU plain path: the first batch of pairs
    t0 = time.perf_counter()
    src = FolderImageSource(folder)
    pairs = [(names[i], names[i + k]) for i in range(FOLDER_VIEWS)
             for k in range(1, FOLDER_PAIR_WINDOW + 1)
             if i + k < FOLDER_VIEWS][:FOLDER_BATCH]
    images = src.load_many(sorted({n for p in pairs for n in p}))
    rc = batch_results(torch, images, pairs, dev)
    rh = batch_results(torch, images, pairs, cpu)
    worst, same_best, compared = 0.0, 0, 0
    if sorted(rc) != sorted(rh):
        fail("folder chain: the card and the CPU matched other pairs")
    for pair in rh:
        for meth, r in rh[pair].items():
            nc, nh = rc[pair][meth].num_raw_matches, r.num_raw_matches
            if rc[pair][meth].error or r.error:
                fail(f"folder chain: method error {rc[pair][meth].error or r.error}")
            worst = max(worst, abs(nc - nh) / max(2, 0.02 * nh))
        scores = sorted(r.get_quality_score() for r in rh[pair].values())
        if scores[-1] - scores[0] > FOLDER_SCORE_GAP:
            compared += 1
            same_best += (rc[pair].get_best_method_name()
                          == rh[pair].get_best_method_name())
    print(f"folder chain, first batch of {len(pairs)} pairs, card vs CPU "
          f"plain path: same pairs; raw match counts within "
          f"{worst:.3f} of max(2, 2%); same best method on {same_best} "
          f"of {compared} pairs whose CPU scores differ by more than "
          f"{FOLDER_SCORE_GAP} ({time.perf_counter() - t0:.1f} s)")
    if worst > 1.0 or same_best != compared:
        fail("folder chain: the card's matching disagrees with the CPU "
             "plain path")

    # ... and the views a 4-view cut registers
    t0 = time.perf_counter()
    cut = os.path.join(tmp, "cut")
    os.mkdir(cut)
    for n in names[:FOLDER_CUT]:
        shutil.copyfile(os.path.join(folder, n), os.path.join(cut, n))
    (res_c, _), (res_h, _) = (
        folder_chain(torch, cut, os.path.join(tmp, f"cut_{d.type}"), d,
                     dense=False) for d in (dev, cpu))
    vc = sorted(res_c["reconstruction"].cameras)
    vh = sorted(res_h["reconstruction"].cameras)
    print(f"folder chain, {FOLDER_CUT}-view cut, card vs CPU plain path: "
          f"views {vc} vs {vh}; points {res_c['reconstruction'].num_points} "
          f"vs {res_h['reconstruction'].num_points} "
          f"({time.perf_counter() - t0:.1f} s)")
    if vc != vh:
        fail("folder chain: the card and the CPU registered other views")

    # ori_desc and knn2 on the first batch's operands, as the path handed
    # them, against their plain versions with phase 2's bars
    L, h, w = octaves[0].dxs.shape
    od = ori_desc_octaves(torch, ps, octaves, profile=False)
    print(f"ori_desc vs plain at the folder chain's first batch ("
          f"{L // (N_LAYERS + 3)} images of {w}x{h}, {len(octaves)} octaves, "
          f"{sum(o.meta.shape[0] for o in octaves)} slots): {od['n_valid']} "
          f"valid; {od['n_bad']} outside angle<1e-3 rad & cos>0.9999 "
          f"({100 * od['frac_bad']:.3f}%, bar <= 0.5%); max |desc err| on "
          f"the rest {od['max_err']:.3e}; two launches bit-identical; every "
          f"slot written; the device's slot list and support boxes right; "
          f"{od['ms']:.4f} ms per detection call (CUDA events), plain "
          f"{od['plain_ms']:.3f} ms, bound {od['bound_ms']:.4f} ms "
          f"({od['bound_by']})")
    if od["n_valid"] == 0 or od["frac_bad"] > 0.005:
        fail("ori_desc disagrees with its plain version at the folder's "
             "first batch")
    sift = folder_knn2(torch, pm, knn2_ops[128],
                       "the folder's first batch of SIFT operands")
    orb = folder_knn2(torch, pm, knn2_ops[256],
                      "the folder's first batch of ORB operands")
    print(f"folder chain phase on {card}: {time.perf_counter() - t_phase:.1f} s")
    return dict(
        launches=launches, dense_input=dense_input,
        ori_desc={"folder_ms": od["ms"], "folder_plain_ms": od["plain_ms"],
                  "folder_bound_ms": od["bound_ms"],
                  "folder_bound_by": od["bound_by"],
                  "folder_max_abs_err": od["max_err"]},
        knn2={**{f"folder_{k}": v for k, v in sift.items()},
              **{f"orb_{k}": v for k, v in orb.items()}})


def akaze_stable_scales(torch, img):
    """Keypoint scales (6 sigma) of the AKAZE levels that evolve stably
    from `img` (H, W) on the CPU: where the scale space of `img` moved by
    one ulp per pixel stays within 1e-5 of its own. Past them the FED
    cycles amplify a last ulp without bound (in the reference too; its
    parity test compares keypoints on these levels only)."""
    from tpu3drec_torch.ops import akaze as ak
    x = torch.from_numpy(img)[None]
    rng = np.random.default_rng(0)
    nudged = torch.from_numpy(np.nextafter(img, np.where(
        rng.random(img.shape) < 0.5, 2.0, -1.0).astype(np.float32)))[None]
    k2 = ak._contrast_k2(x)
    out = []
    for (o, sub, sigma, La), (_, _, _, Lb) in zip(
            ak.evolve_scale_space(x, k2, 4), ak.evolve_scale_space(nudged, k2, 4)):
        if float((La - Lb).abs().max()) < 1e-5:
            out.append(np.float32(sigma) * np.float32(2.0 ** o * 6.0))
    return np.asarray(out, np.float32)


def keypoint_agreement(ref, got, keep=None):
    """Shares of one image's valid keypoints (`keep` selects) of `ref`
    found in `got` at the same scale within 1e-3 px, and of the bits of
    the shared ones that agree: (found, bits, n_ref, n_got)."""
    def host(f):
        return {k: getattr(f, k).cpu().numpy() for k in
                ("xy", "scale", "desc", "mask")}
    r, g = host(ref), host(got)
    rv = np.nonzero(r["mask"] & (True if keep is None else keep(r)))[0]
    gv = np.nonzero(g["mask"] & (True if keep is None else keep(g)))[0]
    if not len(rv) or not len(gv):
        return 0.0, 0.0, len(rv), len(gv)
    d = np.abs(r["xy"][rv][:, None] - g["xy"][gv][None]).max(-1)
    d = np.where(np.isclose(r["scale"][rv][:, None], g["scale"][gv][None],
                            rtol=1e-6), d, np.inf)
    j = d.argmin(1)
    ok = d[np.arange(len(rv)), j] <= 1e-3
    bits = float((r["desc"][rv[ok]] == g["desc"][gv[j[ok]]]).mean()) \
        if ok.any() else 0.0
    return float(ok.mean()), bits, len(rv), len(gv)


def sift_agreement(ref, got):
    """tests/test_torch_detectors.py's SIFT bars between two Features of
    one image: the share of `got`'s valid keypoints within 1e-4 px of one
    of `ref`'s, the counts, the largest angle difference and the smallest
    descriptor cosine of the matched ones."""
    r = {k: getattr(ref, k).cpu().numpy() for k in ("xy", "angle", "desc", "mask")}
    g = {k: getattr(got, k).cpu().numpy() for k in ("xy", "angle", "desc", "mask")}
    a, b = np.nonzero(g["mask"])[0], np.nonzero(r["mask"])[0]
    d = np.linalg.norm(g["xy"][a][:, None] - r["xy"][b][None], axis=-1)
    j = d.argmin(1)
    m = d[np.arange(len(a)), j] < 1e-4
    ia, ib = a[m], b[j[m]]
    da = np.abs(np.angle(np.exp(1j * (g["angle"][ia].astype(np.float64)
                                      - r["angle"][ib]))))
    cos = (g["desc"][ia] * r["desc"][ib]).sum(1) / np.maximum(
        np.linalg.norm(g["desc"][ia], axis=1)
        * np.linalg.norm(r["desc"][ib], axis=1), 1e-12)
    return dict(found=float(m.mean()) if len(a) else 0.0, n_got=len(a),
                n_ref=len(b), max_angle=float(da.max()) if len(da) else 0.0,
                min_cos=float(cos.min()) if len(cos) else 0.0)


def run_folder_accurate(torch, card, dev, tmp, names, Rs):
    """Phase 8: the folder chain at the CLI `auto --preset accurate
    --dense` defaults (SIFT + AKAZE + BRISK at 3,000 features) on phase
    7's folder: launches (knn2 by method), rates, bars, each detector's
    seconds and a profiled AKAZE call; the first batch against the CPU
    plain path (matching, and AKAZE's and BRISK's keypoints and bits);
    Harris and GoodFeatures pairs and SIFT's gather sampler and upscale,
    card against CPU; `ori_desc` at the batch's SIFT octaves and `knn2`
    at its AKAZE and BRISK operands against their plain versions."""
    import tpu3drec_torch as tv
    from tpu3drec_torch.api import _detector_params, _get_detector_registry
    from tpu3drec_torch.core.config import create_config_from_preset
    from tpu3drec_torch.io.images import FolderImageSource
    from tpu3drec_torch.ops import match as mt
    from tpu3drec_torch.ops import pallas_match as pm
    from tpu3drec_torch.ops import pallas_sample as ps
    from tpu3drec_torch.ops import pallas_sgm as psg
    from tpu3drec_torch.ops.sift import N_LAYERS, detect_sift_features

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    folder = os.path.join(tmp, "imgs")
    fill, cap = folder_fill(torch, folder, names, dev, ACC_PRESET)
    print(f"accurate chain folder: keypoints per view of {cap} slots: "
          + "; ".join(f"{m} median {int(np.median(v))} ({100 * np.median(v) / cap:.1f}%), "
                      f"min {int(v.min())}, max {int(v.max())}"
                      for m, v in fill.items()))
    for m, v in fill.items():
        if v.min() == 0:
            fail(f"accurate chain: {m} finds no keypoint on a view")

    calls, knn2_ops, octaves, restore = spy_kernel_inputs(mt, ps)
    try:
        reset_counts(pm, ps, psg)
        res, cold = folder_chain(torch, folder, os.path.join(tmp, "acc_cold"),
                                 dev, preset=ACC_PRESET)
        launches = kernel_counts(pm, ps, psg)
    finally:
        restore()
    by_method = {ACC_DEPTH_METHOD.get(d, d): n for d, n in sorted(calls.items())}
    print(f"launches in the accurate chain's cold run: {launches}; knn2 "
          f"calls by method (metric): "
          + ", ".join(f"{k} ({ACC_METRIC[k]}) {v}" if k in ACC_METRIC
                      else f"depth {k} {v}" for k, v in by_method.items()))
    for name, n in launches.items():
        if n == 0:
            fail(f"the accurate chain never launched the {name} kernel")
    if set(by_method) != set(ACC_METRIC):
        fail("the accurate chain did not run knn2 on each of SIFT's, "
             "AKAZE's and BRISK's descriptors")
    folder_checks(res, "accurate, cold")

    res, steady = folder_chain(torch, folder, os.path.join(tmp, "acc_steady"),
                               dev, preset=ACC_PRESET)
    m = folder_checks(res, "accurate, steady")
    recon = res["reconstruction"]
    n_pairs = m["stats"]["total_pairs"]
    n_batches = -(-n_pairs // FOLDER_BATCH)
    t = res["timings_s"]
    dense = res.get("dense") or {}
    print(f"accurate chain: {FOLDER_VIEWS / steady:.4f} images/s end to end "
          f"({steady:.2f} s steady; cold {cold:.2f} s, "
          f"{FOLDER_VIEWS / cold:.4f} images/s); matching "
          f"{n_pairs / t['matching']:.3f} pairs/s; seconds: matching "
          f"{t['matching']:.3f}, SfM {t['sfm']:.3f}, dense "
          f"{t.get('dense', float('nan')):.3f}; on {card}")
    print(f"accurate chain matching: {n_pairs} pairs in {n_batches} batches, "
          f"dispatch_count {m['dispatch_count']}; per method: "
          + "; ".join(f"{k} {v['pairs']} pairs, mean raw matches "
                      f"{v['mean_raw_matches']:.1f}, mean quality "
                      f"{v['mean_quality']:.4f}"
                      for k, v in m["methods"].items()))
    print(f"accurate chain dense: "
          f"{(dense.get('point_cloud') or {}).get('num_points', 0)} cloud "
          f"points, {(dense.get('mesh') or {}).get('num_faces', 0)} mesh "
          f"faces (reported, not held)")
    if m["dispatch_count"] != 2 * len(ACC_METRIC) * n_batches:
        fail(f"accurate chain: {m['dispatch_count']} engine calls, not "
             f"2 x {len(ACC_METRIC)} methods x {n_batches} batches")
    if set(m["methods"]) != set(ACC_METRIC) or any(
            v["mean_raw_matches"] < ACC_RAW_MATCHES_BAR
            for v in m["methods"].values()):
        fail(f"accurate chain: a method with under {ACC_RAW_MATCHES_BAR} "
             f"mean raw matches a pair, or a method missing")
    rot = folder_sfm_bars(recon, Rs, names, "accurate, the card",
                          share_bar=ACC_ROT_SHARE_BAR)
    reg = [n for n in names if n in recon.cameras]
    bends = [f"{a}->{b} {r:.2f}" for a, b, r in zip(reg, reg[1:], rot)
             if r >= FOLDER_ROT_BAR_DEG]
    print(f"accurate chain: neighbouring registered views off by "
          f"{FOLDER_ROT_BAR_DEG} deg or more on the card: "
          f"{', '.join(bends) or 'none'}")
    del res, recon

    # the card against the CPU plain path on the first batch of pairs
    t0 = time.perf_counter()
    src = FolderImageSource(folder)
    pairs = [(names[i], names[i + k]) for i in range(FOLDER_VIEWS)
             for k in range(1, FOLDER_PAIR_WINDOW + 1)
             if i + k < FOLDER_VIEWS][:FOLDER_BATCH]
    images = src.load_many(sorted({n for p in pairs for n in p}))
    rc = batch_results(torch, images, pairs, dev, ACC_PRESET)
    rh = batch_results(torch, images, pairs, cpu, ACC_PRESET)
    if sorted(rc) != sorted(rh):
        fail("accurate chain: the card and the CPU matched other pairs")
    worst, same_best, compared = 0.0, 0, 0
    for pair in rh:
        for meth, r in rh[pair].items():
            if rc[pair][meth].error or r.error:
                fail(f"accurate chain: method error "
                     f"{rc[pair][meth].error or r.error}")
            nc, nh = rc[pair][meth].num_raw_matches, r.num_raw_matches
            worst = max(worst, abs(nc - nh) / max(2, 0.02 * nh))
        scores = sorted(r.get_quality_score() for r in rh[pair].values())
        if scores[-1] - scores[0] > FOLDER_SCORE_GAP:
            compared += 1
            same_best += (rc[pair].get_best_method_name()
                          == rh[pair].get_best_method_name())
    # AKAZE's and BRISK's keypoints and bits per image, by the CPU tests'
    # shares (AKAZE on the levels that evolve stably)
    feats = {}
    for pair in pairs:
        for meth in ("AKAZE", "BRISK"):
            for side, name in ((1, pair[0]), (2, pair[1])):
                feats[(meth, name)] = tuple(
                    getattr(r[pair][meth], f"features{side}") for r in (rh, rc))
    scales = akaze_stable_scales(torch, images[pairs[0][0]])
    low = {"AKAZE": (1.0, 1.0), "BRISK": (1.0, 1.0)}
    for (meth, name), (fh, fc) in feats.items():
        keep = None
        if meth == "AKAZE":
            def keep(f):
                return np.isclose(f["scale"][:, None], scales[None],
                                  rtol=1e-6).any(1)
        found, bits, _, _ = keypoint_agreement(fh, fc, keep)
        low[meth] = (min(low[meth][0], found), min(low[meth][1], bits))
    print(f"accurate chain, first batch of {len(pairs)} pairs, card vs CPU "
          f"plain path: same pairs; raw match counts within {worst:.3f} of "
          f"max(2, 2%); same best method on {same_best} of {compared} pairs "
          f"whose CPU scores differ by more than {FOLDER_SCORE_GAP}; lowest "
          f"share per image of the CPU's valid keypoints found on the card "
          f"and of their bits agreeing: AKAZE {low['AKAZE'][0]:.4f} / "
          f"{low['AKAZE'][1]:.4f} (on its {len(scales)} stable levels), "
          f"BRISK {low['BRISK'][0]:.4f} / {low['BRISK'][1]:.4f} "
          f"({time.perf_counter() - t0:.1f} s)")
    if worst > 1.0 or same_best != compared:
        fail("accurate chain: the card's matching disagrees with the CPU "
             "plain path")
    if min(v for pair in low.values() for v in pair) < ACC_SHARE:
        fail(f"accurate chain: AKAZE's or BRISK's keypoints or bits on the "
             f"card agree with the CPU's on under {ACC_SHARE:.0%}")

    # each detector's seconds on the first batch's images, and one
    # profiled AKAZE call
    cfg = create_config_from_preset(ACC_PRESET)
    stack = torch.stack([tv.prepare_image(images[n], dev) for n in sorted(images)])
    det_s = {}
    for meth in cfg["methods"]:
        det = _get_detector_registry()[meth]
        params = _detector_params(meth, cfg, None)
        det(stack, **params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det(stack, **params)
        torch.cuda.synchronize()
        det_s[meth] = time.perf_counter() - t0
    print(f"accurate chain detection, one batched call on the first batch's "
          f"{stack.shape[0]} images of 640x480 (host clock, warm): "
          + ", ".join(f"{k} {v:.4f} s" for k, v in det_s.items()))
    akaze = _get_detector_registry()["AKAZE"]
    akaze_params = _detector_params("AKAZE", cfg, None)
    print("AKAZE detection, profiled:")
    profile_call(torch, lambda: akaze(stack, **akaze_params), "akaze.")

    # Harris and GoodFeatures pairs, and SIFT's gather sampler and
    # upscale, on the card against the CPU plain path
    t0 = time.perf_counter()
    v0, v1 = images[pairs[0][0]], images[pairs[0][1]]
    counts = {}
    for meth in ("Harris", "GoodFeatures"):
        rcm = tv.match_images(v0, v1, method=meth, device=dev)
        rhm = tv.match_images(v0, v1, method=meth, device=cpu)
        counts[meth] = (rcm.num_raw_matches, rhm.num_raw_matches)
    sift = {}
    for label, kw in (("sampler='xla'", {"sampler": "xla"}),
                      ("upscale=True", {"upscale": True})):
        fc = detect_sift_features(tv.prepare_image(v0, dev),
                                  max_features=cfg["max_features"], **kw)
        fh = detect_sift_features(tv.prepare_image(v0, cpu),
                                  max_features=cfg["max_features"], **kw)
        sift[label] = sift_agreement(fh, fc)
    print(f"Harris / GoodFeatures pairs, card vs CPU plain path, raw matches: "
          + ", ".join(f"{k} {a} vs {b}" for k, (a, b) in counts.items())
          + "; SIFT on one view, card vs CPU: "
          + "; ".join(f"{k}: {v['n_got']} vs {v['n_ref']} keypoints, "
                      f"{100 * v['found']:.2f}% within 1e-4 px, angles within "
                      f"{v['max_angle']:.2e} rad, descriptor cosine >= "
                      f"{v['min_cos']:.6f}" for k, v in sift.items())
          + f" ({time.perf_counter() - t0:.1f} s)")
    if any(abs(a - b) > max(2, 0.02 * b) or b == 0 for a, b in counts.values()):
        fail("Harris / GoodFeatures: the card's raw matches disagree with "
             "the CPU's")
    for k, v in sift.items():
        if v["found"] < 0.99 or abs(v["n_got"] - v["n_ref"]) > 0.01 * v["n_ref"] \
                or v["max_angle"] >= 1e-3 or v["min_cos"] <= 0.9999:
            fail(f"SIFT {k}: the card disagrees with the CPU plain path")

    # the kernels at this path's operands
    L, h, w = octaves[0].dxs.shape
    od = ori_desc_octaves(torch, ps, octaves, profile=False)
    print(f"ori_desc vs plain at the accurate chain's first batch ("
          f"{L // (N_LAYERS + 3)} images of {w}x{h}, {len(octaves)} octaves, "
          f"{sum(o.meta.shape[0] for o in octaves)} slots): {od['n_valid']} "
          f"valid; {od['n_bad']} outside angle<1e-3 rad & cos>0.9999 "
          f"({100 * od['frac_bad']:.3f}%, bar <= 0.5%); max |desc err| on "
          f"the rest {od['max_err']:.3e}; two launches bit-identical; "
          f"{od['ms']:.4f} ms per detection call (CUDA events), plain "
          f"{od['plain_ms']:.3f} ms, bound {od['bound_ms']:.4f} ms "
          f"({od['bound_by']})")
    if od["n_valid"] == 0 or od["frac_bad"] > 0.005:
        fail("ori_desc disagrees with its plain version at the accurate "
             "chain's first batch")
    akaze_k = folder_knn2(torch, pm, knn2_ops[486],
                          "the accurate chain's first batch of AKAZE operands")
    brisk_k = folder_knn2(torch, pm, knn2_ops[512],
                          "the accurate chain's first batch of BRISK operands")
    print(f"accurate chain phase on {card}: {time.perf_counter() - t_phase:.1f} s")
    return dict(
        launches=launches,
        ori_desc={"accurate_ms": od["ms"], "accurate_plain_ms": od["plain_ms"],
                  "accurate_bound_ms": od["bound_ms"],
                  "accurate_bound_by": od["bound_by"],
                  "accurate_max_abs_err": od["max_err"]},
        knn2={**{f"akaze_{k}": v for k, v in akaze_k.items()},
              **{f"brisk_{k}": v for k, v in brisk_k.items()}})


def sweep_scene(h, w, f, baseline, seed=0):
    """tests/test_plane_sweep.py's unrectified pair at (h, w): a smoothed
    uniform texture seen at depth 8 with a box at depth 4 (the test's
    box scaled with the image), the second camera shifted by `baseline`
    along x; at (96, 128, 100, 0.4) the test's pair itself. Returns
    (ref, other, K, R, t, true depth)."""
    rng = np.random.default_rng(seed)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    pad = 2 * int(np.ceil(f * baseline / 4.0))    # twice the largest disparity
    tex = rng.uniform(0, 1, (h, w + 2 * pad)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25])
    for ax in (0, 1):
        tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"),
                                  ax, tex).astype(np.float32)
    depth = np.full((h, w), 8.0, np.float32)
    depth[h * 30 // 96:h * 70 // 96, w * 40 // 128:w * 90 // 128] = 4.0
    disp = f * baseline / depth
    ref = tex[:, pad:pad + w]
    xs = np.arange(w)[None, :] + disp
    xi = np.clip(xs.astype(int), 0, w + 2 * pad - 2)
    fr = xs - xi
    row = np.arange(h)[:, None] * np.ones((1, w), int)
    other = ((1 - fr) * tex[row, np.clip(xi + pad, 0, w + 2 * pad - 1)]
             + fr * tex[row, np.clip(xi + pad + 1, 0, w + 2 * pad - 1)])
    return (ref, other.astype(np.float32), K, np.eye(3, dtype=np.float32),
            np.array([-baseline, 0, 0], np.float32), depth)


def chamfer(a, b):
    """Symmetric mean nearest-vertex distance of two vertex sets, on the
    host in chunks."""
    import torch
    if len(a) == 0 or len(b) == 0:
        return np.inf
    A, B = (torch.from_numpy(np.asarray(x, np.float64)) for x in (a, b))

    def one_way(P, Q):
        return float(torch.cat([torch.cdist(P[i:i + 4096], Q).min(1).values
                                for i in range(0, len(P), 4096)]).mean())
    return max(one_way(A, B), one_way(B, A))


def field_check(torch, dev, pts, origin, voxel, fields, chunk=4096):
    """Hold distance grids that the expanded float32 form computed (the
    same grid on each device: `fields` maps a label to (distance,
    argmin or None)) against the exact distances, float64 differences
    on the card from the same float32 centres and points. Returns, by
    label, the largest |d^2 - exact d^2| in units of eps32 (|g| + max
    |p|)^2 and the argmin misses among the clear cells (the second-
    nearest point farther by 2 CPU_DIST2_EPS of those units), and the
    clear cells' share."""
    dims = next(iter(fields.values()))[0].shape
    P = torch.from_numpy(np.asarray(pts, np.float32)).to(dev)
    axes = [torch.arange(k, dtype=torch.float32, device=dev) for k in dims]
    G = (torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
         * torch.tensor(voxel, dtype=torch.float32, device=dev)
         + torch.from_numpy(np.asarray(origin, np.float32)).to(dev))
    Pd, Gd = P.double(), G.double()
    d2, idx = [], []
    for s in range(0, len(Gd), chunk):
        top = torch.topk(((Gd[s:s + chunk, None] - Pd[None]) ** 2).sum(-1),
                         2, dim=1, largest=False)
        d2.append(top.values)
        idx.append(top.indices[:, 0])
    d2, idx = torch.cat(d2), torch.cat(idx)
    unit = (float(np.finfo(np.float32).eps)
            * (torch.linalg.norm(Gd, dim=1) + torch.linalg.norm(Pd, dim=1).max())
            ** 2)
    clear = d2[:, 1] - d2[:, 0] > 2 * CPU_DIST2_EPS * unit
    out = {}
    for label, (dist, amin) in fields.items():
        d = torch.from_numpy(np.asarray(dist)).to(dev).reshape(-1).double()
        err = float(((d * d - d2[:, 0]).abs() / unit).max())
        miss = (None if amin is None else int(
            (torch.from_numpy(np.asarray(amin)).to(dev).reshape(-1).long()
             != idx)[clear].sum()))
        out[label] = (err, miss)
    return out, float(clear.double().mean())


def icp_check(torch, pc, operands, kw, path_rt):
    """Hold the card's ICP to the CPU plain path step by step on one merge
    step's operands. The card's steps (`_icp_step` from the identity) are
    replayed and must end at the path's (R, t) bit for bit. At each of the
    card's states the CPU's correspondences must equal the card's, except
    where the exact float64 distances put the choice within the rounding
    of the float32 expanded form (CPU_DIST2_EPS eps32 (|m| + max |p|)^2 on
    each device): two dst points at a near-tie, or a nearest distance at
    max_corr_dist^2. The CPU's Kabsch on the card's correspondences must
    give the card's next state within CPU_ICP_ROT_DEG and CPU_ICP_SHIFT.
    Returns the correspondence flips, the largest flip's share of its
    rounding window (held <= 1), and the largest R and t gaps."""
    src, dst, sm, dm = operands
    iters, mcd = kw.get("iters", 20), kw["max_corr_dist"]
    R = torch.eye(3, dtype=src.dtype, device=src.device)
    t = torch.zeros(3, dtype=src.dtype, device=src.device)
    dst2 = torch.sum(dst * dst, 1)
    states, corrs = [(R, t)], []
    for _ in range(iters):
        R, t, c = pc._icp_step(src, dst, sm, dm, dst2, R, t, mcd)
        states.append((R, t))
        corrs.append(c)
    if not (torch.equal(R, path_rt[0]) and torch.equal(t, path_rt[1])):
        fail("ICP: replaying the card's steps does not give the path's "
             "(R, t)")
    s_c, d_c, sm_c, dm_c = (x.cpu() for x in operands)
    d2_c = torch.sum(d_c * d_c, 1)
    s64, d64 = s_c.double(), d_c.double()
    extent = float((d_c.max(0).values - d_c.min(0).values).max())
    pmax = float(torch.linalg.norm(d64, dim=1).max())
    eps = float(np.finfo(np.float32).eps)
    flips, share, rot, shift = 0, 0.0, 0.0, 0.0
    for k in range(iters):
        Rk, tk = (x.cpu() for x in states[k])
        jk, wk = (x.cpu() for x in corrs[k])
        _, _, (jc, wc) = pc._icp_step(s_c, d_c, sm_c, dm_c, d2_c, Rk, tk, mcd)
        rows = torch.nonzero((jc != jk) | (wc != wk))[:, 0]
        if len(rows):
            m64 = s64[rows] @ Rk.double().T + tk.double()
            da = ((m64 - d64[jk[rows]]) ** 2).sum(1)
            db = ((m64 - d64[jc[rows]]) ** 2).sum(1)
            window = 2 * CPU_DIST2_EPS * eps * (torch.linalg.norm(m64, dim=1)
                                                + pmax) ** 2
            tie = torch.where(jc[rows] != jk[rows], (da - db).abs(), 0.0)
            edge = torch.where(wc[rows] != wk[rows],
                               torch.minimum((da - mcd ** 2).abs(),
                                             (db - mcd ** 2).abs()), 0.0)
            share = max(share, float((torch.maximum(tie, edge)
                                      / window).max()))
            flips += len(rows)
        Rn, tn, _ = pc._icp_step(s_c, d_c, sm_c, dm_c, d2_c, Rk, tk, mcd,
                                 corr=(jk, wk))
        rot = max(rot, rot_err_deg(Rn.numpy(), states[k + 1][0].cpu().numpy()))
        shift = max(shift, float(torch.linalg.norm(
            tn - states[k + 1][1].cpu())) / extent)
    return flips, share, rot, shift


def run_dense_rest(torch, card, dev, sparse, images):
    """Phase 9: the rest of the dense stage on the sparse input and the
    images phase 7's chain handed its dense stage (24 views of 640x480):
    each implicit mesh method through `DenseReconstructionPipeline`,
    `run_multi_reference` with ICP merging, the plane sweep at 480x640
    with 64 planes (full and blockwise), `sgm` at the plane-sweep volume
    against its plain version, and Poisson, alpha, ball pivoting and ICP
    against the CPU plain path on the card's own cloud."""
    import tpu3drec_torch.pipelines.dense as pdense
    from tpu3drec_torch.ops import implicit as imp
    from tpu3drec_torch.ops import pallas_match as pm
    from tpu3drec_torch.ops import pallas_sample as ps
    from tpu3drec_torch.ops import pallas_sgm as psg
    from tpu3drec_torch.ops import pointcloud as pc
    from tpu3drec_torch.ops import stereo as st

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    launches = {}

    def counted(label, fn):
        reset_counts(pm, ps, psg)
        out = fn()
        torch.cuda.synchronize()
        launches[label] = kernel_counts(pm, ps, psg)["sgm"]
        return out

    # ---- each implicit mesh method on every view
    cloud = None
    for m in IMPLICIT_METHODS:
        pipe = pdense.DenseReconstructionPipeline(mesh_method=m, device=None)
        t0 = time.perf_counter()
        res = counted(m, lambda: pipe.run_complete_pipeline(sparse, images))
        wall = time.perf_counter() - t0
        mesh, t = res["mesh"], res["timings_s"]
        print(f"implicit mesh {m} on {res['num_views']} views (reference "
              f"{res['reference_view']}): {wall:.3f} s; seconds: stereo "
              f"{t['stereo']:.3f}, point cloud {t['point_cloud']:.3f}, mesh "
              f"{t['mesh']:.3f}; cloud {res['point_cloud']['num_points']} "
              f"points; mesh method used {mesh['method']}, "
              f"{mesh['num_faces']} faces, {mesh['num_vertices']} vertices, "
              f"area {mesh['surface_area']:.4f}, watertight "
              f"{mesh['is_watertight']}, boundary edges "
              f"{mesh.get('boundary_edges')}, non-manifold edges "
              f"{mesh.get('nonmanifold_edges')}; sgm launches {launches[m]}")
        if m == "ball_pivot" and mesh["method"] == "depth_grid":
            # the reference's degraded mode for an empty mesh, and only it
            own = imp.ball_pivot_mesh(pipe._arrays["points"],
                                      pipe._arrays["normals"], device=dev)
            print(f"implicit mesh {m}: the mesher's own mesh of this cloud "
                  f"has {len(own['faces'])} faces (radius "
                  f"{own['radius']:.4f}, voxel {own['voxel']:.4f}), so the "
                  f"pipeline took the depth-grid mesh")
            if len(own["faces"]):
                fail(f"implicit mesh {m}: the pipeline fell back although "
                     f"the mesher's mesh is not empty")
        elif mesh["method"] != m:
            fail(f"implicit mesh {m}: the pipeline fell back to "
                 f"{mesh['method']}")
        elif mesh["num_faces"] < IMPLICIT_FACES_BAR[m]:
            fail(f"implicit mesh {m}: fewer than {IMPLICIT_FACES_BAR[m]} "
                 f"faces")
        if res["point_cloud"]["num_points"] < FOLDER_CLOUD_BAR:
            fail(f"implicit mesh {m}: fewer than {FOLDER_CLOUD_BAR} cloud "
                 f"points")
        if launches[m] == 0:
            fail(f"implicit mesh {m}: the run never launched the sgm kernel")
        if cloud is None:
            cloud = (pipe._arrays["points"], pipe._arrays["normals"])
        del pipe, res

    # ---- multi-reference mode; a spy keeps each ICP step's operands
    icp_calls = []
    icp_entry = pc.icp_register

    def icp_spy(src, dst, src_mask, dst_mask, *a, **k):
        R, t = icp_entry(src, dst, src_mask, dst_mask, *a, **k)
        icp_calls.append(((src, dst, src_mask, dst_mask), k, (R, t)))
        return R, t

    pc.icp_register = icp_spy
    try:
        pipe = pdense.DenseReconstructionPipeline(mesh_method="poisson",
                                                  device=None)
        t0 = time.perf_counter()
        res = counted("multi_reference", lambda: pipe.run_multi_reference(
            sparse, images, num_refs=MULTI_REFS))
        wall = time.perf_counter() - t0
    finally:
        pc.icp_register = icp_entry
    steps = []
    for (src, dst, sm, _), _, (R, t) in icp_calls:
        extent = float((dst.max(0).values - dst.min(0).values).max())
        moved = torch.linalg.norm(src[sm] @ R.T + t - src[sm], dim=1)
        steps.append((rot_err_deg(R.cpu().numpy(), np.eye(3)),
                      float(torch.linalg.norm(t)) / extent,
                      float(moved.median()), float(moved.median()) / extent))
    mesh = res["mesh"]
    print(f"multi-reference ({MULTI_REFS} references "
          f"{res['reference_views']}): {wall:.3f} s; points per reference "
          + ", ".join(f"{k} {v['num_points']}" for k, v in
                      res["per_reference"].items())
          + f"; merged {res['point_cloud']['num_points']}; mesh "
          f"{mesh['method']}, {mesh['num_faces']} faces, "
          f"{mesh['num_vertices']} vertices, area {mesh['surface_area']:.4f};"
          f" ICP steps (rotation deg, translation / extent, median "
          f"displacement of the moved points, the same / extent): "
          + ", ".join(f"({a:.5f}, {b:.6f}, {c:.4f}, {e:.6f})"
                      for a, b, c, e in steps)
          + " (printed, not held)"
          + f"; sgm launches {launches['multi_reference']}")
    if len(res["reference_views"]) != MULTI_REFS or mesh["method"] != "poisson" \
            or mesh["num_faces"] < MULTI_FACES_BAR \
            or len(steps) != MULTI_REFS - 1:
        fail("multi-reference: fewer references, ICP steps or faces than "
             "asked, or a fallback mesh")
    if launches["multi_reference"] == 0:
        fail("multi-reference: the run never launched the sgm kernel")
    del pipe, res

    # ---- the plane sweep at full size, and sgm at its volume
    ref, other, K, R, t, depth = sweep_scene(SWEEP_H, SWEEP_W, SWEEP_F,
                                             SWEEP_B)
    ref_d, other_d = (torch.tensor(a, device=dev) for a in (ref, other))
    interior = np.zeros((SWEEP_H, SWEEP_W), bool)
    interior[SWEEP_H // 12:-SWEEP_H // 12, SWEEP_W // 8:-SWEEP_W // 16] = True
    sweep = {}
    for variant, fn in (("full", st.plane_sweep_depth),
                        ("blockwise", st.plane_sweep_depth_blockwise)):
        def call(fn=fn):
            return fn(ref_d, other_d, K, K, R, t, 2.0, 16.0,
                      num_planes=SWEEP_PLANES)
        r = counted(f"plane_sweep_{variant}", call)
        v = r.valid.cpu().numpy()
        d = r.depth.cpu().numpy()
        m = v & interior
        rel = np.abs(d - depth)[m] / depth[m]
        ms = cuda_ms(torch, call, reps=3)
        sweep[variant] = ms
        print(f"plane sweep ({variant}) at {SWEEP_W}x{SWEEP_H}, "
              f"{SWEEP_PLANES} planes: {ms:.3f} ms per call (CUDA events); "
              f"valid on {m.mean():.4f} of the image inside the border (bar "
              f"> {SWEEP_VALID_BAR}), median relative depth error "
              f"{np.median(rel) if len(rel) else np.inf:.5f} (bar < "
              f"{SWEEP_REL_ERR_BAR}); sgm launches "
              f"{launches[f'plane_sweep_{variant}']}")
        if not m.mean() > SWEEP_VALID_BAR or not np.median(rel) < SWEEP_REL_ERR_BAR:
            fail(f"plane sweep ({variant}) misses the test's bars")
        if not torch.isfinite(r.depth).all():
            fail(f"plane sweep ({variant}): non-finite depth")
    if launches["plane_sweep_full"] == 0:
        fail("plane sweep: the full sweep never launched the sgm kernel")

    seen = []
    real = st.sgm_aggregate_batch

    def recorder(volumes, *a, **k):
        seen.append(volumes.clone())
        return real(volumes, *a, **k)

    st.sgm_aggregate_batch = recorder
    try:
        st.plane_sweep_depth(ref_d, other_d, K, K, R, t, 2.0, 16.0,
                             num_planes=SWEEP_PLANES)
    finally:
        st.sgm_aggregate_batch = real
    if len(seen) != 1 or tuple(seen[0].shape) != (1, SWEEP_PLANES, SWEEP_H,
                                                  SWEEP_W):
        fail(f"plane sweep: expected one sgm call at (1, {SWEEP_PLANES}, "
             f"{SWEEP_H}, {SWEEP_W}), saw {[tuple(v.shape) for v in seen]}")
    vol = seen[0]
    err = sgm_equal(torch, psg, vol, "the plane-sweep volume")
    err = max(err, sgm_equal(torch, psg, vol, "the plane-sweep volume"))
    sgm_ms = cuda_ms(torch, lambda: psg.sgm_aggregate_batch(vol))
    plain_ms = cuda_ms(torch, lambda: psg.sgm_aggregate_batch_plain(vol),
                       reps=1)
    n = vol.numel()
    t_bytes = 2 * n * 4 / PEAK_BYTES_PER_S * 1e3
    t_ops = SGM_FLOPS_PER_ELEMENT * n / PEAK_F32_OPS * 1e3
    print(f"sgm vs plain at the plane-sweep volume {tuple(vol.shape)}: "
          f"bit-equal (torch.equal) twice, each twice launched "
          f"bit-identical; {sgm_ms:.4f} ms per call (CUDA events), plain "
          f"{plain_ms:.3f} ms, bound {max(t_bytes, t_ops):.4f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    del seen, vol, ref_d, other_d

    # ---- the card against the CPU plain path on the card's own cloud
    t0 = time.perf_counter()
    pts, nrm = cloud
    a, b = (imp.poisson_mesh(pts, nrm, device=d) for d in (dev, cpu))
    chi_err = float(np.abs(a["chi"] - b["chi"]).max())
    chi_scale = float(np.abs(b["chi"]).max())
    cham = chamfer(a["verts"], b["verts"]) / b["voxel"]
    print(f"Poisson, card vs CPU plain path on the card's cloud ({len(pts)} "
          f"points, grid {b['chi'].shape}): chi within {chi_err:.3e} (bar "
          f"{CPU_CHI_ATOL} x {chi_scale:.4e}), iso {a['iso']:.8f} vs "
          f"{b['iso']:.8f}, faces {len(a['faces'])} vs {len(b['faces'])}, "
          f"vertex Chamfer {cham:.5f} voxel")
    if chi_err > CPU_CHI_ATOL * chi_scale \
            or abs(a["iso"] - b["iso"]) > CPU_ISO_RTOL * abs(b["iso"]) \
            or abs(len(a["faces"]) - len(b["faces"])) > CPU_FACES_RTOL * len(b["faces"]) \
            or not cham < CPU_CHAMFER_VOXELS:
        fail("Poisson: the card disagrees with the CPU plain path")
    sel = np.random.default_rng(0).choice(len(pts), CPU_SUBSAMPLE,
                                          replace=False)
    sub, sub_n = pts[sel], nrm[sel]
    alpha = max(3.0 * imp._median_nn_spacing(sub), 1e-6)
    # a ball a few voxels wide (at the meshers' default resolution, 96),
    # so that both devices mesh the subsample
    radius = CPU_BALL_RADIUS_VOXELS * float(np.ptp(sub, 0).max()) / 95
    uob = {d.type: imp._uob_field(sub, radius, 96, device=d)
           for d in (dev, cpu)}
    for name, fn in (("alpha", lambda d: imp.alpha_surface_mesh(
                         sub, alpha, device=d)),
                     ("ball_pivot", lambda d: imp.ball_pivot_mesh(
                         sub, sub_n, radius=radius, device=d))):
        a, b = fn(dev), fn(cpu)
        fields = {"card": (a["distance"], None), "cpu": (b["distance"], None)}
        if name == "ball_pivot":    # its grid is _uob_field's at `radius`
            fields = {k: uob[d.type][:2] for k, d in
                      (("card", dev), ("cpu", cpu))}
        held, clear = field_check(torch, dev, sub, b["origin"], b["voxel"],
                                  fields)
        cham = chamfer(a["verts"], b["verts"]) / b["voxel"]
        print(f"{name}, card vs CPU plain path on {CPU_SUBSAMPLE} points of "
              f"the card's cloud (grid {b['distance'].shape}, "
              + (f"alpha {alpha:.4f}" if name == "alpha" else
                 f"radius {radius:.4f}")
              + f", voxel {b['voxel']:.4f}): distances card vs CPU within "
              f"{np.abs(a['distance'] - b['distance']).max():.3e}; |d^2 - "
              f"exact| up to {held['card'][0]:.4f} (card) and "
              f"{held['cpu'][0]:.4f} (CPU) eps32 (|g| + max |p|)^2 (bar "
              f"{CPU_DIST2_EPS})"
              + (f"; argmin misses on the {clear:.4f} clear share of the "
                 f"cells (bar >= {CPU_CLEAR_SHARE}): {held['card'][1]} "
                 f"(card), {held['cpu'][1]} (CPU)" if name == "ball_pivot"
                 else "")
              + f"; faces {len(a['faces'])} vs {len(b['faces'])}, vertex "
              f"Chamfer {cham:.5f} voxel")
        if any(e > CPU_DIST2_EPS or m for e, m in held.values()) \
                or (name == "ball_pivot" and not clear >= CPU_CLEAR_SHARE):
            fail(f"{name}: a distance grid misses the exact one")
        if not len(b["faces"]) \
                or abs(len(a["faces"]) - len(b["faces"])) > CPU_FACES_RTOL * len(b["faces"]) \
                or not cham < CPU_CHAMFER_VOXELS:
            fail(f"{name}: the card disagrees with the CPU plain path, or "
                 f"the mesh is empty")
    for i, (ops, kw, rt) in enumerate(icp_calls):
        flips, share, rot, shift = icp_check(torch, pc, ops, kw, rt)
        print(f"ICP merge step {i + 1}, card vs CPU plain path step by step "
              f"({len(ops[0])} x {len(ops[1])} points, {kw.get('iters', 20)}"
              f" steps): the card's replay ends at the path's (R, t) bit for "
              f"bit; {flips} correspondences differ, the farthest at "
              f"{share:.4f} of its rounding window (bar <= 1); Kabsch on the "
              f"card's correspondences within {rot:.2e} deg (bar "
              f"{CPU_ICP_ROT_DEG}) and {shift:.2e} of the extent (bar "
              f"{CPU_ICP_SHIFT})")
        if not share <= 1.0 or not rot < CPU_ICP_ROT_DEG \
                or not shift < CPU_ICP_SHIFT:
            fail("ICP: the card disagrees with the CPU plain path")
    (src, dst, sm, dm), kw, (R, t) = icp_calls[0]
    Rh, th = pc.icp_register(src.cpu(), dst.cpu(), sm.cpu(), dm.cpu(), **kw)
    extent = float((dst.max(0).values - dst.min(0).values).max())
    dR = rot_err_deg(R.cpu().numpy(), Rh.numpy())
    dt = float(torch.linalg.norm(t.cpu() - th)) / extent
    print(f"ICP merge step 1 end to end, card vs CPU plain path from the "
          f"identity: R within {dR:.2e} deg, t within {dt:.2e} of the extent "
          f"(printed, not held: a correspondence flipped at a near-tie "
          f"changes every later step) ({time.perf_counter() - t0:.1f} s for "
          f"the comparisons)")
    print(f"dense rest phase on {card}: {time.perf_counter() - t_phase:.1f} s")
    return dict(
        launches=launches,
        sgm={"sweep_ms": sgm_ms, "sweep_plain_ms": plain_ms,
             "sweep_bound_ms": max(t_bytes, t_ops),
             "sweep_bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "sweep_max_abs_err": err,
             "sweep_shape": [1, SWEEP_PLANES, SWEEP_H, SWEEP_W],
             "sweep_full_ms": sweep["full"],
             "sweep_blockwise_ms": sweep["blockwise"]})


def deep_weights(torch, path):
    """Random full-width networks from one seeded CPU generator, written
    through `models._params` as the JAX package's converters write them
    (SuperPoint, DISK, ALIKED-n16 as aliked.npz, LightGlue for 256-d and
    128-d descriptors). Returns the networks (on the CPU)."""
    from tpu3drec_torch.models import aliked_n16, disk, lightglue, superpoint
    gen = torch.Generator().manual_seed(DEEP_SEED)
    nets = {"SuperPoint": superpoint.SuperPoint().init_random(gen),
            "DISK": disk.DISK().init_random(gen),
            "ALIKED": aliked_n16.ALIKEDN16().init_random(gen)}
    superpoint.save_weights(nets["SuperPoint"], path / "superpoint.npz")
    disk.save_weights(nets["DISK"], path / "disk.npz")
    aliked_n16.save_weights(nets["ALIKED"], path / "aliked.npz")
    for d in (256, 128):
        nets[f"lightglue_d{d}"] = net = lightglue.LightGlue(
            input_dim=d, **DEEP_LG).init_random(gen)
        lightglue.save_weights(net, path / f"lightglue_d{d}.npz")
    return nets


def deep_extract(torch, method, net, imgs, precision):
    """(Features, the score map before NMS, read off the network's
    output) of the registry's extractor for `method` at the preset's
    parameters around `net`."""
    from tpu3drec_torch.models import disk, superpoint
    if method == "SuperPoint":
        ext = superpoint.SuperPoint(net, max_features=MAX_FEATURES,
                                    keypoint_threshold=0.005, nms_radius=4,
                                    matmul_precision=precision)
    else:
        ext = disk.DISK(net, max_features=MAX_FEATURES,
                        matmul_precision=precision)
    seen = []
    hook = net.register_forward_hook(lambda mod, a, out: seen.append(out[0]))
    try:
        f = ext.extract(imgs)
    finally:
        hook.remove()
    h, w = imgs.shape[-2:]
    return f, seen[0][:, :h, :w]


def clear_keypoints(torch, f, heat, radius, threshold, bar):
    """Valid keypoints (B, K) whose score beats every other pixel of its
    window, the list's last score (when every slot is valid) and the
    threshold by more than `bar`: a float32 run elsewhere finds them too."""
    import torch.nn.functional as F
    B, K = f.mask.shape
    w = heat.shape[-1]
    r = radius
    pad = F.pad(heat, (r, r, r, r), value=-float("inf")).flatten(1)
    xi, yi = f.xy[..., 0].long(), f.xy[..., 1].long()
    idx = torch.stack([(yi + r + dy) * (w + 2 * r) + xi + r + dx
                       for dy in range(-r, r + 1) for dx in range(-r, r + 1)
                       if dy or dx], -1)
    second = pad.gather(1, idx.reshape(B, -1)).reshape(B, K, -1).amax(-1)
    s = f.response
    last = torch.where(f.mask.all(1), s[:, -1],
                       torch.full_like(s[:, -1], -float("inf")))
    return (f.mask & (s - second > bar) & (s - last[:, None] > bar)
            & ((s - threshold).abs() > bar))


def deep_agreement(torch, got, ref, clear_got, clear_ref):
    """(the share of each run's clear keypoints the other found, the
    lower of the two; the largest score gap and the smallest descriptor
    cosine over the keypoints both found), keypoints matched by position."""
    shares, gaps, coss = [], [], []
    for b in range(ref.mask.shape[0]):
        pos = [{tuple(f.xy[b, i].tolist()): i
                for i in torch.nonzero(f.mask[b]).flatten().tolist()}
               for f in (got, ref)]
        for clear, f, other in ((clear_ref, ref, pos[0]),
                                (clear_got, got, pos[1])):
            keys = [tuple(f.xy[b, i].tolist())
                    for i in torch.nonzero(clear[b]).flatten().tolist()]
            shares.append(sum(k in other for k in keys) / max(len(keys), 1))
        both = [(i, pos[0][k]) for k, i in pos[1].items() if k in pos[0]]
        ri, gi = (torch.tensor(c, dtype=torch.long) for c in zip(*both))
        gaps.append(float((got.response[b, gi] - ref.response[b, ri]).abs().max()))
        coss.append(float(torch.nn.functional.cosine_similarity(
            got.desc[b, gi].double(), ref.desc[b, ri].double(), dim=-1).min()))
    return min(shares), max(gaps), min(coss)


def lg_run(torch, net, f0, f1, dev, precision):
    """LightGlue on one pair on `dev`: (log-assignment (N0, N1) and its
    mutual matches at threshold 0, all on the CPU)."""
    from tpu3drec_torch.models.lightglue import (
        LightGlue, assignment_matches, normalize_keypoints,
    )
    f0, f1 = f0.to(dev), f1.to(dev)
    la = LightGlue(net, matmul_precision=precision).forward(
        f0.desc[None], f1.desc[None], normalize_keypoints(f0.xy, H, W)[None],
        normalize_keypoints(f1.xy, H, W)[None], f0.mask[None],
        f1.mask[None])[0]
    m = assignment_matches(la, f0.mask[None], f1.mask[None], 0.0)
    return la[0].cpu(), m.idx2[0].cpu(), m.mask[0].cpu()


def lg_near_ties(torch, la, f0, f1, bar):
    """Rows whose mutual match may differ between two float32 runs
    within `bar` of log-assignment: the row's top two, or its best
    column's top two, within bar."""
    la = torch.where(f0.mask[:, None] & f1.mask[None, :], la,
                     torch.full_like(la, -1e30))
    top = la.topk(2, dim=1).values
    col = la.topk(2, dim=0).values[:, la.argmax(1)]
    return (top[:, 0] - top[:, 1] < bar) | (col[0] - col[1] < bar)


def knn2_f32_check(torch, pm, ops, label):
    """knn2's float32 kernel on operands the folder engine handed it,
    against the plain version on the card: distances within KNN2_F32_TOL
    (relative and absolute), the best index equal wherever the exact top
    two are farther apart than that, the second wherever the second and
    third are too; timed beside the plain version, the library call
    (f32 bmm + topk, TF32 off) and the bound."""
    a, b, n2, m2 = ops
    i_k, v_k = pm.knn2_raw(a, b, n2, m2)
    i_p, v_p = pm.knn2_plain(a, b, n2, m2)
    sq1 = (a * a).sum(-1)[..., None]

    def dist(v):
        return torch.sqrt(torch.clamp(v + sq1, min=0))
    raw = torch.where(m2[:, None, :],
                      n2[:, None, :] - 2 * torch.matmul(a, b.transpose(1, 2)),
                      torch.full((), pm.F32_BIG, device=a.device))
    d3 = dist(raw.topk(3, dim=-1, largest=False).values)
    del raw
    dk, dp = dist(v_k), dist(v_p)
    if not torch.allclose(dk, dp, rtol=KNN2_F32_TOL, atol=KNN2_F32_TOL):
        fail(f"knn2 f32: distances differ from the plain version at {label}")
    valid = m2.sum(-1)[:, None] >= 3
    tol = KNN2_F32_TOL * d3[..., 2] + KNN2_F32_TOL
    c1 = valid & (d3[..., 1] - d3[..., 0] > tol)
    c2 = c1 & (d3[..., 2] - d3[..., 1] > tol)
    if not (torch.equal(i_k[..., 0][c1], i_p[..., 0][c1])
            and torch.equal(i_k[..., 1][c2], i_p[..., 1][c2])):
        fail(f"knn2 f32: indices differ from the plain version away from "
             f"near-ties at {label}")
    err = float((dk - dp).abs().max())
    ms = cuda_ms(torch, lambda: pm.knn2_raw(a, b, n2, m2))
    plain = cuda_ms(torch, lambda: pm.knn2_plain(a, b, n2, m2), reps=2)
    f32, _ = knn2_library(torch, a, b, n2, m2)
    lib = cuda_ms(torch, f32, reps=2)
    Bp, N, D = a.shape
    m_valid = int(m2.sum())
    bytes_ = (4 * Bp * N * D + m_valid * (4 * D + 4) + m2.numel()
              + Bp * N * 2 * 8)
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = 2.0 * N * m_valid * D / PEAK_F32_OPS * 1e3
    bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"knn2 f32 at {label} {tuple(a.shape)} x {tuple(b.shape)} "
          f"({m_valid} of {m2.numel()} columns valid): distances within "
          f"{KNN2_F32_TOL} of the plain version (max |err| {err:.3e}); best "
          f"index equal on all {int(c1.sum())} rows clear of a near-tie, "
          f"second on {int(c2.sum())} (of {c1.numel()} rows); "
          f"{ms:.4f} ms per call (CUDA events), plain {plain:.3f} ms, "
          f"f32 bmm + topk {lib:.3f} ms, bound {bound:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib, max_abs_err=err)


def deep_folder_engine(torch, card, dev, tmp, names):
    """The `deep_learning` preset's folder engine at its defaults, cold
    with knn2's launches and first-batch operands recorded, then timed;
    one batch's detection seconds per method and a profiled batch."""
    import tpu3drec_torch as tv
    from tpu3drec_torch.api import _get_detector_registry
    from tpu3drec_torch.io.images import FolderImageSource
    from tpu3drec_torch.ops import match as mt
    from tpu3drec_torch.ops import pallas_match as pm
    from tpu3drec_torch.ops import pallas_sample as ps
    from tpu3drec_torch.ops import pallas_sgm as psg
    folder = os.path.join(tmp, "imgs")
    pipe = tv.create_pipeline(DEEP_PRESET, device=dev)
    if pipe.methods != ["SuperPoint", "DISK"]:
        fail(f"deep_learning preset: methods {pipe.methods}")
    calls, ops, _, restore = spy_kernel_inputs(mt, ps)
    try:
        reset_counts(pm, ps, psg)
        t0 = time.perf_counter()
        cold = pipe.match_folder(folder, os.path.join(tmp, "deep_cold"),
                                 resume=False)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = kernel_counts(pm, ps, psg)["knn2"]
    finally:
        restore()
    by_method = {DEEP_DEPTH_METHOD.get(d, d): n for d, n in sorted(calls.items())}
    print(f"deep folder engine, cold run: knn2 launches {launches}; knn2 "
          f"calls by method (l2, float32): {by_method}")
    if launches == 0 or launches != sum(calls.values()) \
            or set(by_method) != {"SuperPoint", "DISK"}:
        fail("the deep folder engine did not launch knn2's float32 kernel "
             "on every SuperPoint and DISK call")
    t0 = time.perf_counter()
    steady = pipe.match_folder(folder, os.path.join(tmp, "deep_steady"),
                               resume=False)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    for summary in (cold, steady):
        st = summary["stats"]
        if st["engine_fallbacks"] or st["failed"] or st["method_errors"] \
                or st["completed"] != st["total_pairs"]:
            fail(f"deep folder engine: {st}")
    print(f"deep folder engine ({DEEP_PRESET}: SuperPoint + DISK at "
          f"{MAX_FEATURES} features, kNN): {len(names) / steady_s:.4f} "
          f"images/s, {st['total_pairs'] / steady_s:.3f} pairs/s "
          f"({steady_s:.2f} s steady, {st['total_pairs']} pairs; cold "
          f"{cold_s:.2f} s); mean raw matches: "
          + ", ".join(f"{k} {v['mean_raw_matches']:.1f}"
                      for k, v in steady["methods"].items())
          + f"; on {card}")

    pairs = [(names[i], names[i + 1]) for i in range(len(names) - 1)]
    batch = pairs[:FOLDER_BATCH]
    images = FolderImageSource(folder).load_many(
        sorted({n for p in batch for n in p}))
    stack = torch.stack([tv.prepare_image(images[n], dev)
                         for n in sorted(images)])
    det_s = {}
    for m in pipe.methods:
        det = _get_detector_registry()[m]
        det(stack, max_features=MAX_FEATURES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            det(stack, max_features=MAX_FEATURES)
        torch.cuda.synchronize()
        det_s[m] = (time.perf_counter() - t0) / 3
    print(f"deep detection, one batch of {stack.shape[0]} images of "
          f"{W}x{H}: " + ", ".join(f"{m} {s:.4f} s" for m, s in det_s.items())
          + " (host clock, mean of 3)")
    profile_call(torch, lambda: pipe._match_pairs_batched(images, batch),
                 "deep.", top=8)
    return dict(launches=launches, ops=ops, images=images, pairs=pairs,
                stack=stack, launches_by_method={
                    f"deep_folder_{m.lower()}": n for m, n in by_method.items()})


def deep_per_pair(torch, dev, images, pairs, stack, nets):
    """LightGlue on the per-pair path with SuperPoint, DISK and
    ALIKED-n16; its ms per pair at 2,048 keypoints, and a profiled call."""
    import copy
    import tpu3drec_torch as tv
    from tpu3drec_torch.models import lightglue
    pp = tv.create_pipeline(DEEP_PRESET, {
        "methods": list(DEEP_PERPAIR_METHODS),
        "matcher_config": {m: "lightglue" for m in DEEP_PERPAIR_METHODS}},
        device=dev)
    counts = {m: [] for m in DEEP_PERPAIR_METHODS}
    t0 = time.perf_counter()
    for n1, n2 in pairs[:DEEP_PERPAIR]:
        res = pp.match(images[n1], images[n2], n1, n2)
        for m in DEEP_PERPAIR_METHODS:
            r = res[m]
            if r.error or r.matcher_used != "lightglue" \
                    or r.matches.score_type != "confidence":
                fail(f"per-pair {m}: error {r.error!r}, matcher "
                     f"{r.matcher_used!r}")
            counts[m].append(r.num_raw_matches)
    torch.cuda.synchronize()
    print(f"per-pair path, {DEEP_PERPAIR} pairs x {len(DEEP_PERPAIR_METHODS)} "
          f"methods with LightGlue ({time.perf_counter() - t0:.2f} s): "
          "matches above confidence 0.1 "
          + "; ".join(f"{m} {v}" for m, v in counts.items()))
    f, _ = deep_extract(torch, "SuperPoint", copy.deepcopy(
        nets["SuperPoint"]).to(dev), stack[:2], "default")
    fa = [f.replace(**{k: getattr(f, k)[i] for k in (
        "xy", "response", "scale", "angle", "desc", "mask")}) for i in range(2)]
    ms = cuda_ms(torch, lambda: lightglue.match_features_lightglue(*fa))
    print(f"LightGlue (dim 256, 9 layers, 4 heads, TF32) on one pair of "
          f"{MAX_FEATURES} SuperPoint keypoints ({int(fa[0].mask.sum())} and "
          f"{int(fa[1].mask.sum())} valid): {ms:.3f} ms per pair (CUDA "
          f"events)")
    profile_call(torch, lambda: lightglue.match_features_lightglue(*fa),
                 "lightglue.", top=8)


def lg_mutual_counts(torch, dev, imgs, nets, precision):
    """LightGlue's mutual matches (threshold 0) on the consecutive pairs
    of `imgs`, SuperPoint's and DISK's features each, all on the card at
    `precision`: the count summed over the matchings."""
    import copy
    n = 0
    for m, d in (("SuperPoint", 256), ("DISK", 128)):
        f, _ = deep_extract(torch, m, copy.deepcopy(nets[m]).to(dev), imgs,
                            precision)
        lg = copy.deepcopy(nets[f"lightglue_d{d}"]).to(dev)
        one = [f.replace(**{k: getattr(f, k)[i] for k in (
            "xy", "response", "scale", "angle", "desc", "mask")})
            for i in range(imgs.shape[0])]
        for a, b in zip(one, one[1:]):
            n += int(lg_run(torch, lg, a, b, dev, precision)[2].sum())
    return n


def deep_card_vs_cpu(torch, dev, imgs, nets):
    """SuperPoint and DISK on two images, and LightGlue on their pair, on
    the card against the CPU plain path at "highest", and the same on the
    card at "default" (TF32) printed; LightGlue's mutual-match count over
    the consecutive pairs of `imgs` held at TF32."""
    import copy
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    two = imgs[:2]
    feats = {}
    for m in ("SuperPoint", "DISK"):
        net_c = copy.deepcopy(nets[m]).to(dev)
        ref, heat = deep_extract(torch, m, nets[m], two.cpu(), "highest")
        radius, thr = (4, 0.005) if m == "SuperPoint" else (2, 0.0)
        bar = DEEP_SCORE_BAR[m] * (1.0 if m == "SuperPoint"
                                   else float(heat.abs().max()))
        clear_ref = clear_keypoints(torch, ref, heat, radius, thr, bar)
        for prec in ("highest", "default"):
            got, heat_g = deep_extract(torch, m, net_c, two, prec)
            got, heat_g = got.to(cpu), heat_g.cpu()
            share, gap, cos = deep_agreement(
                torch, got, ref,
                clear_keypoints(torch, got, heat_g, radius, thr, bar),
                clear_ref)
            print(f"{m} card ({prec}) vs CPU plain path on 2 images: "
                  f"{int(got.mask.sum())} vs {int(ref.mask.sum())} "
                  f"keypoints, {int(clear_ref.sum())} clear by {bar:.3g}; "
                  f"{100 * share:.3f}% of each run's clear ones found by "
                  f"the other, score gap {gap:.3e}, descriptor cosine >= "
                  f"{cos:.7f}")
            if prec == "highest" and (share < 1.0 or gap > bar
                                      or cos < DEEP_COS_BAR):
                fail(f"{m}: the card's extraction disagrees with the CPU "
                     f"plain path")
        feats[m] = ref
    f0, f1 = (feats["SuperPoint"].replace(**{
        k: getattr(feats["SuperPoint"], k)[i] for k in
        ("xy", "response", "scale", "angle", "desc", "mask")})
        for i in range(2))
    net = nets["lightglue_d256"]
    la_r, i_r, m_r = lg_run(torch, net, f0, f1, cpu, "highest")
    la64, _, _ = lg_run(torch, copy.deepcopy(net).double(),
                        *(f.replace(desc=f.desc.double(), xy=f.xy.double())
                          for f in (f0, f1)), cpu, "highest")
    v = f0.mask[:, None] & f1.mask[None, :]
    err32 = float((la_r.double() - la64)[v].abs().max())
    bar = DEEP_LG_ERR_X * err32
    held = ~lg_near_ties(torch, la_r, f0, f1, bar)
    net_c = copy.deepcopy(net).to(dev)
    for prec in ("highest", "default"):
        la_g, i_g, m_g = lg_run(torch, net_c, f0, f1, dev, prec)
        gap = float((la_g - la_r).abs()[v].max())
        differ = int(((i_g != i_r) | (m_g != m_r))[held].sum())
        print(f"LightGlue card ({prec}) vs CPU plain path on one pair: "
              f"log-assignment within {gap:.3e} on the valid block (bar "
              f"{bar:.3e} = {DEEP_LG_ERR_X} x the CPU's float32 error "
              f"{err32:.3e} against float64); mutual matches "
              f"{int(m_g.sum())} vs {int(m_r.sum())}, {differ} of "
              f"{int(held.sum())} rows clear of near-ties differ")
        if prec == "highest" and (not gap <= bar or differ):
            fail("LightGlue: the card disagrees with the CPU plain path")
    print(f"card vs CPU comparisons: {time.perf_counter() - t0:.1f} s")
    counts = {p: lg_mutual_counts(torch, dev, imgs, nets, p)
              for p in ("highest", "default")}
    print(f"LightGlue mutual matches over {imgs.shape[0] - 1} consecutive "
          f"pairs x (SuperPoint, DISK) on the card: {counts['default']} at "
          f"TF32 vs {counts['highest']} at highest (bar: within "
          f"{100 * DEEP_TF32_COUNT_RTOL:.0f}%)")
    if abs(counts["default"] - counts["highest"]) \
            > DEEP_TF32_COUNT_RTOL * counts["highest"]:
        fail(f"LightGlue at TF32: the match count moved more than "
             f"{100 * DEEP_TF32_COUNT_RTOL:.0f}%")


def run_deep(torch, card, dev, tmp, names):
    """Phase 10: the deep models on the folder in `tmp`/imgs: the
    `deep_learning` preset's folder engine (SuperPoint + DISK, kNN through
    knn2's float32 path), LightGlue on the per-pair path with SuperPoint,
    DISK and ALIKED-n16, the card against the CPU plain path at
    "highest" and a TF32 pass, and knn2 at the engine's operands."""
    from pathlib import Path
    from tpu3drec_torch import models
    from tpu3drec_torch.models import lightglue
    from tpu3drec_torch.ops import pallas_match as pm
    t_phase = time.perf_counter()
    wd = Path(tmp) / "weights"
    nets = deep_weights(torch, wd)
    # every weights lookup reads this attribute: the phase points it at
    # its own checkpoints and restores it
    saved, models.WEIGHTS_DIR = models.WEIGHTS_DIR, wd
    lightglue._LG_CACHE.clear()
    try:
        eng = deep_folder_engine(torch, card, dev, tmp, names)
        deep_per_pair(torch, dev, eng["images"], eng["pairs"], eng["stack"],
                      nets)
        deep_card_vs_cpu(torch, dev, eng["stack"][:DEEP_PERPAIR + 1], nets)
    finally:
        models.WEIGHTS_DIR = saved
        lightglue._LG_CACHE.clear()
    knn2 = {}
    for d, m in sorted(DEEP_DEPTH_METHOD.items(), reverse=True):
        r = knn2_f32_check(torch, pm, eng["ops"][d],
                           f"the deep folder's first batch of {m} operands")
        knn2.update({f"deep_{m.lower()}_{k}": v for k, v in r.items()})
    print(f"deep phase on {card}: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=eng["launches"], knn2=knn2,
                launches_by_method=eng["launches_by_method"])


# phase 11: the user surface
SERVE_SHAPE = (480, 640)
SERVE_FEATURES = 1024
SERVE_REQUESTS = 16
SERVE_THREADS = 8
SERVE_CORNER_PX = 2.0         # phase 3's bar, on >= 90% of the answers
SERVE_B64_EVERY = 4           # every 4th request as base64 PNG files
# card vs CPU through the batcher: the share of the CPU's rows that must
# be clear of the ratio test's near-ties, so that the row-by-row check
# covers most rows (on an H100 at 700 W: 68.91% with keypoints paired
# within 1e-4 px, 96.35-100% paired within SERVE_PAIR_PX)
SERVE_HELD_SHARE = 0.6
SERVE_PAIR_PX = 1e-2          # card vs CPU: one keypoint on both devices
SUBPROCESS_TIMEOUT_S = 300
BENCH_METHODS = ("SIFT", "ORB")
BENCH_RUNS = 2


def last_json(text):
    """The last JSON object printed (the CLI prints it indented)."""
    at = text.rfind("\n{")
    return json.loads(text[at + 1 if at >= 0 else text.index("{"):])


def cli_auto(torch, dev, tmp, folder, here, pm, ps, psg):
    """`auto --dense` through `cli.main` in this process (counters reset,
    each must launch) and once as `python -m tpu3drec_torch` in a
    subprocess; both must register the same number of cameras."""
    import contextlib
    import io
    from tpu3drec_torch import cli
    buf = io.StringIO()
    reset_counts(pm, ps, psg)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["auto", folder, os.path.join(tmp, "auto_in"),
                       "--dense", "--device", str(dev)])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    in_s = time.perf_counter() - t0
    launches = kernel_counts(pm, ps, psg)
    out = last_json(buf.getvalue())
    print(f"cli auto --dense in process: rc {rc}, {out['cameras']} cameras, "
          f"{out['points']} points, {in_s:.2f} s; launches {launches}")
    if rc != 0:
        fail(f"cli auto --dense exited {rc}")
    for name, n in launches.items():
        if n == 0:
            fail(f"cli auto --dense never launched the {name} kernel")
    if out["cameras"] < FOLDER_REGISTERED_BAR * FOLDER_VIEWS:
        fail(f"cli auto --dense registered {out['cameras']} of "
             f"{FOLDER_VIEWS} views")

    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    try:
        r = subprocess.run(
            [sys.executable, "-m", "tpu3drec_torch", "auto", folder,
             os.path.join(tmp, "auto_sub"), "--dense", "--device", str(dev)],
            cwd=here, env=env, capture_output=True, text=True,
            timeout=SUBPROCESS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"python -m tpu3drec_torch auto did not end in "
             f"{SUBPROCESS_TIMEOUT_S} s")
    sub_s = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"python -m tpu3drec_torch auto --dense exited {r.returncode}: "
             f"{r.stderr[-2000:]}")
    sub = last_json(r.stdout)
    print(f"python -m tpu3drec_torch auto --dense (a new process): "
          f"{sub['cameras']} cameras, {sub['points']} points, {sub_s:.2f} s "
          f"wall (interpreter, imports and CUDA start included)")
    if sub["cameras"] != out["cameras"]:
        fail(f"the subprocess registered {sub['cameras']} cameras, the "
             f"in-process run {out['cameras']}")
    return dict(launches=launches, in_s=in_s, sub_s=sub_s,
                cameras=out["cameras"])


def post_json(url, body, timeout=300):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def get_json(url, timeout=60):
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def serve_rows(torch, batcher, a, b, ratio):
    """The batcher's detection, `knn2` and ratio test on one pair (a, b)
    on its device: keypoints, int8 descriptors and masks of both images,
    the best neighbour and the decision of each row, on the host."""
    from tpu3drec_torch.ops.match import quantize_u8
    imgs = torch.from_numpy(np.stack([a, b]).astype(np.float32)).to(
        batcher.device)
    r = torch.tensor([ratio], dtype=torch.float32, device=batcher.device)
    xy, desc, mask, nn_idx, _, ok = batcher.match_rows(imgs, r)
    return {"xy": xy.double().cpu().numpy(),
            "q": quantize_u8(desc).cpu().numpy().astype(np.float64),
            "mask": mask.cpu().numpy(), "nn": nn_idx[0, :, 0].cpu().numpy(),
            "ok": ok[0].cpu().numpy()}


def serve_rows_agree(g, h, ratio):
    """Rows of the card's run `g` against the CPU's `h` (`serve_rows`).
    Keypoints pair up by position (within SERVE_PAIR_PX, one to one: a
    card keypoint nearest to two of the CPU's pairs with neither; the
    subpixel step moves a keypoint by more than 1e-4 px between the
    devices, distinct keypoints lie >= 1 px apart); a paired keypoint's
    descriptor moved by e = |q_card - q_cpu|, so a distance moves by at
    most e_row + e_column, and the two smallest of a row by at most w =
    e_row + the largest e of the columns in either run's top two. A CPU
    row is held when its keypoint and those columns are paired and its
    exact distances d0 <= d1 clear the ratio test by that much:
    |d0 - ratio d1| > (1 + ratio) w, with 1e-4 d1 more for the float32
    test. A held row takes the same decision on both devices and, when
    accepted, the same best column (then d1 - d0 > 2 w). Returns counts:
    the CPU's valid rows, rows unpaired (the row or a top-two column),
    held, held with another decision, held and accepted with another
    best column, decisions that differ among the rest, accepted rows
    outside the compared ones on each device, and the median and
    largest e."""
    K = h["mask"].shape[1]
    to_g, e = [], []
    for im in (0, 1):
        a = np.nonzero(h["mask"][im])[0]
        b = np.nonzero(g["mask"][im])[0]
        d = np.linalg.norm(h["xy"][im][a][:, None] - g["xy"][im][b][None],
                           axis=-1)
        j = d.argmin(1)
        m = d[np.arange(len(a)), j] < SERVE_PAIR_PX
        m &= np.bincount(j[m], minlength=len(b))[j] == 1
        tg = np.full(K, -1)
        tg[a[m]] = b[j[m]]
        ei = np.full(K, np.inf)
        ei[a[m]] = np.linalg.norm(g["q"][im][b[j[m]]] - h["q"][im][a[m]],
                                  axis=1)
        to_g.append(tg)
        e.append(ei)
    to_h = np.full(K, -1)
    to_h[to_g[1][to_g[1] >= 0]] = np.nonzero(to_g[1] >= 0)[0]

    def dist(run):
        q1, q2 = run["q"]
        d2 = ((q1 * q1).sum(1)[:, None] + (q2 * q2).sum(1)[None]
              - 2 * q1 @ q2.T)
        d2 = np.where(run["mask"][1][None], d2, np.inf)
        return np.sqrt(np.maximum(d2, 0))
    dh, dg = dist(h), dist(g)
    rows = np.nonzero(h["mask"][0])[0]
    c = dict(valid=len(rows), unpaired=0, held=0, differ=0, nn_differ=0,
             rest_differ=0, ok_unpaired_cpu=0)
    compared = np.zeros(K, bool)     # card rows of the compared CPU rows
    for i in rows:
        gi = to_g[0][i]
        top_h = np.argsort(dh[i], kind="stable")[:2]
        top_g = (to_h[np.argsort(dg[gi], kind="stable")[:2]] if gi >= 0
                 else np.array([-1]))
        if gi < 0 or (top_g < 0).any():
            c["unpaired"] += 1
            c["ok_unpaired_cpu"] += bool(h["ok"][i])
            continue
        compared[gi] = True
        w = e[0][i] + e[1][np.concatenate([top_h, top_g])].max()
        d0, d1 = dh[i, top_h[0]], dh[i, top_h[1]]
        same = g["ok"][gi] == h["ok"][i]
        if not abs(d0 - ratio * d1) > (1 + ratio) * w + 1e-4 * d1:
            c["rest_differ"] += not same
            continue
        c["held"] += 1
        c["differ"] += not same
        c["nn_differ"] += bool(h["ok"][i]) and (
            to_g[1][h["nn"][i]] != g["nn"][gi])
    c["ok_unpaired_card"] = int((g["ok"] & ~compared).sum())
    paired = np.concatenate([x[np.isfinite(x)] for x in e])
    c["e_median"] = float(np.median(paired))
    c["e_max"] = float(paired.max())
    return c


def serve_card_vs_cpu(torch, batcher, cpu_batcher, pairs, u8):
    """Two pairs through the card's batcher and a CPU one with the same
    draws, each held row by row (`serve_rows_agree`: no held row may
    differ, and >= SERVE_HELD_SHARE of the CPU's rows must be held), and
    end to end to phase 3's bars on inliers and homography corners; raw
    match counts within max(2, 2%) on phase 3's float pair. The pair in
    the 8-bit levels the requests carried has its count gap printed
    beside the rows behind it."""
    ratio = 0.75
    for label, (a, b), count_held in (
            ("phase 3's pair 0", pairs[0], True),
            ("the same pair in the 8-bit levels the requests carried",
             [x.astype(np.float32) / 255.0 for x in u8[0]], False)):
        got = batcher.submit(a, b, ratio, 4.0)
        ref = cpu_batcher.submit(a, b, ratio, 4.0)
        g = serve_rows(torch, batcher, a, b, ratio)
        h = serve_rows(torch, cpu_batcher, a, b, ratio)
        if (int(g["ok"].sum()) != got["num_raw_matches"]
                or int(h["ok"].sum()) != ref["num_raw_matches"]):
            fail("serving: the batcher's rows disagree with its own answer")
        c = serve_rows_agree(g, h, ratio)
        tol = max(2, 0.02 * ref["num_raw_matches"])
        ce = (corner_error(np.asarray(got["homography"]),
                           np.asarray(ref["homography"]), *SERVE_SHAPE)
              if got["homography"] and ref["homography"] else np.inf)
        gap = abs(got["num_raw_matches"] - ref["num_raw_matches"])
        print(f"serving, card vs CPU plain path on {label}: raw matches "
              f"{got['num_raw_matches']} vs {ref['num_raw_matches']} (gap "
              f"{gap}, phase 3's bar {tol:.2f}"
              f"{'' if count_held else ', printed'}), inliers "
              f"{got['num_matches']} vs {ref['num_matches']}, homography "
              f"corners within {ce:.3f} px; rows: {c['held']} of the CPU's "
              f"{c['valid']} held clear of the ratio test's near-ties "
              f"({100 * c['held'] / c['valid']:.2f}%, bar >= "
              f"{100 * SERVE_HELD_SHARE:.0f}%), of them {c['differ']} with "
              f"another decision and {c['nn_differ']} accepted with another "
              f"best column (bar 0 each); decisions differ on "
              f"{c['rest_differ']} of the "
              f"{c['valid'] - c['held'] - c['unpaired']} rows at near-ties; "
              f"{c['unpaired']} rows unpaired (the row or a top-two column "
              f"found on one device only, within {SERVE_PAIR_PX} px), "
              f"accepted among them {c['ok_unpaired_cpu']} on the CPU, "
              f"{c['ok_unpaired_card']} on the card; "
              f"descriptor moves e median {c['e_median']:.3f}, largest "
              f"{c['e_max']:.3f} (int8 units)")
        if (c["differ"] or c["nn_differ"]
                or c["held"] < SERVE_HELD_SHARE * c["valid"]
                or abs(got["num_matches"] - ref["num_matches"]) > tol
                or ce > 0.5 or (count_held and gap > tol)):
            fail(f"the card's batched /match disagrees with the CPU plain "
                 f"path on {label}")


def serve_phase(torch, card, dev, tmp, pairs, Hgt, pm, ps, psg):
    """A live MatchServer on localhost: /health and /methods, 16
    concurrent SIFT /match requests from 8 threads (phase 3's photos and
    their known warps in 8-bit levels: every SERVE_B64_EVERY-th as base64
    PNG files written by the package's standard-library writer, the
    rest as lists), each answer's time split by the server; one /detect,
    one ORB /match (the unbatched path); `ori_desc` and `knn2` on the
    widest served batch's operands, kept as the batch ran, against
    their plain versions; then the card's batcher against a CPU one
    (`serve_card_vs_cpu`)."""
    import base64
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from tpu3drec_torch.data.downloader import write_png_gray
    from tpu3drec_torch.io import native_decoder
    from tpu3drec_torch.ops import match as mt
    from tpu3drec_torch.ops.sift import N_LAYERS
    from tpu3drec_torch.serve import MatchServer, MicroBatcher
    try:
        import PIL   # noqa: F401
        decoder = "PIL"
    except ImportError:
        decoder = ("the native decoder" if native_decoder.available()
                   else "none (answered 400)")
    ms = MatchServer(shape=SERVE_SHAPE, max_features=SERVE_FEATURES,
                     device=dev)
    t0 = time.perf_counter()
    httpd = ms.start(host="127.0.0.1", port=0, warmup=True)
    warm_s = time.perf_counter() - t0
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    # the widest batch's kernel operands, kept as it runs (under the
    # device lock, so no other call is spied on)
    kept = {"n": 1}
    compute = ms.batcher._compute

    def compute_spy(batch):
        if len(batch) <= kept["n"]:
            return compute(batch)
        _, ops, octaves, restore = spy_kernel_inputs(mt, ps)
        try:
            return compute(batch)
        finally:
            restore()
            kept.update(n=len(batch), knn2=ops[128], octaves=octaves)
    try:
        for route in ("/health", "/methods"):
            code, body = get_json(url + route)
            if code != 200:
                fail(f"server {route}: HTTP {code}")
        if "SIFT" not in body["methods"]:
            fail(f"server /methods: {body}")
        u8 = [(np.rint(a * 255).astype(np.uint8), np.rint(b * 255).astype(
            np.uint8)) for a, b in pairs]

        def png64(i, k, img):
            path = os.path.join(tmp, f"serve_{i}_{k}.png")
            write_png_gray(path, img)
            with open(path, "rb") as f:
                return base64.b64encode(f.read()).decode()
        b64 = [i % SERVE_B64_EVERY == SERVE_B64_EVERY - 1
               for i in range(len(u8))]
        bodies = [json.dumps(
            {"image1": png64(i, 1, a) if b64[i] else a.tolist(),
             "image2": png64(i, 2, b) if b64[i] else b.tolist(),
             "method": "SIFT"}).encode() for i, (a, b) in enumerate(u8)]
        reset_counts(pm, ps, psg)
        _, before = get_json(url + "/health")
        lat = [None] * SERVE_REQUESTS

        def one(i):
            t = time.perf_counter()
            code, out = post_json(url + "/match", bodies[i])
            lat[i] = time.perf_counter() - t
            return code, out

        ms.batcher._compute = compute_spy
        t0 = time.perf_counter()
        try:
            with ThreadPoolExecutor(SERVE_THREADS) as pool:
                answers = list(pool.map(one, range(SERVE_REQUESTS)))
        finally:
            del ms.batcher._compute
        wall = time.perf_counter() - t0
        launches = kernel_counts(pm, ps, psg)
        _, health = get_json(url + "/health")
        codes = [c for c, _ in answers]
        if any(c != 200 for c in codes):
            fail(f"server /match answers {codes}: "
                 f"{[o for c, o in answers if c != 200][:2]}")
        errs = []
        for (_, o), Hg in zip(answers, Hgt):
            if o["homography"] is None:
                errs.append(np.inf)
            else:
                errs.append(corner_error(np.asarray(o["homography"]), Hg,
                                         *SERVE_SHAPE))
        errs = np.array(errs)
        widths = [o["batched_with"] for _, o in answers]
        dispatches = (health["batching"]["dispatches"]
                      - before["batching"]["dispatches"])
        lat_ms = np.array(lat) * 1e3
        print(f"server on {card}: {SERVE_REQUESTS} /match requests from "
              f"{SERVE_THREADS} threads in {wall:.3f} s = "
              f"{SERVE_REQUESTS / wall:.3f} requests/s; latency p50 "
              f"{np.percentile(lat_ms, 50):.1f} ms, p99 "
              f"{np.percentile(lat_ms, 99):.1f} ms; dispatches {dispatches}, "
              f"batch widths {sorted(widths)}; warm-up {warm_s:.2f} s "
              f"(dispatches after it {before['batching']['dispatches']}); "
              f"launches {launches}; corners within {SERVE_CORNER_PX} px on "
              f"{int((errs < SERVE_CORNER_PX).sum())}/{SERVE_REQUESTS} "
              f"(median {np.median(errs):.3f} px); mean inliers "
              f"{np.mean([o['num_matches'] for _, o in answers]):.1f}")
        # where a request's time went: the server's own split, and the
        # rest of the client's latency (HTTP, the answer, the thread pool)
        parts = {k: np.array([o["timing_s"][k] for _, o in answers]) * 1e3
                 for k in ("body_s", "decode_s", "wait_s", "compute_s")}
        parts["rest"] = lat_ms - sum(parts.values())
        for kind, sel in (("list", ~np.array(b64)), ("base64 PNG",
                                                     np.array(b64))):
            mb = np.mean([len(bodies[i]) for i in np.nonzero(sel)[0]]) / 1e6
            print(f"server time split, {int(sel.sum())} {kind} requests "
                  f"(a body of {mb:.2f} MB"
                  + (f", decoded by {decoder}" if kind != "list" else "")
                  + "), median ms: "
                  + ", ".join(f"{k.replace('_s', '')} "
                              f"{np.median(v[sel]):.1f}"
                              for k, v in parts.items())
                  + f"; latency {np.median(lat_ms[sel]):.1f}")
        if dispatches >= SERVE_REQUESTS or max(widths) < 2:
            fail("the server did not batch concurrent /match requests")
        if launches["ori_desc"] == 0 or launches["knn2"] == 0:
            fail(f"the server's /match path did not launch ori_desc and "
                 f"knn2: {launches}")
        if (errs < SERVE_CORNER_PX).mean() < 0.9:
            fail("fewer than 90% of the server's homographies map the "
                 "corners within 2 px of the known warp")

        code, det = post_json(url + "/detect", json.dumps(
            {"image": u8[0][0].tolist()}).encode())
        if code != 200 or det["num_keypoints"] <= 0:
            fail(f"server /detect: HTTP {code}, {det.get('num_keypoints')}")
        code, orb = post_json(url + "/match", json.dumps(
            {"image1": u8[0][0].tolist(), "image2": u8[0][1].tolist(),
             "method": "ORB"}).encode())
        if code != 200:
            fail(f"server ORB /match: HTTP {code}: {orb}")
        print(f"server /detect: {det['num_keypoints']} SIFT keypoints; ORB "
              f"/match (unbatched): {orb['num_matches']} inliers, "
              f"{orb['latency_s']:.3f} s")
        _, health = get_json(url + "/health")
        if health["stats"]["errors"]:
            fail(f"server errors: {health['stats']}")
    finally:
        httpd.shutdown()
        httpd.server_close()

    # the kernels on the widest served batch's operands, against their
    # plain versions with phase 2's bars (knn2 int8 bit for bit)
    if "knn2" not in kept:
        fail("no served batch was wider than one")
    n = kept["n"]
    L, h, w = kept["octaves"][0].dxs.shape
    od = ori_desc_octaves(torch, ps, kept["octaves"], profile=False)
    print(f"ori_desc vs plain at the widest served batch ({n} pairs: "
          f"{L // (N_LAYERS + 3)} images of {w}x{h}, "
          f"{len(kept['octaves'])} octaves, "
          f"{sum(o.meta.shape[0] for o in kept['octaves'])} slots): "
          f"{od['n_valid']} valid; {od['n_bad']} outside angle<1e-3 rad & "
          f"cos>0.9999 ({100 * od['frac_bad']:.3f}%, bar <= 0.5%); max "
          f"|desc err| on the rest {od['max_err']:.3e}; two launches "
          f"bit-identical; every slot written; the device's slot list and "
          f"support boxes right; {od['ms']:.4f} ms per detection call "
          f"(CUDA events), plain {od['plain_ms']:.3f} ms, bound "
          f"{od['bound_ms']:.4f} ms ({od['bound_by']})")
    if od["n_valid"] == 0 or od["frac_bad"] > 0.005:
        fail("ori_desc disagrees with its plain version at the widest "
             "served batch")
    kn = folder_knn2(torch, pm, kept["knn2"],
                     f"the widest served batch of SIFT operands ({n} pairs)")

    cpu_batcher = MicroBatcher(SERVE_SHAPE, SERVE_FEATURES, threading.Lock(),
                               device="cpu")
    serve_card_vs_cpu(torch, ms.batcher, cpu_batcher, pairs, u8)
    return dict(launches=launches, rps=SERVE_REQUESTS / wall,
                p50=float(np.percentile(lat_ms, 50)),
                p99=float(np.percentile(lat_ms, 99)),
                dispatches=dispatches,
                ori_desc={"serve_ms": od["ms"], "serve_plain_ms": od["plain_ms"],
                          "serve_bound_ms": od["bound_ms"],
                          "serve_bound_by": od["bound_by"],
                          "serve_max_abs_err": od["max_err"]},
                knn2={f"serve_{k}": v for k, v in kn.items()})


def bench_phase(torch, card, dev, tmp, pm, ps, psg):
    """The CLI `benchmark` subcommand on its synthetic images: no method
    entry may hold an error, and its throughput task must launch knn2."""
    import contextlib
    import io
    from tpu3drec_torch import cli
    from tpu3drec_torch.bench import runner
    thr_launches = {}
    task_run = runner.ThroughputTask.run

    def spy(self, pairs):
        before = pm.knn2_raw.launches
        try:
            return task_run(self, pairs)
        finally:
            thr_launches["knn2"] = pm.knn2_raw.launches - before

    out_dir = os.path.join(tmp, "bench")
    buf = io.StringIO()
    reset_counts(pm, ps, psg)
    runner.ThroughputTask.run = spy
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["benchmark", "--methods", *BENCH_METHODS,
                           "--num-runs", str(BENCH_RUNS), "--output",
                           out_dir, "--device", str(dev)])
    finally:
        runner.ThroughputTask.run = task_run
    secs = time.perf_counter() - t0
    launches = kernel_counts(pm, ps, psg)
    files = sorted(f for f in os.listdir(out_dir) if f.endswith(".json"))
    if rc != 0 or len(files) != 1:
        fail(f"cli benchmark: rc {rc}, files {files}")
    with open(os.path.join(out_dir, files[0])) as f:
        res = json.load(f)
    bad = {f"{task}/{m}": v["error"]
           for task, body in res["benchmarks"].items()
           for m, v in body["summary"].items() if "error" in v}
    if bad:
        fail(f"cli benchmark: method errors {bad}")
    perf = res["benchmarks"]["performance"]["summary"]
    thr = res["benchmarks"]["throughput"]["summary"]
    acc = res["benchmarks"]["accuracy"]["summary"]
    print(f"cli benchmark on {card} ({secs:.1f} s; launches {launches}, "
          f"knn2 in the throughput task {thr_launches.get('knn2')}): "
          + "; ".join(f"{m}: {thr[m]['batched_pairs_per_s']:.3f} batched "
                      f"pairs/s ({thr[m]['metric']}, batch "
                      f"{thr[m]['batch']}, first call "
                      f"{thr[m]['compile_time_s']:.3f} s), "
                      f"{perf[m]['fps']:.3f} fps per call, quality "
                      f"{acc[m]['avg_quality']:.3f}"
                      for m in BENCH_METHODS)
          + f"; ranked by {res['analysis']['speed_metric']}")
    if not thr_launches.get("knn2"):
        fail("the benchmark's throughput task never launched knn2")
    return dict(launches=launches, secs=secs,
                pairs_per_s={m: thr[m]["batched_pairs_per_s"]
                             for m in BENCH_METHODS},
                fps={m: perf[m]["fps"] for m in BENCH_METHODS})


def tooling_phase(torch, dev, tmp):
    """trace_to leaves a Chrome trace of card work; device_memory_stats
    reports the card's keys."""
    from tpu3drec_torch.ops.sift import detect_and_compute
    from tpu3drec_torch.utils import device_memory_stats, trace_to
    trace_dir = os.path.join(tmp, "trace")
    img = torch.tensor(synthetic_photo(*SERVE_SHAPE, SEED), device=dev)
    with trace_to(trace_dir):
        detect_and_compute(img[None], SERVE_FEATURES)
    traces = [f for f in os.listdir(trace_dir)] if os.path.isdir(
        trace_dir) else []
    stats = device_memory_stats()
    print(f"trace_to wrote {traces}; device_memory_stats: {stats}")
    if len(traces) != 1 or os.path.getsize(os.path.join(
            trace_dir, traces[0])) == 0:
        fail("trace_to left no trace file")
    keys = ("device_bytes_in_use", "device_peak_bytes", "device_limit_bytes")
    if dev.type == "cuda" and not all(stats.get(k, 0) > 0 for k in keys):
        fail(f"device_memory_stats lacks the card's keys: {stats}")


def run_user_surface(torch, card, dev, tmp, pairs, Hgt):
    """Phase 11: the user surface on phase 7's folder in `tmp`/imgs: `auto
    --dense` through the CLI in process and in a new process, a live
    /match server with concurrent requests (`pairs`, the known warps
    `Hgt`), the card's batcher against the CPU's, the CLI `benchmark`
    subcommand, and the tooling."""
    from tpu3drec_torch.ops import pallas_match as pm
    from tpu3drec_torch.ops import pallas_sample as ps
    from tpu3drec_torch.ops import pallas_sgm as psg
    here = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    auto = cli_auto(torch, dev, tmp, os.path.join(tmp, "imgs"), here,
                    pm, ps, psg)
    serve = serve_phase(torch, card, dev, tmp, pairs, Hgt, pm, ps, psg)
    bench = bench_phase(torch, card, dev, tmp, pm, ps, psg)
    tooling_phase(torch, dev, tmp)
    print(f"user-surface phase on {card}: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return dict(launches={"cli_auto": auto["launches"],
                          "serve": serve["launches"],
                          "benchmark": bench["launches"]},
                auto=auto, serve=serve, bench=bench,
                ori_desc=serve["ori_desc"], knn2=serve["knn2"])


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "tpu3drec_torch", "csrc")):
        fail("the tpu3drec_torch package is not beside chip_smoke.py")
    t_main = time.perf_counter()
    phase_s = {}
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    import tpu3drec_torch
    from tpu3drec_torch import _nvcc
    from tpu3drec_torch.ops import pallas_match as pm
    from tpu3drec_torch.ops import pallas_sample as ps
    from tpu3drec_torch.ops import pallas_sgm as psg
    from tpu3drec_torch.ops.sift import detect_and_compute, octave_samples

    # ---- 1. card and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = _nvcc.build()
    print(f"built {', '.join(reports)} with nvcc in "
          f"{time.perf_counter() - t0:.1f} s (parallel)")
    for name, text in reports.items():
        for line in text.splitlines():
            if any(w in line for w in ("Function properties", "registers", "spill")):
                print(f"  ptxas {name}: {line.strip()}")
    dev = torch.device("cuda")

    # ---- inputs: 96 photos and a known similarity warp of each
    t0 = time.perf_counter()
    img1 = torch.tensor(np.stack([synthetic_photo(H, W, SEED + i)
                                  for i in range(BATCH)]), device=dev)
    img2, Hgt = warp_batch(torch, img1, SEED + 1000)
    print(f"made {BATCH} pairs of {H}x{W} in {time.perf_counter() - t0:.1f} s")

    # ---- 2. kernels against their plain versions at main-path shapes
    imgs = torch.cat([img1, img2])
    samples = list(octave_samples(imgs, MAX_FEATURES))
    fields = {"ori_desc": check_ori_desc(torch, samples)}
    del samples
    _, _, _, _, desc, mask = detect_and_compute(imgs, MAX_FEATURES)
    fields["knn2"] = check_knn2(torch, desc, mask, BATCH)
    del desc, mask, imgs
    torch.cuda.synchronize()

    # ---- 3. the main path at full size
    pair_fn = tpu3drec_torch.make_pair_fn(max_features=MAX_FEATURES,
                                          num_hypotheses=NUM_HYPOTHESES)
    reset_counts(pm, ps, psg)
    out = pair_fn(img1, img2)
    torch.cuda.synchronize()
    launches = {k: n for k, n in kernel_counts(pm, ps, psg).items()
                if k != "sgm"}
    print(f"launches in one pair-step call: {launches}")
    for name, n in launches.items():
        if n == 0:
            fail(f"the main path never launched the {name} kernel")

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = pair_fn(img1, img2)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / REPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"pair step: {BATCH / dt:.3f} pairs/s ({dt * 1e3:.1f} ms per batch "
          f"of {BATCH}, mean of {REPS}); peak device memory {peak_gb:.2f} GB")

    nm = out["num_matches"].float()
    ni = out["num_inliers"].float()
    ratio = out["inlier_ratio"]
    Hs = out["homography"].cpu().double().numpy()
    if not all(torch.isfinite(t).all() for t in (nm, ni, ratio)) \
            or not np.isfinite(Hs).all() or Hs.shape != (BATCH, 3, 3):
        fail("non-finite or misshapen pair-step output")
    errs = np.array([corner_error(Hs[i], Hgt[i], H, W) for i in range(BATCH)])
    print(f"mean num_matches {float(nm.mean()):.2f}, num_inliers "
          f"{float(ni.mean()):.2f}, inlier_ratio {float(ratio.mean()):.4f}; "
          f"corner error vs the known warp: median {np.median(errs):.3f} px, "
          f"{int((errs < 2.0).sum())}/{BATCH} pairs under 2 px")
    if float(ratio.mean()) <= 0.8 or float(nm.mean()) <= 30:
        fail("quality bar: mean inlier ratio must exceed 0.8 and mean "
             "matches 30 on the warped pairs")
    if (errs < 2.0).mean() < 0.9:
        fail("fewer than 90% of the pairs recover the known warp to 2 px")

    profile_call(torch, lambda: pair_fn(img1, img2), "pair_step.")

    # the same step on the CPU (plain versions) agrees on pair 0, given
    # the same RANSAC uniforms
    from tpu3drec_torch.ops.ransac import draw_uniform
    t0 = time.perf_counter()
    u = draw_uniform(NUM_HYPOTHESES, 4, torch.Generator().manual_seed(SEED))
    ref = pair_fn(img1[:1].cpu(), img2[:1].cpu(), u=u)
    got = {k: v[0].cpu() for k, v in pair_fn(img1[:1], img2[:1], u=u).items()}
    tol = max(2, 0.02 * float(ref["num_matches"][0]))
    dm = abs(int(got["num_matches"]) - int(ref["num_matches"][0]))
    di = abs(int(got["num_inliers"]) - int(ref["num_inliers"][0]))
    ce = corner_error(got["homography"].double().numpy(),
                      ref["homography"][0].double().numpy(), H, W)
    print(f"pair 0, card vs CPU plain path: matches {int(got['num_matches'])} "
          f"vs {int(ref['num_matches'][0])}, inliers {int(got['num_inliers'])} "
          f"vs {int(ref['num_inliers'][0])}, homography corners within "
          f"{ce:.3f} px ({time.perf_counter() - t0:.1f} s)")
    if dm > tol or di > tol or ce > 0.5:
        fail("the card's pair step disagrees with the CPU plain path")

    phase_s["1-3 build, kernels, pair step"] = time.perf_counter() - t_main

    # ---- 4. the dense stage
    t0 = time.perf_counter()
    fields["sgm"] = run_dense(torch, kind, dev)
    launches["sgm"] = fields["sgm"]["launches"]
    phase_s["4 dense"] = time.perf_counter() - t0

    # ---- 5. SfM geometry and bundle adjustment
    t0 = time.perf_counter()
    run_sfm(torch, card, dev)
    phase_s["5 sfm ops"] = time.perf_counter() - t0

    # ---- 6. the incremental SfM pipeline
    t0 = time.perf_counter()
    run_pipeline(torch, card, dev)
    phase_s["6 sfm pipeline"] = time.perf_counter() - t0

    # ---- 7-8. the folder chain at the balanced and the accurate preset,
    # on one rendered folder
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_folder_") as tmp:
        os.mkdir(os.path.join(tmp, "imgs"))
        names, Rs = render_splat_views(os.path.join(tmp, "imgs"),
                                       FOLDER_VIEWS, FOLDER_POINTS)
        t0 = time.perf_counter()
        folder = run_folder(torch, card, dev, tmp, names, Rs)
        phase_s["7 folder chain"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        accurate = run_folder_accurate(torch, card, dev, tmp, names, Rs)
        phase_s["8 accurate chain"] = time.perf_counter() - t0

        # ---- 9. the rest of the dense stage on phase 7's dense input
        t0 = time.perf_counter()
        rest = run_dense_rest(torch, card, dev, *folder.pop("dense_input"))
        fields["sgm"].update(rest["sgm"])
        phase_s["9 dense rest"] = time.perf_counter() - t0

        # ---- 10. the deep models on the same folder
        t0 = time.perf_counter()
        deep = run_deep(torch, card, dev, tmp, names)
        phase_s["10 deep models"] = time.perf_counter() - t0

        # ---- 11. the user surface: CLI, server, benchmark, tooling
        t0 = time.perf_counter()
        surface = run_user_surface(
            torch, card, dev, tmp,
            list(zip(img1[:SERVE_REQUESTS].cpu().numpy(),
                     img2[:SERVE_REQUESTS].cpu().numpy())),
            Hgt[:SERVE_REQUESTS])
        phase_s["11 user surface"] = time.perf_counter() - t0
    for f in (folder, accurate, deep, surface):
        fields["knn2"].update(f["knn2"])
    for f in (folder, accurate, surface):
        fields["ori_desc"].update(f["ori_desc"])

    # ---- 12. the kernels line
    sources = {
        "ori_desc": ("tpu3drec_torch/csrc/ori_desc.cu",
                     "tpu3drec/ops/pallas_sample.py:541"),
        "knn2": ("tpu3drec_torch/csrc/knn2.cu",
                 "tpu3drec/ops/pallas_match.py:91"),
        "sgm": ("tpu3drec_torch/csrc/sgm.cu",
                "tpu3drec/ops/pallas_sgm.py:117"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        f = fields[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": f["max_abs_err"], "ms": f["ms"],
                        "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
                        "bound_by": f["bound_by"],
                        "library_ms": f["library_ms"],
                        "launches_by_path": {
                            "pair_step" if name != "sgm" else "dense":
                                launches[name],
                            "folder": folder["launches"][name],
                            "folder_accurate": accurate["launches"][name],
                            **(deep["launches_by_method"]
                               if name == "knn2" else {}),
                            **({f"dense_rest_{k}": v for k, v in
                                rest["launches"].items()}
                               if name == "sgm" else {}),
                            **{path: n[name] for path, n in
                               surface["launches"].items()}},
                        **{k: v for k, v in f.items() if k.startswith(
                            ("full_", "library_bf16", "kernel_ms", "orb_",
                             "folder_", "akaze_", "brisk_", "accurate_",
                             "sweep_", "deep_", "serve_"))}})
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in phase_s.items()))
    print(f"chip_smoke wall time: {time.perf_counter() - t_main:.1f} s "
          f"(builds included)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
