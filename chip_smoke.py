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
  6. one JSON line with every kernel's launches, error, time, bound and
     the plain and library yardsticks;
  7. last line: {"ok": true, "device": {...}}.

Without CUDA, or without the package beside it, it fails before printing
any result. It imports nothing of JAX.
"""

import json
import math
import os
import re
import subprocess
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


def check_ori_desc(torch, samples):
    """ori_desc kernel vs plain on every octave, and on an all-valid
    stress meta at the octave-0 and octave-4 shapes; every launch twice,
    bit-identical; the device's slot list checked on the path's (mixed),
    the stress (all valid) and an all-invalid meta. Returns the kernel
    line fields (time and bound summed over the octaves of one call)."""
    from tpu3drec_torch.ops import pallas_sample as ps
    n_valid = n_bad = 0
    max_err = 0.0
    ms = plain_ms = 0.0
    parts = {"ori_desc_kernel": 0.0, "list_slots_kernel": 0.0, "Memset": 0.0}
    bytes_ = ops = 0.0
    work = [0, 0, 0, 0]
    box_px = []
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
        n_valid += nv
        n_bad += nv - int(bars["good"].sum())
        max_err = max(max_err, bars["err"])
        box = kernel_boxes_and_list(torch, ps, *args)
        area = (box[:, 1] - box[:, 0]) * (box[:, 3] - box[:, 2])
        box_px.append(int(area.max()) if nv else 0)
        ori_desc_misses(torch, ps, *args, a_k, bars, area > ps.CACHE_PX)
        ms += cuda_ms(torch, lambda: ps.ori_desc(*args))
        by_kernel = device_ms_by_kernel(torch, lambda: ps.ori_desc(*args))
        for name in parts:
            if parts[name] is not None:
                got = ms_of(by_kernel, name)
                parts[name] = None if got is None else parts[name] + got
        plain_ms += cuda_ms(torch, lambda: ps.ori_desc_plain(*args), reps=1)
        n_band, n_core, n_cell, n_px = ori_desc_work(torch, oc, a_p)
        work = [a + b for a, b in zip(work, (n_band, n_core, n_cell, n_px))]
        K = oc.meta.shape[0]
        # meta in, angle and raw out for every slot; each needed pixel of
        # both bf16 stacks read once
        bytes_ += K * (16 + 4 + 128 * 4) + n_px * 2 * 2
        # ~20 flops per band pixel in the mask (offsets, weight, magnitude,
        # atan2, two bins), ~45 per core pixel in the support (rotation,
        # weight, magnitude, atan2, 8 tents), 3 per (cell, output) for the
        # <= 4 spatial bins x 8 orientations a cell feeds, and ~700 per
        # slot for the two smoothings and the peak
        ops += n_band * 20 + n_core * 45 + n_cell * 32 * 3 + nv * 700
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

    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS * 1e3
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
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
            ps.ori_desc.launches = pm.knn2_raw.launches = 0
            psg.sgm_aggregate_batch.launches = 0
        res = pipe.run_complete_pipeline(sparse, images, reference_view=ref)
        torch.cuda.synchronize()
        if i == 0:
            fields["launches"] = psg.sgm_aggregate_batch.launches
        runs.append(res["timings_s"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"launches in one dense run: sgm {fields['launches']}, ori_desc "
          f"{ps.ori_desc.launches}, knn2 {pm.knn2_raw.launches}")
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

    ps.ori_desc.launches = pm.knn2_raw.launches = 0
    psg.sgm_aggregate_batch.launches = 0
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

    launches = {"ori_desc": ps.ori_desc.launches, "knn2": pm.knn2_raw.launches,
                "sgm": psg.sgm_aggregate_batch.launches}
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
            # floor, where another summation order (the card's atomics)
            # moves this window's cameras by ~1e-3
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


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "tpu3drec_torch", "csrc")):
        fail("the tpu3drec_torch package is not beside chip_smoke.py")
    t_main = time.perf_counter()
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
    ps.ori_desc.launches = pm.knn2_raw.launches = 0
    psg.sgm_aggregate_batch.launches = 0
    out = pair_fn(img1, img2)
    torch.cuda.synchronize()
    launches = {"ori_desc": ps.ori_desc.launches, "knn2": pm.knn2_raw.launches}
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

    # ---- 4. the dense stage
    fields["sgm"] = run_dense(torch, kind, dev)
    launches["sgm"] = fields["sgm"]["launches"]

    # ---- 5. SfM geometry and bundle adjustment
    run_sfm(torch, card, dev)

    # ---- 6. the kernels line
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
                        **{k: v for k, v in f.items() if k.startswith(
                            ("full_", "library_bf16", "kernel_ms"))}})
    print(f"chip_smoke wall time: {time.perf_counter() - t_main:.1f} s "
          f"(builds included)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
