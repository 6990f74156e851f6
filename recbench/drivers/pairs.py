"""Closed-loop batches of image pairs through the pair step.

One caller sends batches of `batch` pairs back to back, drawn in turn
from a pool of `pool_batches` distinct batches made from the seed and
resident on the device. A batch is timed on the host clock from the
call of `tpu3drec_torch.pair_step.make_pair_fn`'s function to the host's
copy of its `num_matches`, `num_inliers` and `homography`.

`correct` compares every answer of the window with the plain reference's
answer for the same pool batch, run on the same device at the same batch
size after the window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from recbench.gen import photos
from recbench.reference import pairs as reference


@dataclass
class State:
    cell: object
    device: str
    img1: torch.Tensor
    img2: torch.Tensor
    warps: torch.Tensor
    fn: object = None
    # per pool batch: (batch, rows, cols, depth, valid columns) of knn2
    knn2_operands: Dict[int, tuple] = field(default_factory=dict)


def _answer(out) -> tuple:
    return (out["num_matches"].cpu().numpy(), out["num_inliers"].cpu().numpy(),
            out["homography"].cpu().numpy())


def _record_knn2(state: State) -> None:
    """One call per pool batch, with a spy on the pair step's `knn2` that
    counts each batch's operands (set-up only, outside every window)."""
    import tpu3drec_torch.pair_step as ps
    real = ps.knn2
    seen = []

    def spy(desc1, desc2, mask1, mask2, *a, **kw):
        seen.append((desc1.shape[0], desc1.shape[1], desc2.shape[1],
                     desc1.shape[2], int(mask2.sum())))
        return real(desc1, desc2, mask1, mask2, *a, **kw)

    ps.knn2 = spy
    try:
        for k in range(state.img1.shape[0]):
            _answer(state.fn(state.img1[k], state.img2[k]))
            state.knn2_operands[k] = seen[-1]
    finally:
        ps.knn2 = real


def setup(cell, seed: int, device: str) -> State:
    from tpu3drec_torch import _nvcc
    from tpu3drec_torch.pair_step import make_pair_fn
    cfg, tr = cell.config, cell.traffic
    if torch.device(device).type == "cuda":
        _nvcc.build([n for n in ("ori_desc", "knn2")
                     if not _nvcc.library_path(n).exists()])
    img1, img2, warps = photos.pair_pool(tr["pool_batches"], tr["batch"],
                                         cfg["height"], cfg["width"], seed,
                                         device)
    state = State(cell=cell, device=device, img1=img1, img2=img2,
                  warps=warps)
    state.fn = make_pair_fn(max_features=cfg["max_features"],
                            num_hypotheses=cfg["num_hypotheses"])
    # warm-up: every pool batch (the one shape the window uses) once,
    # counting each batch's knn2 operands, then the first batch again
    _record_knn2(state)
    _answer(state.fn(img1[0], img2[0]))
    return state


def window(state: State, seconds: float) -> Dict:
    P = state.img1.shape[0]
    B = state.img1.shape[1]
    answers, lat = [], []
    fn, img1, img2 = state.fn, state.img1, state.img2
    t0 = end = time.perf_counter()
    i = 0
    while end - t0 < seconds or i < P:     # every pool batch at least once
        k = i % P
        s = time.perf_counter()
        ans = _answer(fn(img1[k], img2[k]))
        end = time.perf_counter()
        lat.append(end - s)
        answers.append((k, ans))
        i += 1
    return {"metrics": {"pairs_per_s": B * i / (end - t0),
                        "batch_p95_ms": float(np.percentile(lat, 95)) * 1e3},
            "attempted": B * i, "failed": 0, "answers": answers,
            "latencies": lat}


def trace(state: State, win: Dict) -> Dict:
    """Profiles `trace_batches` more batches, in the window's order."""
    from torch.profiler import record_function

    from recbench.trace.profile import profile
    P = state.img1.shape[0]
    n = state.cell.traffic["trace_batches"]

    def stretch():
        for i in range(n):
            with record_function("recbench.batch"):
                _answer(state.fn(state.img1[i % P], state.img2[i % P]))

    tr = profile(torch, stretch, state.device)
    return {"trace": tr, "batches": n,
            "knn2": [state.knn2_operands[i % P] for i in range(n)]}


def release(state: State) -> None:
    state.fn = None
    if torch.device(state.device).type == "cuda":
        torch.cuda.empty_cache()


def numbers(answers, refs: Dict[int, tuple], warps, height: int,
            width: int) -> Dict[str, float]:
    """The compared numbers of `answers` [(pool batch, (num_matches,
    num_inliers, homography))] against the reference's answers `refs`
    (pool batch -> the same triple), worst over every answer:
    - matches_gap_pct, inliers_gap_pct: |answer - reference| over the
      reference's count (at least 1), in %;
    - homography_gap_px: the largest distance between where the answer's
      and the reference's homography send an image corner;
    - homography_diff_pct: answers whose homography moves a corner more
      than 0.05 px from the reference's, in %;
    - truth_gap_px: the largest corner distance to the generator's known
      warp (read, not compared: the control reads as low);
    - answers_malformed: answers of the wrong length or not finite."""
    worst = dict(matches_gap_pct=0.0, inliers_gap_pct=0.0,
                 homography_gap_px=0.0, homography_diff_pct=0.0,
                 truth_gap_px=0.0, answers_malformed=0.0)
    seen = differ = 0
    for k, (nm, ni, H) in answers:
        B = warps.shape[1]
        if nm.shape != (B,) or ni.shape != (B,) or H.shape != (B, 3, 3) \
                or not np.isfinite(H).all():
            worst["answers_malformed"] += 1
            continue
        seen += 1
        rm, ri, rH = refs[k]
        worst["matches_gap_pct"] = max(worst["matches_gap_pct"], float(
            np.max(100.0 * np.abs(nm - rm) / np.maximum(rm, 1))))
        worst["inliers_gap_pct"] = max(worst["inliers_gap_pct"], float(
            np.max(100.0 * np.abs(ni - ri) / np.maximum(ri, 1))))
        for b in range(B):
            gap = photos.corner_error(H[b], rH[b], height, width)
            differ += gap > 0.05
            worst["homography_gap_px"] = max(worst["homography_gap_px"], gap)
            worst["truth_gap_px"] = max(
                worst["truth_gap_px"],
                photos.corner_error(H[b], warps[k, b], height, width))
    if seen == 0:
        worst["answers_malformed"] += 1   # no batch was answered
    else:
        worst["homography_diff_pct"] = 100.0 * differ / (seen * warps.shape[1])
    return worst


def reference_answers(state: State, precision: str = "float32"):
    """The plain reference's answers for every pool batch, run on the same
    device at the same batch size, after the window."""
    cfg = state.cell.config
    out = {}
    for k in range(state.img1.shape[0]):
        with torch.no_grad():
            r = reference.pair_step(state.img1[k], state.img2[k],
                                    cfg["max_features"],
                                    cfg["num_hypotheses"], precision)
        out[k] = _answer(r)
        del r
        if torch.device(state.device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def check(state: State, win: Dict) -> Dict[str, float]:
    cfg = state.cell.config
    return numbers(win["answers"], reference_answers(state), state.warps,
                   cfg["height"], cfg["width"])


def control(state: State) -> Dict[str, float]:
    """The control's numbers: the reference at one precision below the
    configuration's (TF32 in the scale space), put in the program's
    place, against the float32 reference."""
    cfg = state.cell.config
    ctrl = reference_answers(state, "tf32")
    ref = reference_answers(state)
    return numbers([(k, a) for k, a in ctrl.items()], ref, state.warps,
                   cfg["height"], cfg["width"])
