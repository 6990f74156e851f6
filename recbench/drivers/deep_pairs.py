"""Closed-loop batches of image pairs through the deep pair step:
SuperPoint on both views, LightGlue on every pair, RANSAC
(`tpu3drec_torch.pair_step.make_deep_pair_fn`).

One caller sends batches of `batch` pairs back to back, drawn in turn
from a pool of `pool_batches` distinct batches made from the seed and
resident on the device (`gen/photos.py`, as the SIFT cells). Both
networks' parameters are drawn by the plain reference from a CPU
generator seeded with the seed (`reference/deep.py:random_params`: every
weight, bias and norm term nonzero) and loaded into the program's
modules. A batch is timed on the host clock from the call of the step
to the host's copy of its `num_matches`, `num_inliers` and
`homography`; each pool batch's first answer in the window also keeps
its device outputs (keypoints, scores, descriptors, masks, the
log-assignment's row and column maxima, the matchability logits, each
row's argmax and mutual flag before the confidence gate) for the check.

`correct` holds the window against the plain reference
(`reference/deep.py`), run on the same device after the window, float32
with TF32 off (`network_gaps` lists the numbers):

- SuperPoint on each image of each pool batch;
- LightGlue on the program's own keypoints and descriptors of each pair:
  the logits, and the argmax and mutual flag of every row that the
  reference decides by more than the logits' limit;
- the program's RANSAC stage (`pair_step.deep_ransac`) on the program's
  keypoints, each matched to its true match under the known warp or else
  to its partner among the reference's mutual pairs at filter 0, against
  the plain RANSAC on the same matches;
- the whole reference chain's answers against every answer of the
  window (`drivers/pairs.py:numbers`).

The control (`control`) is the reference one precision below the
configuration's, bfloat16 activations with TF32, put in the program's
place.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from recbench.drivers import pairs
from recbench.gen import photos
from recbench.reference import deep as reference

# the device outputs of the step that the check reads
KEPT = ("keypoints", "scores", "descriptors", "keypoint_mask",
        "assign_row_max", "assign_col_max", "z0", "z1", "best1", "mutual")


@dataclass
class State:
    cell: object
    device: str
    img1: torch.Tensor
    img2: torch.Tensor
    warps: torch.Tensor
    fn: object = None
    # the networks' parameters by the program's names, on the device
    superpoint: Dict[str, torch.Tensor] = None
    lightglue: Dict[str, torch.Tensor] = None
    # per pool batch: the work's operands (`trace/deep_work.py`)
    operands: Dict[int, dict] = field(default_factory=dict)
    # per pool batch: the window's first answer's device outputs
    kept: Dict[int, dict] = field(default_factory=dict)
    # per pool batch: the float32 reference's features and answers
    reference: Dict[int, dict] = field(default_factory=dict)


def _operands(cfg, out) -> dict:
    B = out["assign_row_max"].shape[0]
    return {"pairs": B, "height": cfg["height"], "width": cfg["width"],
            "valid": out["keypoint_mask"].sum(-1).tolist(),
            "dim": cfg["dim"], "n_layers": cfg["n_layers"],
            "heads": cfg["heads"], "input_dim": cfg["descriptor_dim"]}


def setup(cell, seed: int, device: str) -> State:
    from tpu3drec_torch.models.lightglue import LightGlue, LightGlueNet
    from tpu3drec_torch.models.superpoint import SuperPoint, SuperPointNet
    from tpu3drec_torch.pair_step import make_deep_pair_fn
    cfg, tr = cell.config, cell.traffic
    img1, img2, warps = photos.pair_pool(tr["pool_batches"], tr["batch"],
                                         cfg["height"], cfg["width"], seed,
                                         device)
    state = State(cell=cell, device=device, img1=img1, img2=img2,
                  warps=warps)
    gen = torch.Generator().manual_seed(seed)
    sp_params = reference.random_params(
        reference.superpoint_shapes(cfg["descriptor_dim"]), gen)
    lg_params = reference.random_params(
        reference.lightglue_shapes(cfg["descriptor_dim"], cfg["dim"],
                                   cfg["n_layers"], cfg["heads"]), gen)
    sp_net = SuperPointNet(cfg["descriptor_dim"])
    sp_net.load_state_dict(sp_params)
    lg_net = LightGlueNet(input_dim=cfg["descriptor_dim"], dim=cfg["dim"],
                          n_layers=cfg["n_layers"], heads=cfg["heads"])
    lg_net.load_state_dict(lg_params)
    knobs = dict(matmul_precision=cfg["matmul_precision"],
                 activation_dtype=cfg["activation_dtype"])
    sp = SuperPoint(sp_net.to(device).eval(),
                    max_features=cfg["max_features"],
                    keypoint_threshold=cfg["keypoint_threshold"],
                    nms_radius=cfg["nms_radius"], **knobs)
    lg = LightGlue(lg_net.to(device).eval(), dim=cfg["dim"],
                   n_layers=cfg["n_layers"], heads=cfg["heads"],
                   input_dim=cfg["descriptor_dim"], **knobs)
    state.superpoint = {k: v.to(device) for k, v in sp_params.items()}
    state.lightglue = {k: v.to(device) for k, v in lg_params.items()}
    state.fn = make_deep_pair_fn(sp, lg, num_hypotheses=cfg["num_hypotheses"],
                                 filter_threshold=cfg["filter_threshold"])
    # warm-up: every pool batch (the one shape the window uses) once,
    # recording each batch's operands, then the first batch again
    for k in range(img1.shape[0]):
        out = state.fn(img1[k], img2[k])
        pairs._answer(out)
        state.operands[k] = _operands(cfg, out)
        del out
    pairs._answer(state.fn(img1[0], img2[0]))
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
        out = fn(img1[k], img2[k])
        ans = pairs._answer(out)
        end = time.perf_counter()
        lat.append(end - s)
        answers.append((k, ans))
        if k not in state.kept:
            state.kept[k] = {n: out[n] for n in KEPT}
        del out
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
                pairs._answer(state.fn(state.img1[i % P], state.img2[i % P]))

    tr = profile(torch, stretch, state.device)
    return {"trace": tr, "batches": n,
            "deep": [state.operands[i % P] for i in range(n)]}


release = pairs.release


# ---- the check

def _features(state: State, k: int, mode: str) -> List[tuple]:
    """The reference's features of pool batch k's 2B images at `mode`."""
    cfg = state.cell.config
    with reference.precision(mode, torch.device(state.device).type):
        return [reference.superpoint(state.superpoint, img,
                                     cfg["max_features"],
                                     cfg["keypoint_threshold"],
                                     cfg["nms_radius"])
                for img in torch.cat([state.img1[k], state.img2[k]])]


def _pair_outputs(state: State, feats, mode: str) -> List[tuple]:
    cfg = state.cell.config
    with reference.precision(mode, torch.device(state.device).type):
        return reference.pair_outputs(state.lightglue, feats,
                                      (cfg["height"], cfg["width"]),
                                      cfg["heads"])


def _answers(state: State, feats, outs) -> tuple:
    cfg = state.cell.config
    return reference.chain_answers(outs, feats, cfg["filter_threshold"],
                                   cfg["num_hypotheses"], cfg["max_features"],
                                   cfg["ransac_threshold_px"])


def _reference(state: State, k: int) -> dict:
    """The float32 reference of pool batch k: its features and its
    chain's answers (kept on the state, for the control too)."""
    if k not in state.reference:
        feats = _features(state, k, "float32")
        outs = _pair_outputs(state, feats, "float32")
        state.reference[k] = {"features": feats,
                              "answers": _answers(state, feats, outs)}
        del outs
    return state.reference[k]


def _program_side(kept: dict) -> tuple:
    """The kept device outputs as the reference's lists, on the valid
    keypoints: features (xy, scores, desc) per image, and per pair (row
    maxima, column maxima, z0, z1, each row's argmax among the second
    view's valid keypoints, its mutual flag)."""
    m = kept["keypoint_mask"]
    feats = [(kept["keypoints"][i][m[i]], kept["scores"][i][m[i]],
              kept["descriptors"][i][m[i]]) for i in range(m.shape[0])]
    B = m.shape[0] // 2
    pos = m.long().cumsum(-1) - 1        # slot -> index among the valid
    outs = [(kept["assign_row_max"][b][m[b]],
             kept["assign_col_max"][b][m[B + b]],
             kept["z0"][b][m[b]], kept["z1"][b][m[B + b]],
             pos[B + b][kept["best1"][b].long()][m[b]],
             kept["mutual"][b][m[b]]) for b in range(B)]
    return feats, outs


def _argmax(log_assign) -> tuple:
    """Each row's argmax, and whether it is its column's argmax too."""
    best1 = log_assign.argmax(1)
    i0 = torch.arange(log_assign.shape[0], device=log_assign.device)
    return best1, log_assign.argmax(0)[best1] == i0


def _margin(log_assign, dim: int):
    """The gap between the largest and the second largest entry of each
    row (dim 1) or column (dim 0); infinite where there is one entry."""
    if log_assign.shape[dim] < 2:
        return torch.full((log_assign.shape[1 - dim],), float("inf"),
                          device=log_assign.device)
    top = log_assign.topk(2, dim=dim).values
    return top.select(dim, 0) - top.select(dim, 1)


# a first-view keypoint's true match: the second view's keypoint nearest
# to where the known warp sends it, within this many pixels
TRUE_PX = 1.5


def _ransac_layout(feats, ref_outs, warps, slots: int) -> tuple:
    """The RANSAC check's matches in the deep step's layout: keypoints
    (2B, slots, 2), each first-view slot's match in the second view
    best1 (B, slots) and ok (B, slots). A first-view keypoint is matched
    to its true match (TRUE_PX) where it has one, else to its partner
    among the float32 reference's mutual pairs at filter 0 where it has
    one: with random weights those are outliers, and the true matches
    pose RANSAC a problem with one clear answer (the warp)."""
    B = len(ref_outs)
    dev = feats[0][0].device
    xy = torch.zeros(2 * B, slots, 2, device=dev)
    for i, f in enumerate(feats):
        xy[i, :len(f[0])] = f[0]
    best1 = torch.zeros(B, slots, dtype=torch.long, device=dev)
    ok = torch.zeros(B, slots, dtype=torch.bool, device=dev)
    for b, out in enumerate(ref_outs):
        i0, i1 = reference.mutual_matches(out[4], 0.0)
        best1[b, i0], ok[b, i0] = i1, True
        x1, x2 = feats[b][0], feats[B + b][0]
        if len(x1) and len(x2):
            h = warps[b].to(x1)
            p = torch.cat([x1, torch.ones_like(x1[:, :1])], 1) @ h.T
            dist, j = torch.cdist(p[:, :2] / p[:, 2:], x2).min(1)
            near = (dist < TRUE_PX).nonzero()[:, 0]
            best1[b, near], ok[b, near] = j[near], True
    return xy, best1, ok


def _program_ransac(state: State, xy, best1, ok) -> tuple:
    """The program's RANSAC stage, the deep step's own gather included."""
    from tpu3drec_torch.pair_step import deep_ransac
    return pairs._answer(deep_ransac(xy, best1, ok,
                                     state.cell.config["num_hypotheses"]))


def _plain_ransac(state: State, xy, best1, ok, mode: str) -> tuple:
    cfg = state.cell.config
    B = best1.shape[0]
    p2 = torch.stack([xy[B + b][best1[b]] for b in range(B)])
    return reference.plain_ransac(xy[:B], p2, ok, cfg["num_hypotheses"],
                                  cfg["ransac_threshold_px"], mode)


def _control_ransac(state: State, xy, best1, ok) -> tuple:
    """The plain RANSAC one precision below, on the same matches. It reads
    as the program does: the plain RANSAC has no matrix product, and
    autocast leaves the rest of its arithmetic in float32."""
    return _plain_ransac(state, xy, best1, ok, "bfloat16")


def _max_gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def network_gaps(state: State, sides: Dict[int, tuple],
                 side_ransac) -> Dict[str, float]:
    """The networks' and RANSAC's numbers of `sides` (pool batch ->
    (features, pair outputs) as `_program_side` gives them) against the
    float32 reference, each the worst over every image or pair:
    - sp_keypoints_missing_pct: keypoints of one side with no keypoint of
      the other at the same pixel, % of that side's over every image
      (NMS and top-k flips among near-equal scores), the larger side
      (read, not compared);
    - sp_score_gap (read, not compared), sp_desc_gap: on the shared
      keypoints, the largest score gap and 1 - cos of the descriptors;
    - lg_assign_max_gap: the largest gap of the log-assignment's row and
      column maxima against the reference's LightGlue run on the side's
      own keypoints and descriptors;
    - lg_matchability_gap: the same of the matchability logits z0, z1;
    - lg_argmax_flips: rows whose top two entries the reference parts by
      more than lg_assign_max_gap's limit where the side's argmax
      differs, and rows where, besides, the argmax's column is parted so
      too and the side's mutual flag differs;
    - lg_decided_rows_pct: the share of rows so compared (read);
    - lg_best_confidence: the side's largest match confidence, exp of
      its largest row maximum (read: how far the pairs' matches lie from
      the filter threshold);
    - ransac_*: `side_ransac(state, xy, best1, ok)`, the side's RANSAC
      on the side's keypoints matched as `_ransac_layout` says, against
      the plain float32 RANSAC on the same matches, as
      `drivers/pairs.py:numbers` compares answers; ransac_inliers_min,
      the plain RANSAC's fewest inliers in a pair (read)."""
    cfg = state.cell.config
    w = cfg["width"]
    limit = state.cell.limits["lg_assign_max_gap"]
    worst = dict(sp_keypoints_missing_pct=0.0, sp_score_gap=0.0,
                 sp_desc_gap=0.0, lg_assign_max_gap=0.0,
                 lg_matchability_gap=0.0, lg_argmax_flips=0.0,
                 lg_decided_rows_pct=0.0, lg_best_confidence=0.0)
    # keypoints, and those the other side lacks: this side's, the reference's
    seen, alone = [0, 0], [0, 0]
    rows = decided = 0
    ransac, ransac_ref = [], {}
    for k, (feats, outs) in sides.items():
        ref = _reference(state, k)["features"]
        for (xy, s, d), (rxy, rs, rd) in zip(feats, ref):
            key = xy[:, 1].long() * w + xy[:, 0].long()
            rkey = rxy[:, 1].long() * w + rxy[:, 0].long()
            inr, inp = torch.isin(key, rkey), torch.isin(rkey, key)
            seen[0] += len(key)
            seen[1] += len(rkey)
            alone[0] += int((~inr).sum())
            alone[1] += int((~inp).sum())
            ip = inr.nonzero()[:, 0][key[inr].argsort()]
            ir = inp.nonzero()[:, 0][rkey[inp].argsort()]
            if len(ip):
                worst["sp_score_gap"] = max(worst["sp_score_gap"],
                                            _max_gap(s[ip], rs[ir]))
                cos = (d[ip].double() * rd[ir].double()).sum(-1)
                worst["sp_desc_gap"] = max(worst["sp_desc_gap"],
                                           float((1 - cos).max()))
        ref_outs = _pair_outputs(state, feats, "float32")
        for got, want in zip(outs, ref_outs):
            if got[0].numel():
                worst["lg_best_confidence"] = max(
                    worst["lg_best_confidence"], float(got[0].max().exp()))
            worst["lg_assign_max_gap"] = max(
                worst["lg_assign_max_gap"], _max_gap(got[0], want[0]),
                _max_gap(got[1], want[1]))
            worst["lg_matchability_gap"] = max(
                worst["lg_matchability_gap"], _max_gap(got[2], want[2]),
                _max_gap(got[3], want[3]))
            la = want[4]
            if la.numel():
                best1, mutual = _argmax(la)
                row = _margin(la, 1) > limit
                both = row & (_margin(la, 0)[best1] > limit)
                worst["lg_argmax_flips"] += float(
                    (got[4] != best1)[row].sum()
                    + (got[5] != mutual)[both].sum())
                rows += la.shape[0]
                decided += int(row.sum())
        layout = _ransac_layout(feats, ref_outs, state.warps[k],
                                cfg["max_features"])
        ransac.append((k, side_ransac(state, *layout)))
        ransac_ref[k] = _plain_ransac(state, *layout, "float32")
        del ref_outs, layout
    worst["sp_keypoints_missing_pct"] = 100.0 * max(
        a / n if n else float(a > 0) for a, n in zip(alone, seen))
    worst["lg_decided_rows_pct"] = 100.0 * decided / max(rows, 1)
    got = pairs.numbers(ransac, ransac_ref, state.warps, cfg["height"],
                        cfg["width"])
    for name in ("matches_gap_pct", "inliers_gap_pct", "homography_gap_px",
                 "homography_diff_pct"):
        worst["ransac_" + name] = got[name]
    worst["ransac_inliers_min"] = float(min(int(a[1].min())
                                            for a in ransac_ref.values()))
    return worst


def _numbers(state: State, answers, sides, side_ransac) -> Dict[str, float]:
    cfg = state.cell.config
    refs = {k: _reference(state, k)["answers"] for k in sides}
    out = pairs.numbers(answers, refs, state.warps, cfg["height"],
                        cfg["width"])
    out.update(network_gaps(state, sides, side_ransac))
    return out


def check(state: State, win: Dict) -> Dict[str, float]:
    sides = {k: _program_side(kept) for k, kept in state.kept.items()}
    return _numbers(state, win["answers"], sides, _program_ransac)


def control(state: State) -> Dict[str, float]:
    """The control's numbers: the reference with bfloat16 activations
    and TF32, put in the program's place, against the float32
    reference."""
    answers, sides = [], {}
    for k in range(state.img1.shape[0]):
        feats = _features(state, k, "bfloat16")
        outs = _pair_outputs(state, feats, "bfloat16")
        answers.append((k, _answers(state, feats, outs)))
        sides[k] = (feats, [o[:4] + _argmax(o[4]) for o in outs])
        del outs
    return _numbers(state, answers, sides, _control_ransac)
