"""Closed-loop batches of image pairs through the deep pair step with
ALIKED-n16: ALIKED on both views, LightGlue (128-d input) on every
pair, RANSAC (`tpu3drec_torch.pair_step.make_deep_pair_fn`).

The window, the trace and the answers are `deep_pairs.py`'s: one caller
sends batches of `batch` pairs back to back from a resident pool of
`pool_batches` batches made from the seed (`gen/photos.py`); each pool
batch's first answer in the window keeps its device outputs; the traced
stretch records each batch's operands under `ctx["deep"]` (input_dim
128), which `lightglue.roofline_pct` and `deep_aliked.mfu_pct` read.
Both networks' parameters are drawn by the plain reference from a CPU
generator seeded with the seed (`reference/aliked.py:aliked_params`,
then `reference/deep.py:random_params` for LightGlue) and loaded into
the program's modules.

`correct` holds the window against the plain reference, run on the
same device after the window, float32 with TF32 off (`network_gaps`
and `matcher_gaps` list the numbers):

- ALIKED on each image of each pool batch: the program's keypoints
  against the reference's maps and peaks (`reference/aliked.py:
  side_gaps`): the share of keypoints whose pixel is not one of the
  reference's peaks, or of its peaks that no keypoint took, and on the
  shared ones the DKD position and the SDDH descriptor;
- LightGlue on the program's own keypoints and descriptors of each pair,
  and the program's RANSAC stage, as `deep_pairs.py` holds them;
- the whole reference chain's answers against every answer of the
  window (`drivers/pairs.py:numbers`).

The control (`control`) is the reference one precision below the
configuration's, put in the program's place: ALIKED with TF32 on,
LightGlue in bfloat16 with TF32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from recbench.drivers import deep_pairs, pairs
from recbench.gen import photos
from recbench.reference import aliked as reference
from recbench.reference import deep

window = deep_pairs.window
trace = deep_pairs.trace
release = pairs.release


@dataclass
class State(deep_pairs.State):
    # ALIKED's parameters by the program's names, on the device
    aliked: Dict[str, torch.Tensor] = None


def load_aliked(net, params) -> None:
    """`params` into the program's ALIKEDN16Net: every entry, and nothing
    missing but the BatchNorms' step counters."""
    missing, unexpected = net.load_state_dict(params, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked")
                         for k in missing):
        raise ValueError(f"ALIKED parameters do not fit the program's "
                         f"module: missing {missing}, unexpected "
                         f"{unexpected}")


def setup(cell, seed: int, device: str) -> State:
    from tpu3drec_torch.models.aliked_n16 import ALIKEDN16, ALIKEDN16Net
    from tpu3drec_torch.models.lightglue import LightGlue, LightGlueNet
    from tpu3drec_torch.pair_step import make_deep_pair_fn
    cfg, tr = cell.config, cell.traffic
    img1, img2, warps = photos.pair_pool(tr["pool_batches"], tr["batch"],
                                         cfg["height"], cfg["width"], seed,
                                         device)
    state = State(cell=cell, device=device, img1=img1, img2=img2,
                  warps=warps)
    gen = torch.Generator().manual_seed(seed)
    al_params = reference.aliked_params(gen)
    lg_params = deep.random_params(
        deep.lightglue_shapes(cfg["descriptor_dim"], cfg["dim"],
                              cfg["n_layers"], cfg["heads"]), gen)
    al_net = ALIKEDN16Net()
    load_aliked(al_net, al_params)
    lg_net = LightGlueNet(input_dim=cfg["descriptor_dim"], dim=cfg["dim"],
                          n_layers=cfg["n_layers"], heads=cfg["heads"])
    lg_net.load_state_dict(lg_params)
    al = ALIKEDN16(al_net.to(device).eval(),
                   max_features=cfg["max_features"],
                   nms_radius=cfg["nms_radius"],
                   threshold=cfg["detection_threshold"])
    lg = LightGlue(lg_net.to(device).eval(), dim=cfg["dim"],
                   n_layers=cfg["n_layers"], heads=cfg["heads"],
                   input_dim=cfg["descriptor_dim"],
                   matmul_precision=cfg["matmul_precision"],
                   activation_dtype=cfg["activation_dtype"])
    state.aliked = {k: v.to(device) for k, v in al_params.items()}
    state.lightglue = {k: v.to(device) for k, v in lg_params.items()}
    state.fn = make_deep_pair_fn(al, lg, num_hypotheses=cfg["num_hypotheses"],
                                 filter_threshold=cfg["filter_threshold"])
    # warm-up: every pool batch (the one shape the window uses) once,
    # recording each batch's operands, then the first batch again
    for k in range(img1.shape[0]):
        out = state.fn(img1[k], img2[k])
        pairs._answer(out)
        state.operands[k] = deep_pairs._operands(cfg, out)
        del out
    pairs._answer(state.fn(img1[0], img2[0]))
    return state


# ---- the check

def _images(state: State, k: int):
    return torch.cat([state.img1[k], state.img2[k]])


def _maps(state: State, image):
    cfg = state.cell.config
    score, feat, at_clamp = reference.aliked_maps(state.aliked, image)
    peaks, scores = reference.select(score, cfg["max_features"],
                                     cfg["detection_threshold"],
                                     cfg["nms_radius"])
    return score, feat, at_clamp, peaks, scores


def _features(state: State, k: int, mode: str) -> list:
    """The reference's features (xy, scores, desc) of pool batch k's 2B
    images under `reference.precision(mode)`."""
    cfg = state.cell.config
    with reference.precision(mode):
        return [reference.aliked(state.aliked, img, cfg["max_features"],
                                 cfg["detection_threshold"],
                                 cfg["nms_radius"])[:3]
                for img in _images(state, k)]


def _reference(state: State, k: int) -> dict:
    """The float32 reference of pool batch k: its features, and its
    chain's answers (kept on the state, for the control too)."""
    if k not in state.reference:
        feats = _features(state, k, "float32")
        outs = deep_pairs._pair_outputs(state, feats, "float32")
        state.reference[k] = {"features": feats,
                              "answers": deep_pairs._answers(state, feats,
                                                             outs)}
        del outs
    return state.reference[k]


def extractor_gaps(state: State, sides: Dict[int, tuple]) -> Dict[str, float]:
    """ALIKED's numbers of `sides` (pool batch -> (features, ...) as
    `deep_pairs._program_side` gives them) against the float32 reference,
    each the worst over every image:
    - al_xy_gap, al_desc_gap: `reference/aliked.py:side_gaps`' DKD
      position gap (px) and 1 - cos of the descriptors, on the shared
      keypoints;
    - al_keypoints_missing_pct: keypoints whose peak one side has and
      the other lacks, % of the keypoints over every image. A sound
      side loses a few to NMS and top-k flips among near-equal scores;
      a wrong NMS radius, threshold or top-k loses many;
    - al_keypoint_flips: those of them that the reference's scores
      decide by more than `reference.SCORE_MARGIN` (no near-tie), over
      every image: a sound side has none, a fault that loses even one
      clear peak an image reads it;
    - al_score_gap (read, not compared): the shared keypoints' scores;
    - al_offsets_at_clamp (read): the reference's deformable and SDDH
      offsets that reach cvg's clamp of max(H, W) / 4, whose absence is
      a departure from cvg."""
    cfg = state.cell.config
    worst = dict(al_xy_gap=0.0, al_desc_gap=0.0, al_score_gap=0.0,
                 al_keypoints_missing_pct=0.0, al_keypoint_flips=0.0,
                 al_offsets_at_clamp=0.0)
    missing = seen = 0
    for k, (feats, _) in sides.items():
        for img, (xy, s, d) in zip(_images(state, k), feats):
            with reference.precision("float32"):
                score, feat, at_clamp, peaks, _ = _maps(state, img)
                g = reference.side_gaps(
                    state.aliked, score, feat, peaks, xy, s, d,
                    (cfg["max_features"], cfg["detection_threshold"],
                     cfg["nms_radius"]))
            for name in ("xy_gap", "desc_gap", "score_gap"):
                worst["al_" + name] = max(worst["al_" + name], g[name])
            worst["al_keypoint_flips"] += g["flips"]
            worst["al_offsets_at_clamp"] += at_clamp + g["at_clamp"]
            missing += g["missing"]
            seen += max(g["n"], len(peaks))
            del score, feat
    worst["al_keypoints_missing_pct"] = 100.0 * missing / max(seen, 1)
    return worst


def matcher_gaps(state: State, sides: Dict[int, tuple],
                 side_ransac) -> Dict[str, float]:
    """LightGlue's and RANSAC's numbers of `sides` against the float32
    reference run on each side's own features, as
    `deep_pairs.network_gaps` computes them (lg_assign_max_gap,
    lg_matchability_gap, lg_argmax_flips; read: lg_decided_rows_pct,
    lg_best_confidence; ransac_*, ransac_inliers_min), without its
    SuperPoint numbers."""
    cfg = state.cell.config
    limit = state.cell.limits["lg_assign_max_gap"]
    gap = deep_pairs._max_gap
    worst = dict(lg_assign_max_gap=0.0, lg_matchability_gap=0.0,
                 lg_argmax_flips=0.0, lg_decided_rows_pct=0.0,
                 lg_best_confidence=0.0)
    rows = decided = 0
    ransac, ransac_ref = [], {}
    for k, (feats, outs) in sides.items():
        ref_outs = deep_pairs._pair_outputs(state, feats, "float32")
        for got, want in zip(outs, ref_outs):
            if got[0].numel():
                worst["lg_best_confidence"] = max(
                    worst["lg_best_confidence"], float(got[0].max().exp()))
            worst["lg_assign_max_gap"] = max(
                worst["lg_assign_max_gap"], gap(got[0], want[0]),
                gap(got[1], want[1]))
            worst["lg_matchability_gap"] = max(
                worst["lg_matchability_gap"], gap(got[2], want[2]),
                gap(got[3], want[3]))
            la = want[4]
            if la.numel():
                best1, mutual = deep_pairs._argmax(la)
                row = deep_pairs._margin(la, 1) > limit
                both = row & (deep_pairs._margin(la, 0)[best1] > limit)
                worst["lg_argmax_flips"] += float(
                    (got[4] != best1)[row].sum()
                    + (got[5] != mutual)[both].sum())
                rows += la.shape[0]
                decided += int(row.sum())
        layout = deep_pairs._ransac_layout(feats, ref_outs, state.warps[k],
                                           cfg["max_features"])
        ransac.append((k, side_ransac(state, *layout)))
        ransac_ref[k] = deep_pairs._plain_ransac(state, *layout, "float32")
        del ref_outs, layout
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
    out.update(extractor_gaps(state, sides))
    out.update(matcher_gaps(state, sides, side_ransac))
    return out


def check(state: State, win: Dict) -> Dict[str, float]:
    sides = {k: deep_pairs._program_side(kept)
             for k, kept in state.kept.items()}
    return _numbers(state, win["answers"], sides, deep_pairs._program_ransac)


def control(state: State) -> Dict[str, float]:
    """The control's numbers: the reference with ALIKED in TF32 and
    LightGlue in bfloat16 with TF32, put in the program's place, against
    the float32 reference."""
    answers, sides = [], {}
    for k in range(state.img1.shape[0]):
        feats = _features(state, k, "tf32")
        outs = deep_pairs._pair_outputs(state, feats, "bfloat16")
        answers.append((k, deep_pairs._answers(state, feats, outs)))
        sides[k] = (feats, [o[:4] + deep_pairs._argmax(o[4]) for o in outs])
        del outs
    return _numbers(state, answers, sides, deep_pairs._control_ransac)
