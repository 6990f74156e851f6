"""Closed-loop runs of the dense stage on one posed folder.

The scene is rendered (`gen/splats.py`): the configuration's scene
(`scene_seed`), with sensor noise drawn from the seed, so every seed
asks for about the same work. The sparse input
is built from the renderer's own cameras and points in the legacy
format the stage reads. One caller runs the stage back to back, each run
as `tpu3drec_torch.pipelines.dense.run_dense_reconstruction` makes it (a
`DenseReconstructionPipeline` with the defaults on the card, then
`run_complete_pipeline`), with no output directory. The window ends with
the last run that started inside it.

`correct` compares every run's fused depth (its valid count and its
views) and the last run's depth map, filtered cloud, normals, cloud
statistics and mesh with the plain reference run on the same inputs
after the window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from recbench.gen import splats
from recbench.reference import dense as reference


@dataclass
class State:
    cell: object
    device: str
    scene: Dict
    sparse: Dict
    last: Dict = None      # the last run's arrays


def _run(state: State) -> Dict:
    from tpu3drec_torch.pipelines.dense import DenseReconstructionPipeline
    pipe = DenseReconstructionPipeline(device=state.device,
                                       **state.cell.config["dense"])
    res = pipe.run_complete_pipeline(state.sparse, state.scene["images"])
    arr = pipe._arrays
    state.last = {"depth": arr["depth"], "points": arr["points"],
                  "normals": arr["normals"], "verts": arr["vertices"],
                  "faces": arr["faces"], "quality": res["point_cloud"]}
    return {"timings_s": res["timings_s"],
            "views": len(res["depth"]["per_view"]),
            "valid": int(np.count_nonzero(arr["depth"] > 0)),
            "points": int(len(arr["points"]))}


def setup(cell, seed: int, device: str) -> State:
    from tpu3drec_torch import _nvcc
    cfg = cell.config
    if torch.device(device).type == "cuda":
        _nvcc.build([n for n in ("sgm",)
                     if not _nvcc.library_path(n).exists()])
    scene = splats.render_splat_views(cfg["views"], cfg["points"],
                                      cfg["scene_seed"], seed,
                                      cfg["sensor_noise"], f=cfg["focal"],
                                      width=cfg["width"],
                                      height=cfg["height"])
    state = State(cell=cell, device=device, scene=scene,
                  sparse=splats.sparse_input(scene))
    _run(state)            # warm-up: the one set of shapes the window runs
    return state


def window(state: State, seconds: float) -> Dict:
    cfg = state.cell.config
    runs = []
    t0 = end = time.perf_counter()
    while end - t0 < seconds:
        runs.append(_run(state))
        end = time.perf_counter()
    mpix = sum(r["views"] for r in runs) * cfg["width"] * cfg["height"] / 1e6
    return {"metrics": {"depth_mpix_per_s": mpix / (end - t0)},
            "attempted": len(runs), "failed": 0, "runs": runs}


def trace(state: State, win: Dict) -> Dict:
    """Profiles one more run."""
    from recbench.trace.profile import profile
    cfg = state.cell.config
    tr = profile(torch, lambda: _run(state), state.device)
    pairs = cfg["views"] - 1
    return {"trace": tr, "runs": win["runs"],
            # the left and right cost volumes of every pair, (D, H, W) each
            "sgm_elements": 2 * pairs * cfg["dense"]["num_disparities"]
            * cfg["height"] * cfg["width"]}


def release(state: State) -> None:
    if torch.device(state.device).type == "cuda":
        torch.cuda.empty_cache()


def cloud_pixels(points: np.ndarray, cam: Dict, stride: int):
    """Each point's reference-view lattice pixel (row, col) of the stride
    grid, or -1 where it does not project onto one."""
    K = np.asarray(cam["camera_matrix"], np.float64)
    R = np.asarray(cam["rotation"], np.float64)
    t = np.asarray(cam["translation"], np.float64)
    Xc = points.astype(np.float64) @ R.T + t
    u = K[0, 0] * Xc[:, 0] / Xc[:, 2] + K[0, 2]
    v = K[1, 1] * Xc[:, 1] / Xc[:, 2] + K[1, 2]
    col, row = np.rint(u / stride), np.rint(v / stride)
    on = (np.abs(u - col * stride) < 1e-2) & (np.abs(v - row * stride) < 1e-2)
    return np.where(on, row, -1).astype(np.int64), \
        np.where(on, col, -1).astype(np.int64)


NORMAL_OFF_DEG = 10.0     # a normal this far from the reference's is off
MESH_NEAR_VOXELS = 0.1    # a vertex this near the other mesh's is matched
_QUALITY = (("num_points",), ("rms_radius",),
            ("density", "mean_nearest_distance"),
            ("density", "median_nearest_distance"),
            ("density", "std_nearest_distance"))


def _field(d: Dict, path):
    for k in path:
        if not isinstance(d, dict) or k not in d:
            return None
        d = d[k]
    return float(d)


def _nearest(a: np.ndarray, b: np.ndarray, device,
             chunk: int = 4096) -> np.ndarray:
    """Each row of `a`'s distance to the nearest row of `b` (both (n, 3),
    non-empty), on `device`."""
    mid = b.mean(0)
    ta = torch.as_tensor(a - mid, dtype=torch.float32, device=device)
    tb = torch.as_tensor(b - mid, dtype=torch.float32, device=device)
    out = [torch.cdist(ta[s:s + chunk], tb,
                       compute_mode="donot_use_mm_for_euclid_dist")
           .min(1).values for s in range(0, len(ta), chunk)]
    return torch.cat(out).double().cpu().numpy()


def surface_numbers(last: Dict, ref: Dict, ri: np.ndarray, pi: np.ndarray,
                    device) -> Dict[str, float]:
    """The numbers of the last run's normals, cloud statistics and mesh
    against the reference's (`ri`, `pi`: the reference's and the run's
    cloud points matched by their lattice pixel):
    - normals_off_pct: matched points whose normal lies more than 10
      degrees from the reference's, in % (sign counted: both face the
      reference camera);
    - cloud_quality_gap_rel: the largest relative gap of the cloud's
      size, RMS radius and nearest-neighbour mean, median and spread;
    - cloud_clusters_gap: the gap in clusters plus the gap in outliers;
    - mesh_count_gap_pct: the larger gap of the vertex and face counts,
      in % of the reference's;
    - mesh_mismatch_pct: vertices of either mesh farther than 0.1 voxel
      from the other's nearest vertex, over the reference's vertices,
      in %.
    `normals_angle_p50_deg` and `mesh_vertex_gap_vox` are printed
    beside them and not compared."""
    out = {}
    pn = last.get("normals")
    if pn is None or len(pn) != len(last["points"]) or (
            len(ref["points"]) and not len(ri)):
        out.update(normals_off_pct=100.0, normals_angle_p50_deg=np.inf)
    elif len(ri):
        cos = np.sum(np.asarray(pn, np.float64)[pi]
                     * np.asarray(ref["normals"], np.float64)[ri], 1)
        ang = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
        out.update(normals_off_pct=100.0 * float(np.mean(ang
                                                         > NORMAL_OFF_DEG)),
                   normals_angle_p50_deg=float(np.median(ang)))
    else:
        out.update(normals_off_pct=0.0, normals_angle_p50_deg=0.0)
    q, rq = last.get("quality") or {}, ref["quality"]
    gaps = []
    for path in _QUALITY:
        r, v = _field(rq, path), _field(q, path)
        if r is None and v is None:
            continue
        gaps.append(np.inf if r is None or v is None
                    else abs(v - r) / max(abs(r), 1e-12))
    out["cloud_quality_gap_rel"] = max(gaps, default=0.0)
    pc, rc = q.get("clustering"), rq.get("clustering")
    out["cloud_clusters_gap"] = (
        0.0 if pc is None and rc is None else np.inf if pc is None
        or rc is None else float(abs(pc["num_clusters"] - rc["num_clusters"])
                                 + abs(pc["num_outliers"]
                                       - rc["num_outliers"])))
    pv, pf = np.asarray(last["verts"]), np.asarray(last["faces"])
    rv, rf = np.asarray(ref["verts"]), np.asarray(ref["faces"])
    out["mesh_count_gap_pct"] = 100.0 * max(
        abs(len(pv) - len(rv)) / max(len(rv), 1),
        abs(len(pf) - len(rf)) / max(len(rf), 1))
    if not len(pv) or not len(rv):
        same = not len(pv) and not len(rv)
        out.update(mesh_mismatch_pct=0.0 if same else 100.0,
                   mesh_vertex_gap_vox=0.0 if same else np.inf)
    else:
        dp, dr = _nearest(pv, rv, device), _nearest(rv, pv, device)
        near = MESH_NEAR_VOXELS * ref["voxel"]
        out["mesh_mismatch_pct"] = 100.0 * float(
            np.sum(dp > near) + np.sum(dr > near)) / len(rv)
        out["mesh_vertex_gap_vox"] = float(max(dp.max(), dr.max())
                                           / ref["voxel"])
    return out


def numbers(runs, last: Dict, ref: Dict, sparse: Dict,
            stride: int, device="cpu") -> Dict[str, float]:
    """The compared numbers of the program's runs against the reference:
    - views_missing: the most neighbour views a run fused fewer than the
      reference;
    - valid_count_gap_pct: the largest gap of a run's valid depth count
      to the reference's, in % of it;
    - depth_valid_mismatch_pct: pixels of the last run's depth map whose
      validity differs from the reference's, in %;
    - depth_gap_rel: the largest relative depth gap where both are valid;
    - cloud_mismatch_pct: lattice pixels in one filtered cloud and not the
      other (points matched by the pixel they project to), over the
      reference's points, in %;
    - cloud_gap_rel: the largest gap of a matched point, relative to its
      depth;
    and those of `surface_numbers`."""
    ref_valid = int(ref["valid"].sum())
    out = {"views_missing": float(max(ref["views"] - r["views"]
                                      for r in runs)),
           "valid_count_gap_pct": max(100.0 * abs(r["valid"] - ref_valid)
                                      / max(ref_valid, 1) for r in runs)}
    depth = last["depth"]
    valid = depth > 0
    if depth.shape != ref["depth"].shape:
        out.update(depth_valid_mismatch_pct=100.0, depth_gap_rel=np.inf,
                   cloud_mismatch_pct=100.0, cloud_gap_rel=np.inf)
        empty = np.zeros(0, np.int64)
        out.update(surface_numbers(last, ref, empty, empty, device))
        return out
    out["depth_valid_mismatch_pct"] = 100.0 * float(
        np.mean(valid != ref["valid"]))
    both = valid & ref["valid"]
    out["depth_gap_rel"] = float(np.max(
        np.abs(depth[both] - ref["depth"][both]) / ref["depth"][both],
        initial=0.0))
    cams = sparse["camera_poses"]
    names = list(cams)
    cam = cams[names[len(names) // 2]]
    w = (depth.shape[1] + stride - 1) // stride
    r_row, r_col = cloud_pixels(ref["points"], cam, stride)
    p_row, p_col = cloud_pixels(last["points"], cam, stride)
    r_key = r_row * w + r_col
    p_key = np.where(p_row >= 0, p_row * w + p_col, -1 - np.arange(len(p_row)))
    common, ri, pi = np.intersect1d(r_key, p_key, return_indices=True)
    n_ref = max(len(ref["points"]), 1)
    out["cloud_mismatch_pct"] = 100.0 * (len(r_key) + len(p_key)
                                         - 2 * len(common)) / n_ref
    if len(common):
        gap = np.linalg.norm(ref["points"][ri] - last["points"][pi], axis=1)
        z = np.abs(ref["points"][ri] @ np.asarray(cam["rotation"])[2]
                   + cam["translation"][2])
        out["cloud_gap_rel"] = float(np.max(gap / np.maximum(z, 1e-9)))
    else:
        out["cloud_gap_rel"] = np.inf
    out.update(surface_numbers(last, ref, ri, pi, device))
    return out


def cloud_stride(cfg: Dict) -> int:
    """The lattice step at which the dense stage backprojects its depth."""
    return max(1, int(np.ceil(np.sqrt(
        cfg["height"] * cfg["width"] / cfg["dense"]["max_cloud_points"]))))


def reference_result(state: State, precision: str = "float32") -> Dict:
    cfg = state.cell.config["dense"]
    with torch.no_grad():
        ref = reference.dense_depth_and_cloud(
            state.sparse, state.scene["images"], state.device,
            num_disparities=cfg["num_disparities"],
            max_cloud_points=cfg["max_cloud_points"],
            outlier_k=cfg["outlier_k"], outlier_std=cfg["outlier_std"],
            tsdf_resolution=cfg["tsdf_resolution"], precision=precision)
    if torch.device(state.device).type == "cuda":
        torch.cuda.empty_cache()
    return ref


def check(state: State, win: Dict) -> Dict[str, float]:
    return numbers(win["runs"], state.last, reference_result(state),
                   state.sparse, cloud_stride(state.cell.config),
                   state.device)


def control(state: State) -> Dict[str, float]:
    """The control's numbers: the reference computed in bfloat16, put in
    the program's place, against the float32 reference."""
    ctrl = reference_result(state, "bfloat16")
    ref = reference_result(state)
    run = {"views": ctrl["views"], "valid": int(ctrl["valid"].sum())}
    last = dict(ctrl, depth=np.where(ctrl["valid"], ctrl["depth"], 0.0))
    return numbers([run], last, ref, state.sparse,
                   cloud_stride(state.cell.config), state.device)
