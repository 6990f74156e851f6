"""chip_smoke.py's folder chain (phases 7 and 8) on the CPU, through the
port or the JAX reference, with what those phases' bars read.

    python tests/folder_chain_cpu.py port --dense
    python tests/folder_chain_cpu.py reference --dense
    python tests/folder_chain_cpu.py port --dense --preset accurate
    python tests/folder_chain_cpu.py port --implicit

Renders `chip_smoke.render_splat_views`' folder (24 views of 640x480,
600 splats, f = 544, seed 0) as .npy into a temporary directory, runs
that package's `reconstruct_folder(preset=...,
pair_mode="consecutive", pair_window=2)` on the CPU (preset "balanced",
phase 7's, by default; "accurate" is phase 8's) and prints one JSON
line: each method's keypoints per view (median, min, max of the
preset's `max_features` slots, from one batched detection of all
views), the views
registered, points, final mean reprojection, the relative-rotation
error against the renderer (deg) of each two registered views that are
neighbours once the unregistered ones are left out, the matching
summary and, with `--dense`, the dense stage's cloud, fused-depth valid
share and mesh. With `--implicit` (phase 9's runs) the dense stage's
input is kept and run again through `DenseReconstructionPipeline` once
per implicit mesh method (poisson, ball_pivot, alpha) and once through
`run_multi_reference(num_refs=3, mesh_method="poisson")`, each with its
stage seconds, cloud, mesh method, faces and mesh quality, and the ICP
steps' rotation (deg) and translation (share of the cloud's extent).
Not a test: pytest does not collect it.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=("port", "reference"))
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--preset", default="balanced")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch's CPU threads (the port's run only)")
    ap.add_argument("--implicit", action="store_true",
                    help="phase 9's implicit meshes and multi-reference run")
    args = ap.parse_args()

    import chip_smoke as cs
    if args.package == "reference":
        import jax
        jax.config.update("jax_platforms", "cpu")
        import tpu3drec as pkg
        import tpu3drec.pipelines.dense as pdense
        import tpu3drec.ops.pointcloud as pcl
        from tpu3drec.api import _detector_params, _get_detector_registry
        from tpu3drec.core.config import create_config_from_preset
        from tpu3drec.sfm.quality import reprojection_errors
        kw = {}

        def to_array(x):
            return jax.numpy.asarray(x)
    else:
        import torch
        if args.threads:
            torch.set_num_threads(args.threads)
        import tpu3drec_torch as pkg
        import tpu3drec_torch.pipelines.dense as pdense
        import tpu3drec_torch.ops.pointcloud as pcl
        from tpu3drec_torch.api import _detector_params, _get_detector_registry
        from tpu3drec_torch.core.config import create_config_from_preset
        from tpu3drec_torch.sfm.quality import reprojection_errors
        kw = {"device": "cpu"}

        def to_array(x):
            return torch.from_numpy(x)

    with tempfile.TemporaryDirectory(prefix="folder_chain_") as tmp:
        folder = os.path.join(tmp, "imgs")
        os.mkdir(folder)
        names, Rs = cs.render_splat_views(folder, cs.FOLDER_VIEWS,
                                          cs.FOLDER_POINTS)
        cfg = create_config_from_preset(args.preset)
        views = np.stack([np.load(os.path.join(folder, n)).astype(np.float32)
                          / 255.0 for n in names])
        fill = {}
        for method in cfg["methods"]:
            det = _get_detector_registry()[method]
            params = _detector_params(method, cfg, None)
            if args.package == "reference":
                valid = [int(np.asarray(det(to_array(v), **params).mask).sum())
                         for v in views]
            else:
                valid = det(to_array(views), **params).mask.sum(1).tolist()
            fill[method] = {"slots": cfg["max_features"],
                            "median": float(np.median(valid)),
                            "min": int(min(valid)), "max": int(max(valid))}
        handed = {}
        dense_entry = pdense.run_dense_reconstruction

        def dense_spy(sparse, images, *a, **k):
            handed["dense"] = (sparse, images)
            return dense_entry(sparse, images, *a, **k) if args.dense else {}

        pdense.run_dense_reconstruction = dense_spy
        t0 = time.perf_counter()
        res = pkg.reconstruct_folder(
            folder, os.path.join(tmp, "out"), preset=args.preset,
            pair_mode="consecutive", pair_window=cs.FOLDER_PAIR_WINDOW,
            dense=args.dense or args.implicit, **kw)
        seconds = time.perf_counter() - t0
        pdense.run_dense_reconstruction = dense_entry
        implicit = (implicit_runs(args, pdense, pcl, *handed["dense"], kw)
                    if args.implicit else None)
    recon = res["reconstruction"]
    errs = reprojection_errors(recon)
    rot = cs.consecutive_rotation_errors(recon, Rs, names)
    m = res["matching"]
    dense = res.get("dense") or {}
    out = {
        "package": args.package, "preset": args.preset,
        "threads": args.threads, "keypoints_per_view": fill,
        "seconds": round(seconds, 3),
        "timings_s": {k: round(v, 3) for k, v in
                      res.get("timings_s", {}).items()},
        "registered": recon.num_cameras,
        "missing": sorted(set(names) - set(recon.cameras)),
        "points": recon.num_points,
        "mean_reprojection_px": float(np.mean(errs)) if len(errs) else None,
        "rotation_errors_deg": [round(float(r), 4) for r in rot],
        "rotation_median_deg": float(np.median(rot)) if len(rot) else None,
        "rotation_share_within_1deg": float(np.mean(rot < 1.0)) if len(rot)
        else None,
        "matching": {"stats": {k: m["stats"].get(k) for k in
                               ("total_pairs", "completed", "failed",
                                "engine_fallbacks", "method_errors")},
                     "methods": m.get("methods")},
    }
    if dense:
        out["dense"] = {
            "reference_view": dense.get("reference_view"),
            "num_views": dense.get("num_views"),
            "cloud_points": dense["point_cloud"]["num_points"],
            "valid_fraction": dense["depth"]["valid_fraction"],
            "mesh_faces": dense["mesh"]["num_faces"],
            "timings_s": dense.get("timings_s"),
        }
    if implicit is not None:
        out["implicit"] = implicit
    print(json.dumps(out, default=float))


def implicit_runs(args, pdense, pcl, sparse, images, kw):
    """Phase 9's runs on the chain's dense input: each implicit mesh
    method, then multi-reference mode with ICP merging."""
    import numpy as np
    import chip_smoke as cs
    if args.package == "reference":
        kw = {"use_sharded_stereo": False}
    out = {}
    for m in ("poisson", "ball_pivot", "alpha"):
        pipe = pdense.DenseReconstructionPipeline(mesh_method=m, **kw)
        r = pipe.run_complete_pipeline(sparse, images)
        out[m] = {"timings_s": r["timings_s"],
                  "cloud_points": r["point_cloud"]["num_points"],
                  "valid_fraction": r["depth"]["valid_fraction"],
                  "reference_view": r["reference_view"], "mesh": r["mesh"]}
    steps = []
    icp_entry = pcl.icp_register

    def icp_spy(src, dst, *a, **k):
        R, t = icp_entry(src, dst, *a, **k)
        tn = np.asarray(t, np.float64)
        d = np.asarray(dst)
        steps.append({"rotation_deg": cs.rot_err_deg(np.asarray(R),
                                                     np.eye(3)),
                      "translation_share":
                      float(np.linalg.norm(tn) / np.ptp(d, axis=0).max())})
        return R, t

    pcl.icp_register = icp_spy
    try:
        pipe = pdense.DenseReconstructionPipeline(mesh_method="poisson", **kw)
        t0 = time.perf_counter()
        r = pipe.run_multi_reference(sparse, images, num_refs=3)
        multi_s = time.perf_counter() - t0
    finally:
        pcl.icp_register = icp_entry
    out["multi_reference"] = {
        "seconds": multi_s, "reference_views": r["reference_views"],
        "per_reference": r["per_reference"],
        "merged_points": r["point_cloud"]["num_points"], "mesh": r["mesh"],
        "icp": steps}
    return out


if __name__ == "__main__":
    main()
