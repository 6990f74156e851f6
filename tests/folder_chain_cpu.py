"""chip_smoke.py's folder chain (phases 7 and 8) on the CPU, through the
port or the JAX reference, with what those phases' bars read.

    python tests/folder_chain_cpu.py port --dense
    python tests/folder_chain_cpu.py reference --dense
    python tests/folder_chain_cpu.py port --dense --preset accurate

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
share and mesh. Not a test: pytest does not collect it.
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
    args = ap.parse_args()

    import chip_smoke as cs
    if args.package == "reference":
        import jax
        jax.config.update("jax_platforms", "cpu")
        import tpu3drec as pkg
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
        t0 = time.perf_counter()
        res = pkg.reconstruct_folder(
            folder, os.path.join(tmp, "out"), preset=args.preset,
            pair_mode="consecutive", pair_window=cs.FOLDER_PAIR_WINDOW,
            dense=args.dense, **kw)
        seconds = time.perf_counter() - t0
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
    print(json.dumps(out, default=float))


if __name__ == "__main__":
    main()
