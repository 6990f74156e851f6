"""Command line of the PyTorch/CUDA port of tpu3drec.

Port of `tpu3drec/cli.py`: the same subcommands, exit codes and printed
JSON keys, each over the port's `api`, plus `--device` (default `cuda`;
`cpu` runs the plain PyTorch versions of the kernels):

    python -m tpu3drec_torch match-folder IMAGES OUT [--preset balanced ...]
    python -m tpu3drec_torch reconstruct MATCHES OUT
    python -m tpu3drec_torch dense SPARSE_PKL IMAGES OUT
    python -m tpu3drec_torch benchmark [--folder IMAGES] [--methods SIFT ORB]
    python -m tpu3drec_torch pair IMG1 IMG2 [--method SIFT] [--viz out.png]
    python -m tpu3drec_torch compat-matrix
    python -m tpu3drec_torch serve [--port 8765]
    python -m tpu3drec_torch auto IMAGES OUT [--dense]

Without a card, every subcommand that computes raises unless it is given
`--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_match_folder(args) -> int:
    from tpu3drec_torch.api import create_pipeline
    pipe = create_pipeline(args.preset,
                           {"max_features": args.max_features}
                           if args.max_features else None,
                           device=args.device)
    summary = pipe.match_folder(
        args.images, args.output, pair_mode=args.pair_mode,
        pair_window=args.pair_window, batch_size=args.batch_size,
        resume=not args.no_resume, export_colmap=args.colmap,
        max_images=args.max_images)
    print(json.dumps(summary, indent=2, default=str))
    return 0 if summary["stats"]["failed"] == 0 else 1


def _cmd_reconstruct(args) -> int:
    from tpu3drec_torch.sfm import (
        assess_reconstruction_quality, reconstruct_scene,
    )
    from tpu3drec_torch.sfm.quality import print_quality_report
    recon = reconstruct_scene(args.matches, output_dir=args.output,
                              device=args.device)
    q = assess_reconstruction_quality(recon)
    print_quality_report(q)
    return 0 if recon.num_cameras >= 2 else 1


def _cmd_dense(args) -> int:
    import pickle
    from tpu3drec_torch.io.images import FolderImageSource
    from tpu3drec_torch.pipelines.dense import run_dense_reconstruction
    with open(args.sparse, "rb") as f:
        sparse = pickle.load(f)
    src = FolderImageSource(args.images)
    images = src.load_many(src.names())
    res = run_dense_reconstruction(sparse, images, output_dir=args.output,
                                   num_disparities=args.num_disparities,
                                   device=args.device)
    print(json.dumps(res, indent=2, default=str))
    return 0


def _cmd_benchmark(args) -> int:
    from tpu3drec_torch.bench.runner import (
        UnifiedBenchmarkConfig, UnifiedBenchmarkPipeline,
    )
    cfg = UnifiedBenchmarkConfig(methods=tuple(args.methods),
                                 num_runs=args.num_runs,
                                 max_features=args.max_features or 2000)
    pipe = UnifiedBenchmarkPipeline(cfg, device=args.device)
    if args.folder:
        res = pipe.benchmark_folder(args.folder)
    else:
        res = pipe.benchmark_synthetic()
    pipe.print_table(res)
    path = pipe.save_results(res, args.output)
    print(f"saved: {path}")
    return 0


def _cmd_pair(args) -> int:
    from tpu3drec_torch.io.images import _read_image
    from tpu3drec_torch.api import match_images
    img1 = _read_image(args.image1)
    img2 = _read_image(args.image2)
    r = match_images(img1, img2, method=args.method,
                     max_features=args.max_features or 2048,
                     device=args.device)
    print(json.dumps({
        "method": r.method,
        "num_matches": r.num_matches,
        "num_raw_matches": r.num_raw_matches,
        "inlier_ratio": r.inlier_ratio,
        "reprojection_error": r.reprojection_error,
        "quality_score": r.get_quality_score(),
    }, indent=2))
    if args.viz:
        from tpu3drec_torch import viz
        ax = viz.visualize_matches(img1, img2, r)
        viz.save_visualization(ax, args.viz)
        print(f"visualization: {args.viz}")
    return 0


def _cmd_compat_matrix(args) -> int:
    from tpu3drec_torch.core.registry import MatcherCompatibilityManager
    MatcherCompatibilityManager().print_compatibility_matrix()
    return 0


def _cmd_serve(args) -> int:
    from tpu3drec_torch.serve import serve_forever
    serve_forever(host=args.host, port=args.port,
                  shape=(args.height, args.width),
                  max_features=args.max_features,
                  warmup=not args.no_warmup, device=args.device)
    return 0


def _cmd_auto(args) -> int:
    from tpu3drec_torch.api import reconstruct_folder
    result = reconstruct_folder(
        args.images, args.output, preset=args.preset, dense=args.dense,
        pair_mode=args.pair_mode, pair_window=args.pair_window,
        device=args.device)
    recon = result["reconstruction"]
    print(json.dumps({"cameras": recon.num_cameras,
                      "points": recon.num_points,
                      "observations": recon.num_observations,
                      "output": str(args.output)}, indent=2))
    return 0 if recon.num_cameras >= 2 else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu3drec_torch",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="command", required=True)
    # every subcommand takes the device its work runs on
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda",
                     help="torch device: cuda (default) or cpu")

    mf = sub.add_parser(
        "match-folder", parents=[dev], help="batch-match an image folder")
    mf.add_argument("images")
    mf.add_argument("output")
    mf.add_argument("--preset", default="balanced")
    mf.add_argument("--pair-mode", default="consecutive",
                    choices=["consecutive", "first", "all"])
    mf.add_argument("--pair-window", type=int, default=1)
    mf.add_argument("--batch-size", type=int, default=8)
    mf.add_argument("--max-features", type=int)
    mf.add_argument("--max-images", type=int)
    mf.add_argument("--no-resume", action="store_true")
    mf.add_argument("--colmap", action="store_true")
    mf.set_defaults(fn=_cmd_match_folder)

    rc = sub.add_parser(
        "reconstruct", parents=[dev], help="incremental SfM from matches")
    rc.add_argument("matches", help="batch pickle path or pattern")
    rc.add_argument("output")
    rc.set_defaults(fn=_cmd_reconstruct)

    dn = sub.add_parser(
        "dense", parents=[dev], help="dense reconstruction")
    dn.add_argument("sparse", help="optimized_camera_poses.pkl")
    dn.add_argument("images")
    dn.add_argument("output")
    dn.add_argument("--num-disparities", type=int, default=64)
    dn.set_defaults(fn=_cmd_dense)

    bm = sub.add_parser(
        "benchmark", parents=[dev], help="performance + accuracy benchmark")
    bm.add_argument("--folder")
    bm.add_argument("--methods", nargs="+", default=["SIFT", "ORB"])
    bm.add_argument("--num-runs", type=int, default=5)
    bm.add_argument("--max-features", type=int)
    bm.add_argument("--output", default="benchmark_results")
    bm.set_defaults(fn=_cmd_benchmark)

    pr = sub.add_parser(
        "pair", parents=[dev], help="match one image pair")
    pr.add_argument("image1")
    pr.add_argument("image2")
    pr.add_argument("--method", default="SIFT")
    pr.add_argument("--max-features", type=int)
    pr.add_argument("--viz", help="save match visualization to this path")
    pr.set_defaults(fn=_cmd_pair)

    cm = sub.add_parser(
        "compat-matrix", parents=[dev],
        help="print the detector/matcher compatibility matrix")
    cm.set_defaults(fn=_cmd_compat_matrix)

    sv = sub.add_parser(
        "serve", parents=[dev], help="HTTP match server (every request "
        "resized to one canonical shape; concurrent SIFT matches batched)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8765)
    sv.add_argument("--height", type=int, default=480)
    sv.add_argument("--width", type=int, default=640)
    sv.add_argument("--max-features", type=int, default=1024)
    sv.add_argument("--no-warmup", action="store_true")
    sv.set_defaults(fn=_cmd_serve)

    au = sub.add_parser(
        "auto", parents=[dev], help="end-to-end: matching -> SfM "
        "[-> dense] in one run (in-process stage handoff)")
    au.add_argument("images")
    au.add_argument("output")
    au.add_argument("--preset", default="balanced")
    au.add_argument("--pair-mode", default="consecutive",
                    choices=["consecutive", "first", "all"])
    au.add_argument("--pair-window", type=int, default=2)
    au.add_argument("--dense", action="store_true")
    au.set_defaults(fn=_cmd_auto)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
