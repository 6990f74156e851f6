"""Worlds of gloo ranks on the CPU for the port's parallel tests.

`run_world(tmp_path, world, job, inputs)` pickles `inputs` into
`tmp_path`, starts `world` processes of this file (rank, world size and
local rank in the environment, as `torchrun` sets them), each joins a
gloo group through a `file://` store in `tmp_path` with one torch thread,
(or, where `inputs` names a "coordinator", through `init_multihost` at
that TCP address) runs `JOBS[job](inputs)` and pickles what it returns; the parent returns
the ranks' results in rank order, or raises with the output of a rank
that failed. One world a module and a world size: a rank's interpreter,
imports and first `torch.func` call cost seconds.

Imports torch, numpy, the port and `chip_smoke`'s helpers only: a rank
never imports JAX.
"""

import os
import pickle
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240

sys.path.insert(0, REPO)

from chip_smoke import (                                         # noqa: E402
    raw_match_counts, sift_detect_fn, to_host as host,
)


def run_world(tmp_path, world, job, inputs, timeout=TIMEOUT_S):
    tmp = str(tmp_path)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as fh:
        pickle.dump(inputs, fh)
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, tmp],
            env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for rank, (p, _) in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"rank{rank}.log")) as fh:
                raise RuntimeError(f"rank {rank} of {world} ({job}) exited "
                                   f"{p.returncode}:\n{fh.read()[-4000:]}")
    out = []
    for rank in range(world):
        with open(os.path.join(tmp, f"out{rank}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


# ---------------------------------------------------------------- jobs

def job_parallel(inp):
    """tp_knn2 over (1, world), the sharded stereo over (world, 1) and,
    at 4 ranks, ring_knn2 over (1, 4) and the pair step over (2, 2)."""
    import torch
    import torch.distributed as dist
    from tpu3drec_torch.parallel import mesh as pm
    from tpu3drec_torch.parallel.dense import sharded_pairwise_stereo
    from tpu3drec_torch.parallel.pairs import (
        make_batched_pair_step, ring_knn2, tp_knn2,
    )
    world = dist.get_world_size()
    out = {}
    try:
        pm.make_mesh(shape=(world, 2))
    except ValueError as e:
        out["shape_error"] = str(e)
    tp_mesh = pm.make_mesh(shape=(1, world))
    tp = tp_mesh.get_group("tp")
    r = dist.get_rank(tp)
    t = torch.from_numpy
    out["tp_knn2"] = []
    for d1, d2, m1, m2, metric in inp["tp_knn2"]:
        w = d2.shape[0] // world
        cols = slice(r * w, (r + 1) * w)
        out["tp_knn2"].append(host(tp_knn2(
            t(d1), t(d2[cols]).contiguous(), t(m1), t(m2[cols]).contiguous(),
            tp, metric)))
    if "ring" in inp:
        d1, d2, m1, m2 = inp["ring"]
        n, m = d1.shape[0] // world, d2.shape[0] // world
        rows, cols = slice(r * n, (r + 1) * n), slice(r * m, (r + 1) * m)
        out["ring"] = host(ring_knn2(t(d1[rows]), t(d2[cols]), t(m1[rows]),
                                     t(m2[cols]), tp))
    if "pair_step" in inp:
        ps = inp["pair_step"]
        step = make_batched_pair_step(
            pm.make_mesh(shape=ps["mesh"]), sift_detect_fn(ps["max_features"]),
            num_hypotheses=ps["num_hypotheses"])
        out["pair_step"] = host(step(t(ps["imgs1"]), t(ps["imgs2"]),
                                     t(ps["u"])))
    if "stereo" in inp:
        st = inp["stereo"]
        outs = sharded_pairwise_stereo(
            pm.make_mesh(shape=(world, 1)), st["base"], st["neighbours"],
            st["K"], num_disparities=st["num_disparities"], device="cpu")
        out["stereo"] = host(outs)
    if "dense" in inp:
        from tpu3drec_torch.pipelines.dense import DenseReconstructionPipeline
        sparse, images, ndisp = inp["dense"]
        pipe = DenseReconstructionPipeline(num_disparities=ndisp,
                                           device="cpu")
        rep = pipe.run_complete_pipeline(sparse, images,
                                         reference_view="v0.png")
        out["dense"] = {"depth": pipe._arrays["depth"],
                        "per_view": rep["depth"]["per_view"]}
    return out


def job_ba(inp):
    """sharded_bundle_adjust over (world, 1) on each problem of
    `inp["problems"]`, and at 2 ranks the SfM pipeline's sharded global
    BA on `inp["sfm"]`."""
    import tpu3drec_torch as tv
    from tpu3drec_torch.ops.ba import BAConfig, BAProblem
    from tpu3drec_torch.parallel.ba import sharded_bundle_adjust
    from tpu3drec_torch.parallel.mesh import make_mesh, world_size
    mesh = make_mesh(shape=(world_size(), 1))
    out = {"ba": []}
    for arrays, cfg in inp["problems"]:
        res = sharded_bundle_adjust(
            BAProblem.from_numpy(**arrays, device="cpu"), mesh,
            BAConfig(**cfg))
        out["ba"].append(host(res._asdict()))
    if "sfm" in inp:
        matches_data, info = inp["sfm"]
        pipe = tv.SfMPipeline(tv.SfMConfig(sharded_ba_min_obs=0),
                              device="cpu")
        recon = pipe.reconstruct(dict(matches_data), info)
        from tpu3drec_torch.sfm.quality import reprojection_errors
        out["sfm"] = {
            "global_ba": [{k: v for k, v in h.items() if k != "time_s"}
                          for h in pipe.history
                          if h.get("phase") == "global_ba"],
            "cameras": {n: (c.R, c.t) for n, c in recon.cameras.items()},
            "points": np.asarray(recon.points),
            "mean_reproj": float(np.mean(reprojection_errors(recon)))}
    return out


def job_multihost(inp):
    """shard_pairs and global_pair_stats as the reference's two-process
    test drives them, and match_folder_sharded on `inp["folder"]`."""
    import torch.distributed as dist
    from tpu3drec_torch.parallel.multihost import (
        global_pair_stats, match_folder_sharded, shard_pairs,
    )
    from tpu3drec_torch.pipelines.matching import create_pipeline
    pid, nproc = dist.get_rank(), dist.get_world_size()
    pairs = [(f"i{k}.png", f"i{k + 1}.png") for k in range(7)]
    mine = shard_pairs(pairs, nproc, pid)
    total = global_pair_stats({"pairs": float(len(mine)),
                               "matches": 10.0 * (pid + 1)})
    pipe = create_pipeline(inp["preset"], inp["config"], device="cpu")
    raw = raw_match_counts(pipe)
    summary = match_folder_sharded(inp["folder"], inp["out"], nproc, pid,
                                   pipeline=pipe, batch_size=2)
    return {"mine": len(mine), "total": total, "raw": raw,
            "global": summary["global"], "stats": summary["stats"]}


JOBS = {"parallel": job_parallel, "ba": job_ba, "multihost": job_multihost}


def main():
    job, tmp = sys.argv[1], sys.argv[2]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    if "coordinator" in inputs:
        from tpu3drec_torch.parallel.multihost import init_multihost
        init_multihost(inputs["coordinator"], world, rank, device="cpu")
    else:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=rank, world_size=world)
    try:
        result = JOBS[job](inputs)
        with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
        bad = [m for m in ("jax", "tpu3drec") if m in sys.modules]
        if bad:
            raise RuntimeError(f"a rank imported {bad}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
