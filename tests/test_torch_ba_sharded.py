"""Parity of tpu3drec_torch.parallel.ba (sharded Schur-CG bundle
adjustment) and the SfM pipeline's sharded global BA with the JAX
package's, on the scenes of `tests/test_ba_sharded.py`.

`shard_ba_problem` runs in this process and must equal the reference's
layout bit for bit (padding included). The sharded solves run in gloo
worlds of 2 and 4 ranks on the CPU (`torch_dist_worker.py`, one world a
size for the module); the reference's `sharded_bundle_adjust` runs with
`shard_map` over the 8 virtual CPU devices. Bars, those of
`test_ba_sharded.py`: cameras at 1e-2, final cost within 1e-2 relative
plus 1e-3, mean reprojection within 1e-3 px; at `ftol=0` and 2 LM
iterations, against the port's single-process solve (what a world of one
rank runs, bit for bit): cameras at 5e-3, mean reprojection within
5e-3 px. Replicated outputs (cameras, costs, iterations, mean
reprojection) are bit-identical on every rank: each rank reads the same
`all_reduce` results.
"""

import os
import sys

import jax
import numpy as np
import pytest
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_ba import build_problem, make_ba_scene                 # noqa: E402
from torch_dist_worker import run_world                          # noqa: E402
from tpu3drec.ops.ba import BAConfig as JConfig                  # noqa: E402
from tpu3drec.parallel.ba import (                               # noqa: E402
    shard_ba_problem as j_shard, sharded_bundle_adjust as j_sharded,
)
from tpu3drec.parallel.mesh import make_mesh as j_make_mesh      # noqa: E402
from tpu3drec_torch.bench.synthetic import make_sfm_scene        # noqa: E402
from tpu3drec_torch.ops import ba as tb                          # noqa: E402
from tpu3drec_torch.parallel.ba import shard_ba_problem          # noqa: E402

CONVERGE = dict(max_iters=15, schur_solver="cg")
TWO_STEPS = dict(max_iters=2, schur_solver="cg", ftol=0.0)
REPLICATED = ("cam_params", "cost_initial", "cost_final", "iterations",
              "mean_reproj_px", "stats")


def _np(jprob):
    return {k: np.asarray(v) for k, v in jprob._asdict().items()}


def _scene():
    """tests/test_ba_sharded.py's convergence scene (6 cameras, 300
    points, 0.3 px noise, jittered start)."""
    K, cams, X, oc, op, uv = make_ba_scene(n_cams=6, n_pts=300, noise_px=0.3)
    return build_problem(K, cams, X, oc, op, uv, cam_jitter=1.0,
                         pt_jitter=0.05)


def _inputs(with_sfm):
    arrays = _np(_scene())
    inp = {"problems": [(arrays, CONVERGE), (arrays, TWO_STEPS)]}
    if with_sfm:
        matches_data, info, _ = make_sfm_scene(n_views=5, n_pts=500)
        inp["sfm"] = (matches_data, info)
    return inp


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: run_world(tmp_path_factory.mktemp(f"ba{n}"), n, "ba",
                         _inputs(with_sfm=n == 2))
            for n in (2, 4)}


@pytest.fixture(scope="module")
def reference():
    mesh = j_make_mesh(jax.devices(), shape=(8, 1))
    res = j_sharded(_scene(), mesh, JConfig(**CONVERGE))
    return {k: np.asarray(getattr(res, k)) for k in REPLICATED + ("points",)}


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_shard_ba_problem_matches_jax(n_shards):
    K, cams, X, oc, op, uv = make_ba_scene(n_cams=4, n_pts=123)
    jprob = build_problem(K, cams, X, oc, op, uv)
    ref, rpl, rms = j_shard(jprob, n_shards)
    got, pl, ms = shard_ba_problem(
        tb.BAProblem.from_numpy(**_np(jprob), device="cpu"), n_shards)
    assert (pl, ms) == (rpl, rms)
    assert got.points.shape[0] == pl * n_shards
    for k, v in got.to_numpy().items():
        r = np.asarray(getattr(ref, k))
        assert v.shape == r.shape, k
        np.testing.assert_array_equal(v, r.astype(v.dtype), err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ba_matches_jax(worlds, reference, world):
    outs = worlds[world]
    for o in outs[1:]:
        for k in REPLICATED + ("points",):
            np.testing.assert_array_equal(o["ba"][0][k], outs[0]["ba"][0][k])
    got = outs[0]["ba"][0]
    assert got["points"].shape == reference["points"].shape
    np.testing.assert_allclose(got["cam_params"], reference["cam_params"],
                               rtol=1e-2, atol=1e-2)
    assert abs(float(got["cost_final"]) - float(reference["cost_final"])) \
        < 1e-2 * float(reference["cost_final"]) + 1e-3
    assert abs(float(got["mean_reproj_px"])
               - float(reference["mean_reproj_px"])) < 1e-3
    assert float(got["mean_reproj_px"]) < 0.6
    assert float(got["cost_final"]) < float(got["cost_initial"]) * 0.1


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ba_matches_one_process_solve(worlds, world):
    one = tb.bundle_adjust(tb.BAProblem.from_numpy(**_np(_scene()),
                                                   device="cpu"),
                           tb.BAConfig(**TWO_STEPS))
    outs = worlds[world]
    for o in outs[1:]:
        for k in REPLICATED:
            np.testing.assert_array_equal(o["ba"][1][k], outs[0]["ba"][1][k])
    got = outs[0]["ba"][1]
    assert int(got["iterations"]) == int(one.iterations) == 2
    np.testing.assert_allclose(got["cam_params"], one.cam_params.numpy(),
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(got["points"], one.points.numpy(),
                               rtol=5e-3, atol=5e-3)
    mr = float(one.mean_reproj_px)
    assert abs(float(got["mean_reproj_px"]) - mr) < 5e-3 * max(1.0, mr)
    assert float(got["cost_final"]) < float(got["cost_initial"])


def test_pipeline_global_ba_shards_over_two_ranks(worlds):
    """The SfM pipeline inside a group of 2 ranks routes its global BA
    through sharded_bundle_adjust (tests/test_ba_sharded.py's production
    path), and both ranks end with the same reconstruction."""
    outs = [o["sfm"] for o in worlds[2]]
    for s in outs:
        ga = s["global_ba"]
        assert ga and ga[-1].get("sharded") == 2, ga
        assert ga[-1]["mean_reproj_px"] < 2.0
        assert len(s["cameras"]) == 5
    a, b = outs
    assert a["cameras"].keys() == b["cameras"].keys()
    for n in a["cameras"]:
        for x, y in zip(a["cameras"][n], b["cameras"][n]):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a["points"], b["points"])
    assert a["mean_reproj"] == b["mean_reproj"] and a["mean_reproj"] < 2.0
