"""Parity of tpu3drec_torch.ops.ba (Schur-complement LM, dense and CG)
with the JAX package's bundle adjustment, on the JAX tests' scenes
(`tests/test_ba.py`: 4 cameras / 120 points), the multichip dryrun's BA
problem (`__graft_entry__.py:_dryrun_ba_phase`: 6 cameras / 400 points /
1,600 observations, CG) and a 3-camera dense-Schur window, the last two
as `chip_smoke.py` builds them for its card-vs-CPU comparison.

Both packages solve the same problem (`BAProblem.from_numpy` of the
reference's arrays). Tolerances: cameras 5e-3, mean reprojection 1e-2 px,
iterations equal +-1 (the damping schedule equal: the final lambda at
1e-3 relative). The LM runs end before the float32 noise floor of the
cost: there, accepting a step or not is decided by the last bit of a sum
that the two packages add in another order.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_ba import build_problem, make_ba_scene              # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke                                             # noqa: E402
from tpu3drec.ops import ba as jb                             # noqa: E402
from tpu3drec_torch.ops import ba as tb                       # noqa: E402

CAM_TOL = 5e-3
REPROJ_TOL = 1e-2
LAMBDA_RTOL = 1e-3


def port(jprob):
    return tb.BAProblem.from_numpy(
        **{k: np.asarray(v) for k, v in jprob._asdict().items()}, device="cpu")


def check(got, ref):
    np.testing.assert_allclose(got.cam_params.numpy(),
                               np.asarray(ref.cam_params), atol=CAM_TOL)
    assert abs(float(got.mean_reproj_px) - float(ref.mean_reproj_px)) < REPROJ_TOL
    assert abs(int(got.iterations) - int(ref.iterations)) <= 1
    assert float(got.cost_final) < float(got.cost_initial)


@pytest.fixture(scope="module")
def scene():
    K, cams, X, oc, op, uv = make_ba_scene(noise_px=0.3)
    return build_problem(K, cams, X, oc, op, uv, cam_jitter=1.0, pt_jitter=0.05)


@pytest.fixture(scope="module")
def jax_ba(scene):
    """The reference's 10-iteration solve of `scene` by Schur solver,
    computed once a solver."""
    cache = {}

    def get(solver):
        if solver not in cache:
            cache[solver] = jb.bundle_adjust(
                scene, jb.BAConfig(max_iters=10, schur_solver=solver))
        return cache[solver]
    return get


def small_problem(C):
    """`chip_smoke.small_ba_problem`: with 6 cameras the multichip dryrun's
    BA problem, with 3 the incremental dense-Schur window."""
    arrays = chip_smoke.small_ba_problem(C, 11)
    m, P = len(arrays["obs_pt"]), len(arrays["points"])
    return jb.BAProblem(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        obs_mask=jnp.ones(m, bool), point_mask=jnp.ones(P, bool))


def test_cam_param_packing_matches_jax():
    K = np.array([[600, 0, 320], [0, 610, 240], [0, 0, 1]], np.float32)
    rv, tv = np.array([0.1, -0.2, 0.05]), np.array([0.3, 0.1, 0.5])
    p = tb.make_cam_params(rv, tv, K)
    np.testing.assert_array_equal(p, np.asarray(jb.make_cam_params(rv, tv, K)))
    got = tb.unpack_cam_params(torch.tensor(np.stack([p, p])))
    ref = jb.unpack_cam_params(jnp.asarray(np.stack([p, p])))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_problem_round_trip(scene):
    tp = port(scene)
    back = tp.to_numpy()
    assert list(back) == list(jb.BAProblem._fields)
    for k, v in scene._asdict().items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    assert tp.obs_cam.dtype == torch.int64 and tp.obs_mask.dtype == torch.bool


def test_residuals_and_jacobians_match_jax(scene):
    """Residuals, their mean, and the forward-mode Jacobians, including a
    camera at rvec = 0 (exp_so3's Taylor branch) and an observation behind
    its camera (the 100 px sentinel, zero Jacobian)."""
    prob = scene._replace(cam_params=scene.cam_params.at[2, :3].set(0.0))
    prob = prob._replace(points=prob.points.at[5].set(
        jnp.array([0.0, 0.0, -20.0])))
    tp = port(prob)
    np.testing.assert_allclose(tb.residuals(tp).numpy(),
                               np.asarray(jb.residuals(prob)), atol=1e-3)
    assert abs(float(tb.mean_reproj_error(tp))
               - float(jb.mean_reproj_error(prob))) < 1e-4
    cam_o = np.asarray(prob.cam_params)[np.asarray(prob.obs_cam)]
    pt_o = np.asarray(prob.points)[np.asarray(prob.obs_pt)]
    uv = np.asarray(prob.obs_uv)
    Jc, Jp = jax.jit(jax.vmap(jax.jacfwd(jb._residual_one, argnums=(0, 1))))(
        jnp.asarray(cam_o), jnp.asarray(pt_o), jnp.asarray(uv))
    tc, tq = tb._jacobians(torch.tensor(cam_o), torch.tensor(pt_o),
                           torch.tensor(uv))
    behind = np.asarray(prob.obs_pt) == 5
    assert behind.any() and not np.abs(tc.numpy()[behind]).any()
    for a, b in ((tc, Jc), (tq, Jp)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_bundle_adjust_matches_jax(scene, jax_ba, solver):
    cfg = dict(max_iters=10, schur_solver=solver)
    ref = jax_ba(solver)
    got = tb.bundle_adjust(port(scene), tb.BAConfig(**cfg))
    check(got, ref)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points),
                               atol=CAM_TOL)
    np.testing.assert_allclose(got.stats.numpy()[4], np.asarray(ref.stats)[4],
                               rtol=LAMBDA_RTOL)
    assert got.stats.shape == (6,)
    assert got.packed.shape == ref.packed.shape
    np.testing.assert_allclose(got.packed.numpy()[-6:], np.asarray(ref.packed)[-6:],
                               rtol=1e-3)


def test_fixed_order_segment_sums_match_index_add():
    """The segment sums the card runs (`_segments` with a fixed order),
    here on the CPU: index_add_'s sums to float32 rounding, bit-equal run
    to run, with empty segments, one longer than a chunk, and no rows."""
    rng = np.random.default_rng(3)
    idx = np.concatenate([rng.integers(0, 9, 300),
                          np.full(tb.SEG_CHUNK * 2 + 37, 4)])
    idx = torch.as_tensor(rng.permutation(idx))
    n = 12                                   # 9, 10 and 11 stay empty
    for x in (torch.as_tensor(rng.normal(size=(len(idx), 10, 3)),
                              dtype=torch.float32),
              torch.as_tensor(rng.normal(size=(len(idx), 3)),
                              dtype=torch.float32)):
        want = tb._segsum(x, tb._segments(idx, n))
        seg = tb._segments(idx, n, fixed_order=True)
        got = tb._segsum(x, seg)
        assert seg.order is not None and int(seg.seg_chunks[4]) == 3
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(got, tb._segsum(x, seg))
        assert not got[9:].any()
    empty = torch.zeros(0, dtype=torch.long)
    none = tb._segsum(torch.zeros(0, 3),
                      tb._segments(empty, 5, fixed_order=True))
    assert none.shape == (5, 3) and not none.any()


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_bundle_adjust_in_fixed_order_matches_jax(scene, jax_ba, solver,
                                                  monkeypatch):
    """The solve with the card's fixed-order segment sums, run on the
    CPU, meets the reference's bars and repeats bit for bit."""
    segments = tb._segments
    monkeypatch.setattr(tb, "_segments", lambda idx, n: segments(
        idx, n, fixed_order=True))
    cfg = tb.BAConfig(max_iters=10, schur_solver=solver)
    got = tb.bundle_adjust(port(scene), cfg)
    ref = jax_ba(solver)
    check(got, ref)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points),
                               atol=CAM_TOL)
    assert torch.equal(got.packed, tb.bundle_adjust(port(scene), cfg).packed)


@pytest.mark.parametrize("C, cfg", [
    (6, dict(max_iters=3, schur_solver="cg", cg_iters=24, ftol=0.0)),
    (6, dict(max_iters=3, schur_solver="dense", ftol=0.0)),
    (3, dict(max_iters=6, schur_solver="dense"))])
def test_bundle_adjust_small_problems_match_jax(C, cfg):
    jprob = small_problem(C)
    ref = jb.bundle_adjust(jprob, jb.BAConfig(**cfg))
    got = tb.bundle_adjust(port(jprob), tb.BAConfig(**cfg))
    check(got, ref)
    assert int(got.iterations) == cfg["max_iters"]


def test_masks_and_fixed_intrinsics_match_jax():
    """Intrinsics free, one camera's focal frozen by param_mask, a frozen
    point (point_mask) and padded observations gated by obs_mask."""
    K, cams, X, oc, op, uv = make_ba_scene(noise_px=0.2)
    prob = build_problem(K, cams, X, oc, op, uv, cam_jitter=0.5,
                         pt_jitter=0.02, optimize_intrinsics=True)
    pad = 30
    prob = prob._replace(
        param_mask=prob.param_mask.at[2, 6:8].set(0.0),
        point_mask=prob.point_mask.at[7].set(False),
        obs_cam=jnp.concatenate([prob.obs_cam, jnp.zeros(pad, jnp.int32)]),
        obs_pt=jnp.concatenate([prob.obs_pt, jnp.zeros(pad, jnp.int32)]),
        obs_uv=jnp.concatenate([prob.obs_uv, jnp.full((pad, 2), 1e5, jnp.float32)]),
        obs_mask=jnp.concatenate([prob.obs_mask, jnp.zeros(pad, bool)]))
    for kw in ({}, {"optimize_intrinsics": False}):
        cfg = dict(max_iters=8, **kw)
        ref = jb.bundle_adjust(prob, jb.BAConfig(**cfg))
        got = tb.bundle_adjust(port(prob), tb.BAConfig(**cfg))
        check(got, ref)
        np.testing.assert_array_equal(got.points.numpy()[7],
                                      np.asarray(prob.points)[7])
        np.testing.assert_array_equal(got.cam_params.numpy()[2, 6:8],
                                      np.asarray(prob.cam_params)[2, 6:8])


def test_skip_gate_matches_jax():
    K, cams, X, oc, op, uv = make_ba_scene(noise_px=0.1)
    clean = build_problem(K, cams, X, oc, op, uv)
    for prob, thr in ((clean, None), (clean, 0.01),
                      (build_problem(K, cams, X, oc, op, uv, cam_jitter=1.0,
                                     pt_jitter=0.05), None)):
        cfg = dict(max_iters=6, skip_if_below_px=0.5)
        ref = jb.bundle_adjust(prob, jb.BAConfig(**cfg), skip_below_px=thr)
        got = tb.bundle_adjust(port(prob), tb.BAConfig(**cfg), skip_below_px=thr)
        assert int(got.iterations) == int(ref.iterations)
        if int(ref.iterations) == 0:
            np.testing.assert_array_equal(got.cam_params.numpy(),
                                          np.asarray(prob.cam_params))
        check_stats = np.asarray(ref.stats)
        np.testing.assert_allclose(got.stats.numpy()[5], check_stats[5], rtol=1e-4)
    assert int(got.iterations) > 0


def test_warm_start_lambda_matches_jax(scene):
    lam0 = 0.37
    cfg = dict(max_iters=8)
    ref = jb.bundle_adjust(scene, jb.BAConfig(**cfg), lambda0=jnp.float32(lam0))
    got = tb.bundle_adjust(port(scene), tb.BAConfig(**cfg), lambda0=lam0)
    check(got, ref)
    np.testing.assert_allclose(got.stats.numpy()[4], np.asarray(ref.stats)[4],
                               rtol=LAMBDA_RTOL)


def test_cg_matches_dense_and_sharded_path_raises(scene):
    tp = port(scene)
    dense = tb.bundle_adjust(tp, tb.BAConfig(max_iters=10, schur_solver="dense"))
    cg = tb.bundle_adjust(tp, tb.BAConfig(max_iters=10, schur_solver="cg"))
    np.testing.assert_allclose(cg.points.numpy(), dense.points.numpy(), atol=0.05)
    assert float(cg.cost_final) <= float(dense.cost_final) * 1.05
    with pytest.raises(NotImplementedError, match="Queue 1 #7"):
        tb.bundle_adjust(tp, axis_name="points")


def test_residual_of_a_diverged_point_stays_nan_like_jax():
    """A NaN point (a diverged LM step) has a NaN residual in both
    packages, so the step costs NaN and LM rejects it. torch.sign(nan) is
    0 where jnp.sign(nan) is nan: the behind-camera sentinel turned such a
    step into a zero cost, LM accepted it, and a 41-camera CG window of
    the 50-view SfM scene ended with NaN points."""
    cam = np.array([0.01, 0.02, 0.0, 0.1, 0.0, 0.0, 500, 500, 320, 240],
                   np.float32)
    uv = np.array([300.0, 200.0], np.float32)
    for X in ([np.nan, 0.0, 5.0], [0.0, 0.0, np.nan], [0.0, 0.0, -5.0],
              [0.1, 0.2, 5.0]):
        X = np.asarray(X, np.float32)
        ref = np.asarray(jb._residual_one(jnp.asarray(cam), jnp.asarray(X),
                                          jnp.asarray(uv)))
        got = tb._residual(torch.tensor(cam), torch.tensor(X),
                           torch.tensor(uv)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, equal_nan=True)
