"""Parity of the port's SfM geometry (tpu3drec_torch.ops.lie, geometry's
fundamental matrix, five_point, epipolar, triangulate, pnp and
sfm.refinement) with the JAX package, on the JAX tests' own scenes.

RANSAC draws are replayed: the reference's uniforms
(`jax.random.randint(key, (K, s), 0, 2**31 - 1)`) and, above 512
correspondences, its Gumbel subsample indices are fed to the port.
Tolerances (float32 in another operation order):
- lie: 1e-6 relative (of each output's largest entry);
- E / F: up to sign, 1e-4 of the largest entry, given the reference's
  samples; inlier masks equal;
- 5-point: eigenvector bases of the nearly degenerate 4-dim null space
  differ between LAPACK builds (the span agrees to 1e-3), so the solver is
  compared given the reference's basis: every reference root whose
  self-check residual is under half the 1e-4 gate has a port root within
  1e-3 up to sign;
- recover_pose: R and t at 1e-5;
- triangulated points at 1e-4 relative, masks equal on >= 99.5%;
- PnP: R and t at 1e-4, inliers equal, given the reference's samples;
- refinement (free runs, each package's own draws): K within 2%, R within
  0.2 deg.
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

from test_epipolar import make_two_view                       # noqa: E402
from test_five_point import e_dist, make_minimal              # noqa: E402
from test_pnp import make_pnp_scene, rot_err_deg              # noqa: E402
from test_triangulate import _two_view_geom, make_scene       # noqa: E402

from tpu3drec.ops import epipolar as je                       # noqa: E402
from tpu3drec.ops import five_point as jf                     # noqa: E402
from tpu3drec.ops import geometry as jg                       # noqa: E402
from tpu3drec.ops import lie as jl                            # noqa: E402
from tpu3drec.ops import pnp as jp                            # noqa: E402
from tpu3drec.ops import ransac as jr                         # noqa: E402
from tpu3drec.ops import triangulate as jt                    # noqa: E402
from tpu3drec.sfm import refinement as jref                   # noqa: E402
from tpu3drec_torch.ops import epipolar as te                 # noqa: E402
from tpu3drec_torch.ops import five_point as tf               # noqa: E402
from tpu3drec_torch.ops import geometry as tg                 # noqa: E402
from tpu3drec_torch.ops import lie as tl                      # noqa: E402
from tpu3drec_torch.ops import pnp as tp                      # noqa: E402
from tpu3drec_torch.ops import ransac as tr                   # noqa: E402
from tpu3drec_torch.ops import triangulate as tt              # noqa: E402
from tpu3drec_torch.sfm import refinement as tref             # noqa: E402

INT_MAX = 2 ** 31 - 1
LIE_RTOL = 1e-6
E_TOL = 1e-4
ROOT_TOL = 1e-3
POSE_TOL = 1e-5
POINT_RTOL = 1e-4
PNP_TOL = 1e-4


def T(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def J(a):
    return jnp.asarray(np.asarray(a, np.float32))


def close_rel(got, ref, rtol):
    """|got - ref| <= rtol * max|ref| (each output's own scale)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref).max() / scale
    assert err <= rtol, f"relative error {err:.3e} > {rtol}"


def close_up_to_sign(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    err = min(np.abs(got - ref).max(), np.abs(got + ref).max()) / scale
    assert err <= tol, f"up-to-sign error {err:.3e} > {tol}"


def jax_uniforms(key, K, s):
    return np.asarray(jax.random.randint(key, (K, s), 0, INT_MAX,
                                         dtype=jnp.int32))


def essential_draws(key, n, K, s, mask):
    """What `find_essential` draws from `key`: the Gumbel subsample (above
    SAMPLE_CAP) and the RANSAC uniforms."""
    sub = None
    if n > te.SAMPLE_CAP:
        kg, key = jax.random.split(key)
        g = jax.random.gumbel(kg, (n,), jnp.float32) \
            + jnp.log(jnp.asarray(mask).astype(jnp.float32) + 1e-30)
        sub = np.asarray(jax.lax.top_k(g, te.SAMPLE_CAP)[1])
    return sub, jax_uniforms(key, K, s)


# ---------------------------------------------------------------- lie

def _rvecs():
    rng = np.random.default_rng(0)
    rv = rng.normal(size=(16, 3)) * 0.8
    rv[0] = 0.0
    rv[1] = [3e-5, -2e-5, 1e-5]          # theta^2 < 1e-8: the Taylor branch
    return rv.astype(np.float32)


@pytest.mark.parametrize("name", ["hat", "exp_so3", "log_so3",
                                  "project_points", "transform_points",
                                  "camera_center", "compose_projection"])
def test_lie_matches_jax(name):
    rv = _rvecs()
    R = np.asarray(jl.exp_so3(J(rv)))
    rng = np.random.default_rng(1)
    X = (rng.uniform(-2, 2, (50, 3)) + [0, 0, 6]).astype(np.float32)
    t = np.array([0.3, 0.1, 0.5], np.float32)
    K = np.array([[600, 0, 320], [0, 610, 240], [0, 0, 1]], np.float32)
    args = {"hat": (rv,), "exp_so3": (rv,), "log_so3": (R,),
            "project_points": (X, rv[5], t, K),
            "transform_points": (X, R[5], t), "camera_center": (R[5], t),
            "compose_projection": (K, R[5], t)}[name]
    ref = np.asarray(getattr(jl, name)(*(J(a) for a in args)))
    got = getattr(tl, name)(*(T(a) for a in args)).numpy()
    assert got.shape == ref.shape
    close_rel(got, ref, LIE_RTOL)


@pytest.mark.parametrize("theta", [2e-5, 0.7])
def test_exp_so3_jacobian_matches_jax(theta):
    """Forward-mode derivative through the Taylor select equals JAX's."""
    rv = (np.array([0.6, -0.64, 0.48]) * theta).astype(np.float32)
    ref = np.asarray(jax.jacfwd(jl.exp_so3)(J(rv)))
    got = torch.func.jacfwd(tl.exp_so3)(T(rv)).numpy()
    close_rel(got, ref, LIE_RTOL)


def test_numpy_twins_match_jax():
    rv = np.concatenate([_rvecs(), [[np.pi - 1e-8, 0, 0], [0, 1e-9, 0]]])
    np.testing.assert_array_equal(tl.exp_so3_np(rv), jl.exp_so3_np(rv))
    R = jl.exp_so3_np(rv)
    np.testing.assert_array_equal(tl.log_so3_np(R), jl.log_so3_np(R))


# ------------------------------------------------------- fundamental

@pytest.fixture(scope="module")
def two_view():
    p1, p2, K, R, t, gt = make_two_view()
    return p1, p2, K, R, t, gt


def test_fundamental_solver_and_sampson_match_jax(two_view):
    p1, p2, *_ = two_view
    w = (np.arange(len(p1)) % 3 != 0).astype(np.float32)
    for fast in (False, True):
        Fj, okj = jg.solve_fundamental_8pt(J(p1), J(p2), J(w), fast=fast)
        Ft, okt = tg.solve_fundamental_8pt(T(p1), T(p2), T(w), fast=fast)
        assert bool(okj) and bool(okt)
        close_up_to_sign(Ft.numpy(), np.asarray(Fj), E_TOL)
    close_rel(tg.sampson_error(T(np.asarray(Fj)), T(p1), T(p2)).numpy(),
              np.asarray(jg.sampson_error(J(np.asarray(Fj)), J(p1), J(p2))), 1e-5)


def test_homography_4pt_closed_matches_jax():
    rng = np.random.default_rng(3)
    p1 = rng.uniform(0, 320, (6, 4, 2)).astype(np.float32)
    p2 = (p1 + rng.normal(0, 8, p1.shape)).astype(np.float32)
    Hj, okj = jax.vmap(jg._homography_4pt_closed)(J(p1), J(p2))
    Ht, okt = tg._homography_4pt_closed(T(p1), T(p2))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    for a, b in zip(Ht.numpy(), np.asarray(Hj)):
        close_rel(a, b, E_TOL)
    # the flat form is the same math
    hv, _ = tg._homography_4pt_flat(T(p1), T(p2))
    for a, b in zip(hv.numpy().reshape(-1, 3, 3), Ht.numpy()):
        close_rel(a, b, E_TOL)


def test_find_fundamental_with_injected_draws_matches_jax(two_view):
    p1, p2, *_ = two_view
    key = jax.random.PRNGKey(4)
    ref = jg.find_fundamental(J(p1), J(p2), threshold=3.0,
                              num_hypotheses=256, key=key)
    got = tg.find_fundamental(T(p1), T(p2), threshold=3.0, num_hypotheses=256,
                              u=T(jax_uniforms(key, 256, 8), torch.int32))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    close_up_to_sign(got.model.numpy(), np.asarray(ref.model), E_TOL)


def test_num_hypotheses_for_matches_jax():
    for conf, w, s in [(0.999, 0.5, 8), (0.99, 0.3, 5), (0.999, 0.0, 12),
                       (0.5, 0.99, 4)]:
        assert tr.num_hypotheses_for(conf, w, s) == jr.num_hypotheses_for(conf, w, s)


# ---------------------------------------------------------- 5-point

def _minimal(seed):
    p1, p2, E = make_minimal(seed)
    ones = np.ones((5, 1), np.float32)
    return p1, p2, E, np.concatenate([p1, ones], 1), np.concatenate([p2, ones], 1)


def test_five_point_null_space_matches_jax():
    for seed in range(12):
        _, _, _, x1, x2 = _minimal(seed)
        Q = jnp.einsum("ni,nj->nij", J(x2), J(x1)).reshape(-1, 9)
        bj = np.asarray(jnp.linalg.eigh(Q.T @ Q)[1])[:, :4]
        bt = tf.null_basis(T(x1), T(x2)).numpy()
        np.testing.assert_allclose(bt @ bt.T, bj @ bj.T, atol=1e-3)


@jax.jit
@jax.vmap
def _jax_5pt_with_basis(p1, p2):
    """The reference solver and, computed the same way beside it, the
    null-space basis it used."""
    ones = jnp.ones((5, 1), p1.dtype)
    x1 = jnp.concatenate([p1, ones], 1)
    x2 = jnp.concatenate([p2, ones], 1)
    Q = jnp.einsum("ni,nj->nij", x2, x1).reshape(-1, 9)
    return (*jf.solve_essential_5pt(p1, p2),
            jnp.linalg.eigh(Q.T @ Q)[1][:, :4])


def test_five_point_roots_match_jax_given_its_basis():
    samples = [_minimal(seed) for seed in range(12)]
    Ej, vj, bj = (np.asarray(a) for a in _jax_5pt_with_basis(
        J(np.stack([s[0] for s in samples])),
        J(np.stack([s[1] for s in samples]))))
    dists, accepted = [], 0
    for seed, (_, _, _, x1, x2) in enumerate(samples):
        Es, valid, basis = Ej[seed], vj[seed], bj[seed]
        Et, vt = tf.essentials_from_basis(T(basis), T(x1), T(x2))
        Et, vt = Et.numpy(), vt.numpy()
        resid = np.abs(np.einsum("ni,rij,nj->rn", x2, Es, x1)).max(1)
        for i in np.flatnonzero(valid & (resid < 5e-5)):
            d = [e_dist(Es[i], Et[k]) for k in range(tf.N_ROOTS)]
            k = int(np.argmin(d))
            dists.append(d[k])
            accepted += bool(vt[k])
    dists = np.array(dists)
    # the float32 expansion (an inverse Vandermonde of condition ~1e4) in
    # another summation order moves an ill-conditioned root by a few 1e-3,
    # and a root pair inside one grid cell (the solver's accepted
    # per-sample miss, absorbed by RANSAC) may bracket on one side only:
    # nine in ten roots within ROOT_TOL, 95% within 5x
    assert len(dists) >= 30, len(dists)
    assert (dists < ROOT_TOL).mean() >= 0.9, np.sort(dists)[-5:]
    assert (dists < 5 * ROOT_TOL).mean() >= 0.95, np.sort(dists)[-5:]
    assert accepted >= 0.9 * len(dists), (len(dists), accepted)


def test_five_point_recovers_ground_truth():
    """The reference test's contract on the port's own solver (its own
    null-space basis): >= 9 of 12 minimal samples recover E."""
    hits = 0
    for seed in range(12):
        p1, p2, E, _, _ = _minimal(seed)
        Es, valid = tf.solve_essential_5pt(T(p1), T(p2))
        d = [e_dist(Es[i].numpy(), E) for i in range(10) if valid[i]]
        hits += bool(d and min(d) < 5e-3)
    assert hits >= 9, hits


@pytest.fixture(scope="module")
def five_point_ransac_scene():
    rng = np.random.default_rng(3)
    R = jl.exp_so3_np(np.array([0.05, 0.25, -0.02]))
    t = np.array([1.0, -0.1, 0.2])
    t /= np.linalg.norm(t)
    n, n_out = 200, 50
    X = rng.uniform(-2, 2, (n, 3)) + [0, 0, 7.0]
    x1 = (X / X[:, 2:3])[:, :2]
    Xc2 = X @ R.T + t
    x2 = (Xc2 / Xc2[:, 2:3])[:, :2]
    x1 += 0.5 / 700.0 * rng.standard_normal(x1.shape)
    x2 += 0.5 / 700.0 * rng.standard_normal(x2.shape)
    out = rng.permutation(n)[:n_out]
    x2[out] += rng.uniform(0.05, 0.2, (n_out, 2)) \
        * np.sign(rng.standard_normal((n_out, 2)))
    return x1.astype(np.float32), x2.astype(np.float32)


def test_five_point_inside_ransac_matches_jax(five_point_ransac_scene):
    """The solver inside the RANSAC engine (models_per_sample=10), the
    reference's samples: the same inliers within max(2, 1%)."""
    x1, x2 = five_point_ransac_scene
    key = jax.random.PRNGKey(0)
    n = len(x1)
    ref = jr.ransac(J(x1), J(x2), jnp.ones(n, bool), key,
                    solver=jf.solve_essential_5pt,
                    residual_fn=jg.sampson_error, sample_size=5,
                    num_hypotheses=128, models_per_sample=10,
                    threshold=2.0 / 700.0)
    got = tr.ransac(T(x1)[None], T(x2)[None], torch.ones(1, n, dtype=torch.bool),
                    solver=tf.solve_essential_5pt,
                    residual_fn=tg._sampson_residuals, sample_size=5,
                    num_hypotheses=128, models_per_sample=10,
                    threshold=2.0 / 700.0,
                    u=T(jax_uniforms(key, 128, 5), torch.int32))
    assert bool(got.success[0]) and bool(ref.success)
    ni = int(ref.num_inliers)
    assert abs(int(got.num_inliers[0]) - ni) <= max(2, 0.01 * ni)
    assert (got.inliers[0].numpy() == np.asarray(ref.inliers)).mean() >= 0.99


# ------------------------------------------------- essential and pose

@pytest.fixture(scope="module")
def essential_refs(two_view):
    """The reference's find_essential on the test_epipolar scene (300
    points, no subsample) for both methods, and on a 600-point scene (the
    Gumbel subsample), with the draws each used."""
    p1, p2, K, *_ = two_view
    out = {}
    for method, s, K_h in (("8point", 8, 1024), ("5point", 5, 102)):
        key = jax.random.PRNGKey(2)
        out[method] = (je.find_essential(J(p1), J(p2), J(K), method=method,
                                         key=key),
                       essential_draws(key, len(p1), K_h, s, np.ones(len(p1))))
    q1, q2, qK, *_ = make_two_view(n=600, n_out=120, seed=7)
    mask = np.random.default_rng(8).random(600) > 0.1
    key = jax.random.PRNGKey(5)
    out["subsample"] = (je.find_essential(J(q1), J(q2), J(qK), mask=jnp.asarray(mask),
                                          num_hypotheses=256, key=key),
                        essential_draws(key, 600, 256, 8, mask),
                        (q1, q2, qK, mask))
    return out


@pytest.mark.parametrize("method", ["8point", "5point"])
def test_find_essential_with_injected_draws_matches_jax(two_view, essential_refs,
                                                        method):
    p1, p2, K, *_ = two_view
    ref, (_, u) = essential_refs[method]
    got = te.find_essential(T(p1), T(p2), T(K), method=method,
                            u=T(u, torch.int32))
    assert bool(got.success) and bool(ref.success)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    close_up_to_sign(got.E.numpy(), np.asarray(ref.E), E_TOL)


def test_find_essential_subsample_replay_matches_jax(essential_refs):
    ref, (sub, u), (p1, p2, K, mask) = essential_refs["subsample"]
    got = te.find_essential(T(p1), T(p2), T(K), mask=torch.tensor(mask),
                            num_hypotheses=256, sub=T(sub, torch.int64),
                            u=T(u, torch.int32))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    close_up_to_sign(got.E.numpy(), np.asarray(ref.E), E_TOL)
    assert int(got.num_inliers) == int(ref.num_inliers)


def test_find_essential_batch_equals_single_calls(two_view, essential_refs):
    """A batch of pairs (the pipeline's chunks) gives each pair's single
    result; per-pair intrinsics broadcast."""
    p1, p2, K, *_ = two_view
    _, (_, u) = essential_refs["8point"]
    ut = T(u, torch.int32)
    K2 = K.copy()
    K2[0, 0] *= 1.01
    one = [te.find_essential(T(p1), T(p2), T(k), u=ut) for k in (K, K2)]
    both = te.find_essential(T(np.stack([p1, p1])), T(np.stack([p2, p2])),
                             T(np.stack([K, K2])), u=ut)
    for i in range(2):
        torch.testing.assert_close(both.E[i], one[i].E, rtol=0, atol=1e-5)
        assert torch.equal(both.inliers[i], one[i].inliers)


def test_recover_pose_matches_jax(two_view, essential_refs):
    p1, p2, K, *_ = two_view
    ref_e, _ = essential_refs["8point"]
    Rj, tj, fj = je.recover_pose(ref_e.E, J(p1), J(p2), J(K), mask=ref_e.inliers)
    Rt, tt_, ft = te.recover_pose(T(np.asarray(ref_e.E)), T(p1), T(p2), T(K),
                                  mask=torch.tensor(np.asarray(ref_e.inliers)))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=POSE_TOL)
    np.testing.assert_allclose(tt_.numpy(), np.asarray(tj), atol=POSE_TOL)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


def test_essential_helpers_match_jax(essential_refs):
    E = np.asarray(essential_refs["8point"][0].E)
    qj = je.essential_quality(J(E))
    qt = te.essential_quality(T(E))
    close_rel(qt["singular_values"].numpy(), np.asarray(qj["singular_values"]), 1e-5)
    assert bool(qt["is_valid"]) == bool(qj["is_valid"])
    R1j, R2j, tj = je.decompose_essential(J(E))
    R1t, R2t, tt_ = te.decompose_essential(T(E))
    # SVD signs differ between LAPACK builds; the candidate set does not
    cands_j = [np.asarray(R1j), np.asarray(R2j)]
    for Rt in (R1t.numpy(), R2t.numpy()):
        assert min(np.abs(Rt - Rj).max() for Rj in cands_j) < POSE_TOL
        np.testing.assert_allclose(Rt @ Rt.T, np.eye(3), atol=1e-5)
    close_up_to_sign(tt_.numpy(), np.asarray(tj), POSE_TOL)
    R = jl.exp_so3_np(np.array([0.0, 0.3, 0.0])).astype(np.float32)
    assert abs(float(te.rotation_angle_deg(T(R)))
               - float(je.rotation_angle_deg(J(R)))) < 1e-4
    pts = np.random.default_rng(0).uniform(0, 600, (10, 2)).astype(np.float32)
    K = np.array([[700, 0, 320], [0, 690, 240], [0, 0, 1]], np.float32)
    close_rel(te.denormalize_with_K(te.normalize_with_K(T(pts), T(K)), T(K)).numpy(),
              pts, 1e-6)


# ------------------------------------------------------ triangulation

@pytest.fixture(scope="module")
def tri_args():
    """test_two_view_filters' scene: (p1, p2, K1, K2, R1, t1, R2, t2), ten
    correspondences corrupted by 50 px."""
    _, p1, p2, K, R1, t1, R2, t2 = make_scene(noise=0.3)
    p2 = p2.copy()
    p2[:10] += 50.0
    return p1, p2, K, K, R1, t1, R2, t2


@pytest.mark.parametrize("correction", ["hartley_sturm", "sampson", "none"])
def test_triangulate_two_view_matches_jax(tri_args, correction):
    args = tri_args
    cfg = jt.TriangulationConfig(correction=correction)
    ref = jt.triangulate_two_view(*(J(a) for a in args), config=cfg)
    got = tt.triangulate_two_view(*(T(a) for a in args),
                                  config=tt.TriangulationConfig(correction=correction))
    keep = np.asarray(ref.mask)
    assert (got.mask.numpy() == keep).mean() >= 0.995 and keep.sum() > 80
    # the points the filter keeps at POINT_RTOL; the ten corrupted
    # (ill-conditioned, rejected) ones at 10x
    for name in ("points", "reproj_err", "angles_deg", "depths1", "depths2"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        close_rel(a[keep], b[keep], POINT_RTOL)
        close_rel(a, b, 10 * POINT_RTOL)


def test_triangulate_two_view_depth_bounds_and_batch(tri_args):
    args = tri_args
    bounds = (2.0, 9.0)
    ref = jt.triangulate_two_view(*(J(a) for a in args),
                                  depth_bounds=(jnp.float32(2.0), jnp.float32(9.0)))
    got = tt.triangulate_two_view(*(T(a) for a in args), depth_bounds=bounds)
    assert (got.mask.numpy() == np.asarray(ref.mask)).mean() >= 0.995
    assert 0 < int(got.mask.sum()) < len(got.mask)
    both = tt.triangulate_two_view(*(T(np.stack([a, a])) for a in args))
    one = tt.triangulate_two_view(*(T(a) for a in args))
    assert (both.mask[1] == one.mask).float().mean() >= 0.995
    close_rel(both.points[1].numpy(), one.points.numpy(), POINT_RTOL)


def test_point_solvers_match_jax():
    # test_gn_refinement_reduces_error's scene
    X, p1, p2, K, R1, t1, R2, t2 = make_scene(noise=1.0)
    P1 = np.asarray(jl.compose_projection(J(K), J(R1), J(t1)))
    P2 = np.asarray(jl.compose_projection(J(K), J(R2), J(t2)))
    ref = np.asarray(jt.triangulate_points(J(p1), J(p2), J(P1), J(P2)))
    got = tt.triangulate_points(T(p1), T(p2), T(P1), T(P2)).numpy()
    close_rel(got, ref, POINT_RTOL)
    Xp = ref + 0.05
    close_rel(tt.refine_points_gn(T(Xp), T(p1), T(p2), T(P1), T(P2), iters=5).numpy(),
              np.asarray(jt.refine_points_gn(J(Xp), J(p1), J(p2), J(P1), J(P2),
                                             iters=5)), POINT_RTOL)
    Ps = np.stack([P1, P2, P1 + 0.01])
    pts = np.stack([p1, p2, p1], 1)
    vm = np.ones((len(p1), 3), bool)
    vm[::2, 2] = False
    refm = np.asarray(jax.vmap(jt.triangulate_multiview, in_axes=(0, None, 0))(
        J(pts), J(Ps), jnp.asarray(vm)))
    close_rel(tt.triangulate_multiview(T(pts), T(Ps), torch.tensor(vm)).numpy(),
              refm, POINT_RTOL)
    c1, c2 = np.zeros(3, np.float32), -R2.T @ t2
    close_rel(tt.triangulation_angles(T(ref), T(c1), T(c2)).numpy(),
              np.asarray(jt.triangulation_angles(J(ref), J(c1), J(c2))), 1e-4)


def test_epipolar_corrections_match_jax():
    _, _, _, F, _, n1, n2 = _two_view_geom()
    args = (n1.astype(np.float32), n2.astype(np.float32), F.astype(np.float32))
    for jfn, tfn in ((jt.hartley_sturm_correct, tt.hartley_sturm_correct),
                     (jt.sampson_correct, tt.sampson_correct)):
        ref = jfn(*(J(a) for a in args))
        got = tfn(*(T(a) for a in args))
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)


# ---------------------------------------------------------------- PnP

@pytest.fixture(scope="module")
def pnp_refs():
    X, uv, K, R, t, gt = make_pnp_scene()
    key = jax.random.PRNGKey(0)
    return (X, uv, K, R, gt,
            jp.solve_pnp_ransac(J(X), J(uv), J(K), key=key),
            jax_uniforms(key, 512, 12))


def test_pnp_ransac_with_injected_draws_matches_jax(pnp_refs):
    X, uv, K, R_gt, gt, ref, u = pnp_refs
    got = tp.solve_pnp_ransac(T(X), T(uv), T(K), u=T(u, torch.int32))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=PNP_TOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=PNP_TOL)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    # [success, num, ratio, mean_px, R (9), t (3), inliers (N)]
    assert got.packed.shape == ref.packed.shape == (16 + len(X),)
    np.testing.assert_allclose(got.packed.numpy(), np.asarray(ref.packed),
                               atol=PNP_TOL)
    assert rot_err_deg(got.R.numpy().astype(np.float64), R_gt) < 0.3


def test_pnp_dlt_and_refinement_match_jax(pnp_refs):
    X, uv, K, *_ = pnp_refs
    xn = np.asarray(je.normalize_with_K(J(uv), J(K)))
    w = (np.arange(len(X)) % 4 != 0).astype(np.float32)
    Rj, tj, okj = jp.solve_pnp_dlt(J(X), J(xn), J(w))
    Rt, tt_, okt = tp.solve_pnp_dlt(T(X), T(xn), T(w))
    assert bool(okj) == bool(okt)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=PNP_TOL)
    close_rel(tt_.numpy(), np.asarray(tj), PNP_TOL)
    R0 = jl.exp_so3_np(np.array([0.13, -0.27, 0.08])).astype(np.float32)
    t0 = np.array([0.5, -0.1, 0.7], np.float32)
    mask = np.arange(len(X)) % 5 != 0
    Rj, tj = jp.refine_pnp_gn(J(R0), J(t0), J(X), J(uv), J(K),
                              mask=jnp.asarray(mask))
    Rt, tt_ = tp.refine_pnp_gn(T(R0), T(t0), T(X), T(uv), T(K),
                               mask=torch.tensor(mask))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=PNP_TOL)
    np.testing.assert_allclose(tt_.numpy(), np.asarray(tj), atol=PNP_TOL)


def test_pnp_ransac_batch_and_mask(pnp_refs):
    X, uv, K, R_gt, gt, _, u = pnp_refs
    mask = np.zeros(len(X), bool)
    mask[np.flatnonzero(gt)[:40]] = True
    uv2 = uv.copy()
    uv2[~mask] = 1e5
    ut = T(u, torch.int32)
    res = tp.solve_pnp_ransac(T(np.stack([X, X])), T(np.stack([uv, uv2])), T(K),
                              mask=torch.tensor(np.stack([np.ones_like(mask), mask])),
                              u=ut)
    one = tp.solve_pnp_ransac(T(X), T(uv), T(K), u=ut)
    torch.testing.assert_close(res.R[0], one.R, rtol=0, atol=1e-5)
    assert bool(res.success[1])
    assert not res.inliers[1][torch.tensor(~mask)].any()
    assert rot_err_deg(res.R[1].numpy().astype(np.float64), R_gt) < 0.5


# -------------------------------------------------------- refinement

def _refinement_pair():
    rng = np.random.default_rng(0)
    W, H = 640, 480
    K_gt = np.array([[800.0, 0, W / 2], [0, 800.0, H / 2], [0, 0, 1]])
    R = jl.exp_so3_np(np.array([0.04, 0.3, 0.0]))
    t = np.array([-1.0, 0.1, 0.15])
    X = rng.uniform(-3, 3, (300, 3)) + [0, 0, 9.0]

    def proj(Rm, tm):
        x = (K_gt @ (Rm @ X.T + tm[:, None])).T
        return (x[:, :2] / x[:, 2:3]).astype(np.float32)
    p1 = proj(np.eye(3), np.zeros(3)) + 0.3 * rng.standard_normal((300, 2)).astype(np.float32)
    p2 = proj(R, t) + 0.3 * rng.standard_normal((300, 2)).astype(np.float32)
    inb = ((p1 > 0) & (p1 < [W, H])).all(1) & ((p2 > 0) & (p2 < [W, H])).all(1)
    K0 = np.array([[1.2 * W, 0, W / 2], [0, 1.2 * W, H / 2], [0, 0, 1]])
    return p1[inb], p2[inb], K0, (W, H), R


def test_iterative_refinement_matches_jax():
    p1, p2, K0, size, R_gt = _refinement_pair()
    ref = jref.iterative_refinement(p1, p2, K0, K0, size, size,
                                    jref.RefinementConfig(max_iters=4))
    got = tref.iterative_refinement(p1, p2, K0, K0, size, size,
                                    tref.RefinementConfig(max_iters=4),
                                    device="cpu")
    assert ref is not None and got is not None
    for a, b in ((got.K1, ref.K1), (got.K2, ref.K2)):
        np.testing.assert_allclose(a, b, rtol=0.02)
    assert rot_err_deg(got.R, ref.R) < 0.2
    assert got.history[-1]["mean_reproj_px"] < 1.0
    assert rot_err_deg(got.R, R_gt) < 3.0
    assert got.point_mask.sum() > 100


def test_clamp_K_matches_jax():
    K = np.array([[9000.0, 0, 900], [0, 50.0, 10], [0, 0, 1]])
    np.testing.assert_array_equal(
        tref._clamp_K(K, (640, 480), tref.RefinementConfig()),
        jref._clamp_K(K, (640, 480), jref.RefinementConfig()))


def test_iterative_refinement_device_none_means_cuda():
    """device=None means CUDA: without a card it raises, it does not fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p1, p2, K0, size, _ = _refinement_pair()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tref.iterative_refinement(p1, p2, K0, K0, size, size)
