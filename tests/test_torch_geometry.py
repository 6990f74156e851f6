"""Parity of tpu3drec_torch.ops.ransac / geometry with the reference.

RANSAC samples are replayed exactly: the reference's own uniforms
(`jax.random.randint(key, (K, 4), 0, 2**31 - 1)`, what
`sample_minimal_sets` draws) are fed to the port's `ranks_to_indices`.
Float tolerances: the closed-form 4-point solver at 1e-4 of each
model's largest entry and the transfer error at rtol 1e-4 (float32 in
another operation order); the weighted DLT refit
(eigh + inverse iteration in float32) to 1e-3 px on mapped points."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

from tpu3drec.ops import geometry as jg
from tpu3drec.ops import ransac as jr
from tpu3drec_torch.ops import geometry as tg
from tpu3drec_torch.ops import ransac as tr

INT_MAX = 2 ** 31 - 1


def _jax_uniforms(key, K, s=4):
    return np.asarray(jax.random.randint(key, (K, s), 0, INT_MAX,
                                         dtype=jnp.int32))


def _correspondences(seed, n=120, outliers=0.3, noise=0.5):
    rng = np.random.default_rng(seed)
    Hgt = np.array([[0.95, -0.12, 14.0], [0.11, 0.97, -6.0],
                    [2e-5, -1e-5, 1.0]])
    p1 = rng.uniform(0, 320, (n, 2))
    ph = np.c_[p1, np.ones(n)] @ Hgt.T
    p2 = ph[:, :2] / ph[:, 2:] + rng.normal(0, noise, (n, 2))
    bad = rng.random(n) < outliers
    p2[bad] = rng.uniform(0, 320, (bad.sum(), 2))
    mask = rng.random(n) > 0.1
    return p1.astype(np.float32), p2.astype(np.float32), mask, Hgt


@pytest.mark.parametrize("n_valid", [0, 2, 4, 5, 37, 200])
def test_ranks_to_indices_replays_sample_minimal_sets(n_valid):
    rng = np.random.default_rng(n_valid)
    mask = np.zeros(200, bool)
    mask[rng.permutation(200)[:n_valid]] = True
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jr.sample_minimal_sets(key, jnp.asarray(mask), 64, 4))
    got = tr.ranks_to_indices(torch.from_numpy(_jax_uniforms(key, 64)),
                              torch.from_numpy(mask)[None])[0].numpy()
    np.testing.assert_array_equal(got, ref)


def test_homography_4pt_flat_and_transfer_error_match_jax():
    rng = np.random.default_rng(1)
    p1 = rng.uniform(0, 300, (64, 4, 2)).astype(np.float32)
    p2 = (p1 @ np.array([[0.9, 0.1], [-0.1, 0.95]], np.float32).T
          + rng.normal(0, 3, p1.shape).astype(np.float32) + 7)
    hv, ok = tg._homography_4pt_flat(torch.from_numpy(p1), torch.from_numpy(p2))
    rh, rok = jax.vmap(jg._homography_4pt_flat)(jnp.asarray(p1), jnp.asarray(p2))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    # entries to 1e-4 of each model's largest entry: small entries of a
    # projective matrix carry the absolute error of the large ones
    rh_np = np.asarray(rh)
    scale = np.abs(rh_np).max(axis=1, keepdims=True)
    assert np.all(np.abs(hv.numpy() - rh_np) <= 1e-4 * scale)

    # the error function on the same models (the reference's)
    pts1 = rng.uniform(0, 300, (50, 2)).astype(np.float32)
    pts2 = rng.uniform(0, 300, (50, 2)).astype(np.float32)
    err = tg._homography_transfer_error_flat(
        torch.from_numpy(rh_np)[None], torch.from_numpy(pts1)[None],
        torch.from_numpy(pts2)[None])[0]
    rerr = jax.vmap(jg._homography_transfer_error_flat, in_axes=(0, None, None))(
        rh, jnp.asarray(pts1), jnp.asarray(pts2))
    np.testing.assert_allclose(err.numpy(), np.asarray(rerr), rtol=1e-4, atol=1e-3)


def test_find_homography_with_injected_draws_matches_jax():
    """Same samples -> same best hypothesis, inlier count and mask, for a
    batch of problems scored at once."""
    K = 128
    key = jax.random.PRNGKey(0)
    u = torch.from_numpy(_jax_uniforms(key, K))
    probs = [_correspondences(s) for s in range(3)]
    p1 = torch.from_numpy(np.stack([p[0] for p in probs]))
    p2 = torch.from_numpy(np.stack([p[1] for p in probs]))
    m = torch.from_numpy(np.stack([p[2] for p in probs]))
    got = tg.find_homography(p1, p2, mask=m, num_hypotheses=K, refit=False, u=u)
    for b, (q1, q2, mask, _) in enumerate(probs):
        ref = jg.find_homography(jnp.asarray(q1), jnp.asarray(q2),
                                 mask=jnp.asarray(mask), num_hypotheses=K,
                                 key=key, refit=False)
        np.testing.assert_allclose(got.model[b].numpy(), np.asarray(ref.model),
                                   rtol=1e-4, atol=1e-6)
        assert int(got.num_inliers[b]) == int(ref.num_inliers)
        np.testing.assert_array_equal(got.inliers[b].numpy(),
                                      np.asarray(ref.inliers))
        np.testing.assert_allclose(float(got.inlier_ratio[b]),
                                   float(ref.inlier_ratio), rtol=1e-6)
        assert bool(got.success[b]) == bool(ref.success)


def _map(H, pts):
    ph = np.c_[pts, np.ones(len(pts))] @ np.asarray(H, np.float64).T
    return ph[:, :2] / ph[:, 2:]


def test_dlt_refit_matches_jax():
    p1, p2, mask, _ = _correspondences(4, outliers=0.0)
    w = mask.astype(np.float32)
    H, ok = tg.solve_homography_dlt(torch.from_numpy(p1), torch.from_numpy(p2),
                                    torch.from_numpy(w))
    rH, rok = jg.solve_homography_dlt(jnp.asarray(p1), jnp.asarray(p2),
                                      jnp.asarray(w))
    assert bool(ok) and bool(rok)
    grid = np.array([[0, 0], [320, 0], [0, 320], [320, 320], [160, 160]], float)
    np.testing.assert_allclose(_map(H.numpy(), grid), _map(rH, grid), atol=1e-3)
    # the minimal case takes the exact QR null vector
    H4, ok4 = tg.solve_homography_dlt(torch.from_numpy(p1[:4]),
                                      torch.from_numpy(p2[:4]))
    rH4, _ = jg.solve_homography_dlt(jnp.asarray(p1[:4]), jnp.asarray(p2[:4]))
    assert bool(ok4)
    np.testing.assert_allclose(_map(H4.numpy(), grid), _map(rH4, grid), atol=1e-3)


def test_find_homography_refit_and_reprojection_error():
    K = 256
    key = jax.random.PRNGKey(3)
    p1, p2, mask, Hgt = _correspondences(5)
    got = tg.find_homography(torch.from_numpy(p1), torch.from_numpy(p2),
                             mask=torch.from_numpy(mask), num_hypotheses=K,
                             u=torch.from_numpy(_jax_uniforms(key, K)))
    ref = jg.find_homography(jnp.asarray(p1), jnp.asarray(p2),
                             mask=jnp.asarray(mask), num_hypotheses=K, key=key)
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= 1
    grid = np.array([[0, 0], [320, 0], [0, 320], [320, 320]], float)
    np.testing.assert_allclose(_map(got.model.numpy(), grid),
                               _map(ref.model, grid), atol=1e-2)
    assert np.abs(_map(got.model.numpy(), grid) - _map(Hgt, grid)).max() < 1.0
    e = tg.reprojection_error_homography(got.model, torch.from_numpy(p1),
                                         torch.from_numpy(p2), got.inliers)
    re = jg.reprojection_error_homography(ref.model, jnp.asarray(p1),
                                          jnp.asarray(p2), ref.inliers)
    np.testing.assert_allclose(float(e), float(re), rtol=1e-3)
