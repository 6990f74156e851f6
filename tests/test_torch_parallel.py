"""Parity of tpu3drec_torch.parallel (mesh, tensor-parallel and ring 2-NN,
the sharded pair step, the sharded stereo) with tpu3drec.parallel.

The port's multi-rank cases run in two gloo worlds on the CPU, of 2 and
4 ranks (`torch_dist_worker.py`), each started once for the module; the
reference runs in this process with `shard_map` over the 8 virtual CPU
devices of `conftest.py`, on the shapes of `tests/test_parallel.py`.
Bars: `tp_knn2` indices exact and distances at rtol/atol 1e-4 (`l2`
sums float32 products in another order); `l2_int8` squared distances
exact and the float32 sqrt within one ulp (the two CPU libraries round
it differently); the 3.4e38 of a slot with no valid column equal. `ring_knn2`:
distances at 1e-4, indices equal off exact ties. The pair step on a
(2, 2) mesh against the port's single-rank stages with the same
uniforms: match counts within max(2, 2%), `total_matches` the exact sum.
The sharded stereo bit-equal to the port's `stereo_depth_pair` per pair,
and within `test_torch_stereo.py`'s bars of the reference's sharded
stereo; the dense pipeline's sharded branch within those bars of its
one-card stereo.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import (                                         # noqa: E402
    pair_stages_l2, pair_uniforms, sift_detect_fn, small_stereo_folder,
)
from torch_dist_worker import run_world                          # noqa: E402
from tpu3drec.ops import match as jm                             # noqa: E402
from tpu3drec.parallel import mesh as jmesh                      # noqa: E402
from tpu3drec.parallel.dense import (                            # noqa: E402
    sharded_pairwise_stereo as j_sharded_stereo,
)
from tpu3drec.parallel.pairs import ring_knn2 as j_ring          # noqa: E402
from tpu3drec.parallel.pairs import tp_knn2 as j_tp              # noqa: E402
from tpu3drec_torch.ops import match as tm                       # noqa: E402
from tpu3drec_torch.ops.stereo import stereo_depth_pair          # noqa: E402
from tpu3drec_torch.parallel import mesh as tmesh                # noqa: E402
from tpu3drec_torch.pipelines.dense import (                     # noqa: E402
    DenseReconstructionPipeline,
)

INF = np.float32(3.4e38)
N, M, D = 64, 128, 32


def _knn_inputs(seed, all_rows=True):
    """tests/test_parallel.py's 2-NN inputs."""
    rng = np.random.default_rng(seed)
    d1 = rng.normal(size=(N, D)).astype(np.float32)
    d2 = rng.normal(size=(M, D)).astype(np.float32)
    m1 = np.ones(N, bool) if all_rows else rng.random(N) > 0.1
    m2 = rng.random(M) > 0.1
    return d1, d2, m1, m2


def _edge_inputs(metric, case):
    """Rank 0's half of the columns with no valid column and rank 1's
    with one ("none|one"), or rank 0's with one and rank 1's scattered
    ("one|some"); `l2_int8` descriptors on the 0..255 scale."""
    rng = np.random.default_rng(7)
    scale = 255.0 if metric == "l2_int8" else 1.0
    d1 = (rng.uniform(0, 1, (N, D)) * scale).astype(np.float32)
    d2 = (rng.uniform(0, 1, (M, D)) * scale).astype(np.float32)
    m2 = np.zeros(M, bool)
    if case == "none|one":
        m2[M // 2 + 17] = True
    else:
        m2[5] = True
        m2[M // 2:] = rng.random(M // 2) > 0.5
    return d1, d2, np.ones(N, bool), m2


TP_CASES = [("main", "l2")] + [(c, m) for c in ("none|one", "one|some")
                               for m in ("l2", "l2_int8")]


def _tp_input(case, metric):
    return _knn_inputs(0) if case == "main" else _edge_inputs(metric, case)


def _pair_images():
    """tests/test_parallel.py's 8 corner-rich 72x72 images."""
    B, H, W = 8, 72, 72

    def mk(seed):
        r = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        img = 0.3 * (((yy // 8).astype(int) + (xx // 8).astype(int)) % 2)
        for _ in range(10):
            cy, cx = r.uniform(10, H - 10), r.uniform(10, W - 10)
            s_ = r.uniform(2.0, 5.0)
            img += r.uniform(0.2, 0.5) * np.exp(
                -(((yy - cy) / s_) ** 2 + ((xx - cx) / s_) ** 2))
        img -= img.min()
        return (img / max(img.max(), 1e-6)).astype(np.float32)
    return np.stack([mk(i) for i in range(B)])


PAIR_FEATURES, PAIR_HYPOTHESES = 64, 32


def _pair_step_input():
    imgs = _pair_images()
    u = pair_uniforms(torch, imgs.shape[0], PAIR_HYPOTHESES, "cpu")
    return {"imgs1": imgs, "imgs2": imgs.copy(), "u": u.numpy(),
            "mesh": (2, 2), "max_features": PAIR_FEATURES,
            "num_hypotheses": PAIR_HYPOTHESES}


def _stereo_input():
    """tests/test_parallel.py's sharded-stereo scene with 3 neighbours:
    on 2 ranks the second chunk is padded."""
    import cv2
    rng = np.random.default_rng(5)
    h, w = 96, 128
    base = cv2.GaussianBlur(rng.uniform(0, 1, (h, w)).astype(np.float32),
                            (5, 5), 1.0)
    K = np.array([[150, 0, w / 2], [0, 150, h / 2], [0, 0, 1]], np.float32)
    neighbours = [(np.roll(base, int(bx * 50), axis=1), K,
                   np.eye(3, dtype=np.float32),
                   np.array([bx, 0, 0], np.float32), None)
                  for bx in (-0.1, 0.1, -0.2)]
    return {"base": base, "neighbours": neighbours, "K": K,
            "num_disparities": 32}


def _dense_input():
    """chip_smoke.py's phase 12 dense folder: a photo and 3 neighbours
    (the sharded stereo's second chunk padded on 2 ranks)."""
    sparse, images = small_stereo_folder()
    return sparse, images, 32


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("world2"), 2, "parallel", {
        "tp_knn2": [_tp_input(c, m) + (m,) for c, m in TP_CASES],
        "stereo": _stereo_input(), "dense": _dense_input()})


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("world4"), 4, "parallel", {
        "tp_knn2": [], "ring": _knn_inputs(3, all_rows=False),
        "pair_step": _pair_step_input()})


def _same_on_every_rank(outs, key):
    for o in outs[1:]:
        for a, b in zip(jax.tree_util.tree_leaves(outs[0][key]),
                        jax.tree_util.tree_leaves(o[key])):
            np.testing.assert_array_equal(a, b)


def test_default_mesh_shape_matches_jax():
    for n in range(1, 17):
        assert tmesh.default_mesh_shape(n) == jmesh.default_mesh_shape(n), n
    assert tmesh.DATA_AXIS == jmesh.DATA_AXIS
    assert tmesh.MODEL_AXIS == jmesh.MODEL_AXIS


def test_mesh_shape_must_hold_every_rank(world2, world4):
    assert world2[0]["shape_error"] == "mesh shape 2x2 != 2 devices"
    assert world4[0]["shape_error"] == "mesh shape 4x2 != 4 devices"


@pytest.mark.parametrize("metric", ["l2", "l2_int8", "hamming_pm1"])
def test_distance_matrix_matches_jax(metric):
    rng = np.random.default_rng(1)
    if metric == "l2":        # unit-scale rows: no 0..255 cancellation
        a, b = (rng.normal(size=(s, 64)).astype(np.float32) for s in (50, 70))
        a /= np.linalg.norm(a, axis=1, keepdims=True)
        b /= np.linalg.norm(b, axis=1, keepdims=True)
    elif metric == "l2_int8":
        a, b = (rng.uniform(0, 255, (s, 128)).astype(np.float32)
                for s in (50, 70))
    else:
        a, b = (np.sign(rng.normal(size=(s, 256))).astype(np.float32)
                for s in (50, 70))
    got = tm.distance_matrix(torch.from_numpy(a), torch.from_numpy(b),
                             metric).numpy()
    ref = np.asarray(jm.distance_matrix(jnp.asarray(a), jnp.asarray(b),
                                        metric))
    assert got.shape == ref.shape == (50, 70)
    if metric == "l2":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    elif metric == "hamming_pm1":
        np.testing.assert_array_equal(got, ref)
    else:
        # exact integer squares; the float32 sqrt within one ulp (torch's
        # vectorised CPU sqrt is not correctly rounded everywhere)
        q = lambda x: np.round(np.clip(x, 0, 255)).astype(np.int64)
        d2 = ((q(a)[:, None, :] - q(b)[None, :, :]) ** 2).sum(-1)
        for x in (got, ref):
            np.testing.assert_array_equal(np.round(x.astype(np.float64) ** 2), d2)
        np.testing.assert_allclose(got, ref, rtol=2.4e-7, atol=0)


def _jax_tp_knn2(d1, d2, m1, m2, metric):
    mesh = jmesh.make_mesh(jax.devices()[:2], shape=(1, 2))
    fn = shard_map(lambda a, b, c, e: j_tp(a, b, c, e, metric=metric),
                   mesh=mesh, in_specs=(P(), P("tp"), P(), P("tp")),
                   out_specs=(P(), P()), check_vma=False)
    idx, dist = jax.jit(fn)(*(jnp.asarray(x) for x in (d1, d2, m1, m2)))
    return np.asarray(idx), np.asarray(dist)


@pytest.mark.parametrize("k", range(len(TP_CASES)),
                         ids=["-".join(c) for c in TP_CASES])
def test_tp_knn2_matches_jax(world2, k):
    case, metric = TP_CASES[k]
    ridx, rdist = _jax_tp_knn2(*_tp_input(case, metric), metric)
    idx, dist = world2[0]["tp_knn2"][k]
    for o in world2[1:]:
        np.testing.assert_array_equal(o["tp_knn2"][k][0], idx)
        np.testing.assert_array_equal(o["tp_knn2"][k][1], dist)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(dist == INF, rdist == INF)
    fin = rdist < INF
    if case == "none|one":      # one valid column: no second neighbour
        assert (~fin[:, 1]).all() and fin[:, 0].all()
    if metric == "l2":
        np.testing.assert_allclose(dist[fin], rdist[fin], rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(np.round(dist[fin].astype(np.float64) ** 2),
                                      np.round(rdist[fin].astype(np.float64) ** 2))
        np.testing.assert_allclose(dist[fin], rdist[fin], rtol=2.4e-7, atol=0)


def test_ring_knn2_matches_jax(world4):
    d1, d2, m1, m2 = _knn_inputs(3, all_rows=False)
    mesh = jmesh.make_mesh(jax.devices()[:4], shape=(1, 4))
    fn = shard_map(lambda a, b, c, e: j_ring(a, b, c, e), mesh=mesh,
                   in_specs=(P("tp"),) * 4, out_specs=(P("tp"), P("tp")),
                   check_vma=False)
    ridx, rdist = (np.asarray(x) for x in jax.jit(fn)(
        *(jnp.asarray(x) for x in (d1, d2, m1, m2))))
    idx = np.concatenate([o["ring"][0] for o in world4])
    dist = np.concatenate([o["ring"][1] for o in world4])
    assert idx.shape == ridx.shape == (N, 2)
    np.testing.assert_array_equal(dist[~m1], np.full((int((~m1).sum()), 2), INF))
    np.testing.assert_array_equal(rdist[~m1], dist[~m1])
    np.testing.assert_allclose(dist[m1], rdist[m1], rtol=1e-4, atol=1e-4)
    # indices off exact ties of the two nearest
    clear = m1 & (rdist[:, 0] < rdist[:, 1])
    np.testing.assert_array_equal(idx[clear], ridx[clear])


def test_pair_step_on_a_2x2_mesh_matches_one_rank(world4):
    inp = _pair_step_input()
    _same_on_every_rank(world4, "pair_step")
    st = world4[0]["pair_step"]
    one = pair_stages_l2(sift_detect_fn(inp["max_features"]),
                         *(torch.from_numpy(inp[k]) for k in ("imgs1", "imgs2", "u")))
    nm, ni = one["num_matches"].numpy(), one["num_inliers"].numpy()
    assert st["num_matches"].shape == (8,)
    assert (st["num_matches"] >= 2).all(), st["num_matches"]
    tol = np.maximum(2, 0.02 * nm)
    assert (np.abs(st["num_matches"] - nm) <= tol).all(), (st["num_matches"], nm)
    assert (np.abs(st["num_inliers"] - ni) <= tol).all(), (st["num_inliers"], ni)
    np.testing.assert_array_equal(st["total_matches"],
                                  np.full(8, st["num_matches"].sum()))


def test_sharded_stereo_matches_unsharded_and_jax(world2):
    inp = _stereo_input()
    _same_on_every_rank(world2, "stereo")
    outs = world2[0]["stereo"]
    assert len(outs) == 3
    mesh = jmesh.make_mesh(jax.devices(), shape=(8, 1))
    refs = j_sharded_stereo(mesh, inp["base"], inp["neighbours"], inp["K"],
                            num_disparities=inp["num_disparities"])
    base = torch.from_numpy(inp["base"])
    for (img2, K2, R, t, _), got, ref in zip(inp["neighbours"], outs, refs):
        one = stereo_depth_pair(base, torch.from_numpy(img2), inp["K"], K2,
                                R, t, num_disparities=inp["num_disparities"])
        for k in ("depth", "disparity", "valid", "baseline"):
            np.testing.assert_array_equal(got[k], np.asarray(one[k]))
        both = got["valid"] & ref["valid"]
        assert both.mean() > 0.25
        assert (got["valid"] == ref["valid"]).mean() > 0.999
        np.testing.assert_allclose(got["depth"][both], ref["depth"][both],
                                   rtol=1e-4, atol=1e-4)


def test_dense_pipeline_shards_its_stereo(world2):
    """Inside a group of 2 ranks the dense pipeline splits its stereo
    pairs over the ranks and fuses the gathered depths on each: both
    ranks end with the same fused depth, which holds
    `test_torch_stereo.py`'s bars against the one-card stereo."""
    _same_on_every_rank(world2, "dense")
    sparse, images, ndisp = _dense_input()
    one = DenseReconstructionPipeline(num_disparities=ndisp, device="cpu",
                                      use_sharded_stereo=False)
    rep = one.run_complete_pipeline(sparse, images, reference_view="v0.png")
    got = world2[0]["dense"]
    assert got["per_view"].keys() == rep["depth"]["per_view"].keys()
    d, f = got["depth"], one._arrays["depth"]
    both = (d > 0) & (f > 0)
    assert both.mean() > 0.5
    assert ((d > 0) == (f > 0)).mean() > 0.999
    np.testing.assert_allclose(d[both], f[both], rtol=1e-4, atol=1e-4)
