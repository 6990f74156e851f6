"""Parity of the port's point-cloud, TSDF, mesh and dense-pipeline code
with the JAX package on the CPU.

Same numpy inputs through both packages. Tolerances:
- host numpy copies (voxel kNN, downsampling, clustering, analytics,
  marching tetrahedra, mesh utilities, exports) are exact;
- device float32 math in the reference's order (backprojection, kNN
  distances, TSDF): rtol 1e-5 / atol 1e-5 (small matrix products sum in
  another order);
- normals: |cos| between the two > 0.9999 (eigh and the closed form
  agree to float32 rounding; the sign is fixed toward the viewpoint);
- the whole pipeline at 96x128 (3 views, 16 disparities, TSDF at 32,
  outlier_k 8) against the reference's single-device branch: fused
  depth within rtol/atol 1e-4 where both are valid, valid masks equal on
  > 99.9% of pixels (the reference's band-vs-gather bar), per-view valid
  fractions within 1e-3, point and face counts within 0.5%.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu3drec.ops import mesh as jmesh
from tpu3drec.ops import pointcloud as jpc
from tpu3drec.ops import tsdf as jtsdf
from tpu3drec.pipelines.dense import DenseReconstructionPipeline as JPipe
import tpu3drec_torch
from tpu3drec_torch.ops import mesh as tmesh
from tpu3drec_torch.ops import pointcloud as tpc
from tpu3drec_torch.ops import tsdf as ttsdf
from tpu3drec_torch.pipelines.dense import (
    DenseReconstructionPipeline, validate_sparse_input,
)

TOL = dict(rtol=1e-5, atol=1e-5)
H, W = 96, 128
K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cloud(n=600, seed=0, outliers=20):
    """A noisy plane patch plus a few far outliers; mask drops 5%."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    pts[:, 2] = 0.05 * pts[:, 0] + 0.01 * rng.standard_normal(n)
    pts[:outliers, 2] += 3.0
    mask = rng.uniform(size=n) > 0.05
    return pts.astype(np.float32), mask


def _photo(h, w, seed):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for _ in range(150):
        y, x = rng.integers(0, h - 16), rng.integers(0, w - 16)
        hh, ww = rng.integers(4, 24), rng.integers(4, 24)
        img[y:y + hh, x:x + ww] += rng.uniform(-0.5, 0.5)
    img += 0.05 * rng.standard_normal((h, w)).astype(np.float32)
    img -= img.min()
    img /= img.max()
    return img.astype(np.float32)


def _depth_scene():
    """A tilted plane at depth ~5 with a box at depth 4, 10% invalid."""
    rng = np.random.default_rng(2)
    ys, xs = np.mgrid[0:H, 0:W]
    depth = (5.0 + 0.01 * xs - 0.005 * ys).astype(np.float32)
    depth[30:60, 40:80] = 4.0
    valid = rng.uniform(size=(H, W)) > 0.1
    return depth, valid


# ---------------------------------------------------------------------
# point clouds
# ---------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2])
def test_depth_map_to_point_cloud_matches_jax(stride):
    depth, valid = _depth_scene()
    R = np.array([[0.99, -0.1, 0.0], [0.1, 0.99, 0.0], [0, 0, 1]], np.float32)
    t = np.array([0.2, -0.1, 0.5], np.float32)
    img = _photo(H, W, 1)
    got = tpc.depth_map_to_point_cloud(_t(depth), K.astype(np.float32), R, t,
                                       image=_t(img), valid=_t(valid),
                                       stride=stride)
    ref = jpc.depth_map_to_point_cloud(
        jnp.asarray(depth), jnp.asarray(K.astype(np.float32)),
        jnp.asarray(R), jnp.asarray(t), image=jnp.asarray(img),
        valid=jnp.asarray(valid), stride=stride)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_knn_dists_and_outlier_masks_match_jax():
    pts, mask = _cloud()
    d = tpc._chunked_knn_dists(_t(pts), _t(mask), 8, chunk=256)
    jd = jpc._chunked_knn_dists(jnp.asarray(pts), jnp.asarray(mask), 8,
                                chunk=256)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)
    keep = tpc.statistical_outlier_mask(_t(pts), _t(mask), k=8).numpy()
    jkeep = np.asarray(jpc.statistical_outlier_mask(
        jnp.asarray(pts), jnp.asarray(mask), k=8))
    np.testing.assert_array_equal(keep, jkeep)
    assert not keep[:20].any() and keep[20:][mask[20:]].mean() > 0.9
    rk = tpc.radius_outlier_mask(_t(pts), _t(mask), 0.1).numpy()
    jrk = np.asarray(jpc.radius_outlier_mask(jnp.asarray(pts),
                                             jnp.asarray(mask), 0.1))
    np.testing.assert_array_equal(rk, jrk)


def _assert_normals_close(a, b):
    cos = np.sum(a * b, 1)
    assert np.min(cos) > 0.9999, np.min(cos)


def test_estimate_normals_matches_jax():
    pts, mask = _cloud(outliers=0)
    vp = np.array([0.0, 0.0, 10.0], np.float32)
    got = tpc.estimate_normals(_t(pts), _t(mask), k=16,
                               viewpoint=vp).numpy()
    ref = np.asarray(jpc.estimate_normals(jnp.asarray(pts),
                                          jnp.asarray(mask), k=16,
                                          viewpoint=jnp.asarray(vp)))
    _assert_normals_close(got, ref)
    assert (got[:, 2] > 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_smallest_eigvec_sym3_matches_jax(seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((500, 3, 3)).astype(np.float32)
    A = (A @ A.transpose(0, 2, 1)).astype(np.float32)
    A[:5] = np.diag([1.0, 1.0, 1.0]).astype(np.float32)   # degenerate
    A[5:10, 2] = 0.0
    A[5:10, :, 2] = 0.0                                   # rank 2
    got = tpc._smallest_eigvec_sym3(_t(A)).numpy()
    ref = np.asarray(jpc._smallest_eigvec_sym3(jnp.asarray(A)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    w, v = np.linalg.eigh(A[10:].astype(np.float64))
    cos = np.abs(np.sum(got[10:] * v[:, :, 0], 1))
    # well-separated smallest eigenvalues recover LAPACK's vector
    sep = (w[:, 1] - w[:, 0]) > 1e-2 * w[:, 2]
    assert np.median(cos[sep]) > 0.9999


def test_scaled_normals_and_voxel_knn_match_jax():
    pts, mask = _cloud(n=3000, outliers=0, seed=3)
    idx, nm = tpc.voxel_knn_indices(pts, 16, mask)
    jidx, jnm = jpc.voxel_knn_indices(pts, 16, mask)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(nm, jnm)
    vp = np.array([0.0, 0.0, 10.0], np.float32)
    got = tpc.normals_from_indices(_t(pts), _t(idx), _t(nm), vp).numpy()
    ref = np.asarray(jpc.normals_from_indices(
        jnp.asarray(pts), jnp.asarray(idx), jnp.asarray(nm),
        jnp.asarray(vp)))
    _assert_normals_close(got[mask], ref[mask])
    sc = tpc.estimate_normals_scaled(_t(pts), _t(mask), viewpoint=vp)
    np.testing.assert_array_equal(sc.numpy(), got)


def test_host_cloud_analytics_match_jax(tmp_path):
    pts, mask = _cloud(n=2000, seed=4)
    colors = np.random.default_rng(5).uniform(size=(2000, 3))
    a = tpc.voxel_downsample(pts, 0.1, colors, mask)
    b = jpc.voxel_downsample(pts, 0.1, colors, mask)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert tpc.nearest_neighbor_stats(pts) == jpc.nearest_neighbor_stats(pts)
    la, na, oa = tpc.cluster_point_cloud(pts)
    lb, nb, ob = jpc.cluster_point_cloud(pts)
    np.testing.assert_array_equal(la, lb)
    assert (na, oa) == (nb, ob)
    assert tpc.point_cloud_quality(pts, mask, colors) == \
        jpc.point_cloud_quality(pts, mask, colors)
    nrm = np.tile(np.array([[0.0, 0.0, 1.0]]), (2000, 1))
    tpc.save_ply(tmp_path / "a.ply", pts, colors, nrm)
    jpc.save_ply(tmp_path / "b.ply", pts, colors, nrm)
    assert (tmp_path / "a.ply").read_text() == (tmp_path / "b.ply").read_text()


# ---------------------------------------------------------------------
# TSDF and meshes
# ---------------------------------------------------------------------

def _tsdf_views():
    depth, valid = _depth_scene()
    Ks = np.stack([K, K]).astype(np.float32)
    Rs = np.stack([np.eye(3), np.eye(3)]).astype(np.float32)
    ts = np.array([[0, 0, 0], [0.05, 0, 0]], np.float32)
    return np.stack([depth, depth]), np.stack([valid, valid]), Ks, Rs, ts


def test_tsdf_fuse_matches_jax():
    depths, valids, Ks, Rs, ts = _tsdf_views()
    # an origin and voxel off the pixel lattice: XLA:CPU computes
    # x / z * f + c within 1 ulp, not correctly rounded, which can flip
    # round() where u lands exactly on .5 (observed: 0.3% of voxels on
    # a 0.1 lattice)
    origin = np.array([-2.5037, -2.0111, 3.4571], np.float32)
    args = (np.float32(0.0973), (40, 32, 24), np.float32(0.2919))
    tsdf, wt = ttsdf.tsdf_fuse(_t(depths), _t(valids), Ks, Rs, ts, origin,
                               *args)
    jt, jw = jtsdf.tsdf_fuse(jnp.asarray(depths), jnp.asarray(valids),
                             jnp.asarray(Ks), jnp.asarray(Rs),
                             jnp.asarray(ts), jnp.asarray(origin),
                             jnp.float32(args[0]), args[1],
                             jnp.float32(args[2]))
    jw = np.asarray(jw)
    same = wt.numpy() == jw
    assert same.mean() > 0.9999, same.mean()
    assert (jw > 0).mean() > 0.2
    np.testing.assert_allclose(tsdf.numpy()[same], np.asarray(jt)[same],
                               **TOL)


def test_tsdf_mesh_matches_jax():
    depths, valids, Ks, Rs, ts = _tsdf_views()
    got = ttsdf.tsdf_mesh(depths[0], valids[0], Ks[0], Rs[0], ts[0],
                          resolution=32, device="cpu")
    ref = jtsdf.tsdf_mesh(depths[0], valids[0], Ks[0], Rs[0], ts[0],
                          resolution=32)
    np.testing.assert_array_equal(got["origin"], ref["origin"])
    assert got["voxel"] == ref["voxel"]
    assert got["tsdf"].shape == ref["tsdf"].shape
    np.testing.assert_allclose(got["tsdf"], ref["tsdf"], **TOL)
    assert len(got["faces"]) > 500
    assert abs(len(got["faces"]) - len(ref["faces"])) <= \
        0.005 * len(ref["faces"])
    # marching tetrahedra is a host copy: same input grid, same mesh
    v, f = ttsdf.marching_tetrahedra(ref["tsdf"], ref["weight"],
                                     ref["origin"], ref["voxel"])
    np.testing.assert_array_equal(v, ref["verts"])
    np.testing.assert_array_equal(f, ref["faces"])
    with pytest.raises(ValueError):
        ttsdf.tsdf_mesh(depths[0], np.zeros_like(valids[0]), Ks[0], Rs[0],
                        ts[0], device="cpu")


def test_tsdf_mesh_device_none_means_cuda(monkeypatch):
    """`device=None` is CUDA, as for every entry point that takes host
    arrays: without a card it raises rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    depths, valids, Ks, Rs, ts = _tsdf_views()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttsdf.tsdf_mesh(depths[0], valids[0], Ks[0], Rs[0], ts[0],
                        resolution=16)


def test_mesh_functions_match_jax(tmp_path):
    depth, valid = _depth_scene()
    R = np.eye(3)
    t = np.zeros(3)
    v, f = tmesh.depth_map_to_mesh(depth, K, R, t, valid=valid, stride=4)
    jv, jf = jmesh.depth_map_to_mesh(depth, K, R, t, valid=valid, stride=4)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    for fn in ("repair_mesh", "smooth_mesh"):
        a, b = getattr(tmesh, fn)(v, f), getattr(jmesh, fn)(v, f)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert tmesh.mesh_quality(v, f) == jmesh.mesh_quality(v, f)
    assert tmesh.mesh_volume(v, f) == jmesh.mesh_volume(v, f)
    cams = {"a": {"K": K, "R": R, "t": t}}
    imgs = {"a": _photo(H, W, 3)}
    np.testing.assert_array_equal(tmesh.project_texture(v, cams, imgs),
                                  jmesh.project_texture(v, cams, imgs))
    dv, df = tmesh.delaunay_mesh(v[::7], max_edge=1.0)
    jdv, jdf = jmesh.delaunay_mesh(v[::7], max_edge=1.0)
    np.testing.assert_array_equal(dv, jdv)
    np.testing.assert_array_equal(df, jdf)
    tmesh.save_obj(tmp_path / "a.obj", v, f, v)
    jmesh.save_obj(tmp_path / "b.obj", v, f, v)
    assert (tmp_path / "a.obj").read_text() == (tmp_path / "b.obj").read_text()


# ---------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------

def _folder():
    """Three views of a fronto-parallel plane at depth 5: one photo rolled
    by 5 px per 0.25 of baseline."""
    base = _photo(H, W, 7)
    images, cams = {}, {}
    for i, bx in enumerate([-0.25, 0.0, 0.25]):
        name = f"v{i}.png"
        images[name] = np.roll(base, int(round(20 * bx)), axis=1)
        cams[name] = {"camera_matrix": K.tolist(),
                      "rotation": np.eye(3).tolist(),
                      "translation": [bx, 0.0, 0.0]}
    return {"camera_poses": cams, "points_3d": [[0, 0, 5.0]]}, images


PIPE_KW = dict(num_disparities=16, tsdf_resolution=32, outlier_k=8)


@pytest.fixture(scope="module")
def dense_runs(tmp_path_factory):
    sparse, images = _folder()
    jp = JPipe(use_sharded_stereo=False, **PIPE_KW)
    jres = jp.run_complete_pipeline(sparse, images)
    out = tmp_path_factory.mktemp("dense")
    tres = tpu3drec_torch.run_dense_reconstruction(
        sparse, images, output_dir=out, device="cpu", **PIPE_KW)
    tp = DenseReconstructionPipeline(device="cpu", **PIPE_KW)
    tp.run_complete_pipeline(sparse, images)
    return jres, jp._arrays, tres, tp._arrays, out


def test_run_dense_reconstruction_matches_jax(dense_runs):
    jres, jarr, tres, tarr, _ = dense_runs
    dj, dt = jarr["depth"], tarr["depth"]
    vj, vt = dj > 0, dt > 0
    assert (vj == vt).mean() > 0.999
    both = vj & vt
    np.testing.assert_allclose(dt[both], dj[both], rtol=1e-4, atol=1e-4)
    assert abs(np.median(dt[vt]) - 5.0) < 0.05
    for n, pv in jres["depth"]["per_view"].items():
        assert abs(tres["depth"]["per_view"][n]["valid_fraction"]
                   - pv["valid_fraction"]) < 1e-3
    np.testing.assert_allclose(tres["depth"]["baselines"],
                               jres["depth"]["baselines"], rtol=1e-6)
    for key in ("point_cloud", "mesh"):
        count = "num_points" if key == "point_cloud" else "num_faces"
        assert abs(tres[key][count] - jres[key][count]) <= \
            0.005 * jres[key][count]
    assert tres["mesh"]["method"] == jres["mesh"]["method"] == "tsdf"
    assert set(tres) == set(jres) | {"output_dir"}
    assert set(tres["timings_s"]) == set(jres["timings_s"])
    for k, v in jarr.items():
        assert tarr[k].shape[1:] == v.shape[1:] and tarr[k].dtype == v.dtype


def test_dense_outputs_written(dense_runs):
    out = dense_runs[4]
    for f in ("fused_depth.npy", "point_cloud.ply", "mesh.obj",
              "dense_report.json"):
        assert (out / f).exists(), f


@pytest.mark.parametrize("method", ["poisson", "ball_pivot", "alpha"])
def test_unported_mesh_methods_raise(method):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DenseReconstructionPipeline(mesh_method=method, device="cpu")


def test_multi_reference_and_default_device():
    sparse, images = _folder()
    pipe = DenseReconstructionPipeline(device="cpu", **PIPE_KW)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipe.run_multi_reference(sparse, images)
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpu3drec_torch.run_dense_reconstruction(sparse, images)


def test_validate_sparse_input_matches_reference():
    from tpu3drec.pipelines.dense import validate_sparse_input as jvalid
    sparse, _ = _folder()
    bad = {"camera_poses": {"a": {"K": []}}}
    for s in ({}, sparse, bad):
        assert validate_sparse_input(s) == jvalid(s)
