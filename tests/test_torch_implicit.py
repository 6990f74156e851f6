"""Parity of the rest of the port's dense stage with the JAX package on
the CPU: implicit-surface meshing (`ops/implicit.py`: splat, spectral
Poisson solve, iso sampling, distance grid, Poisson / alpha / ball-pivot
meshes), farthest-point sampling, ICP and cloud merging
(`ops/pointcloud.py`), mesh simplification and comparison
(`ops/mesh.py`), and the pipeline's implicit mesh methods and
multi-reference mode.

Same numpy inputs through both packages. Tolerances:
- host numpy copies (grid setup, dilation, spacing, simplification,
  comparison, merging without ICP): exact;
- splat V / density: rtol / atol 1e-6 (scatter-adds in another order);
  chi: within the first-order rounding bound of two float32 FFT
  implementations (`_fft_gap_bound`, from the grid size and sum |V|;
  each package's own float32 chi is ~2.4e-6 x max |chi| from a float64
  solve, so the former 1e-6 x max |chi| sat inside that error and its
  outcome turned on the host's instruction set); iso: rtol 1e-5;
- distances of the distance grid: atol 2e-4 (float32 |g|^2 + |p|^2 -
  2 g.p cancels near the points; measured 8.9e-5 on the sphere), argmin
  equal where the second-nearest point is more than 1e-3 farther;
- meshes on `tests/test_implicit.py`'s sphere (1,500 points): vertex and
  face counts within 1%, symmetric mean Chamfer distance under 0.01
  voxel;
- FPS indices: equal; ICP R and t: atol 1e-5; merged points atol 1e-5;
- the pipeline on `tests/test_torch_dense.py`'s folder (3 views of
  96x128, 16 disparities, meshes at 32) against the reference's
  single-device branch: the same mesh method used, cloud points within
  0.5%, faces within max(2, 2%) (the clouds may differ by a few points
  at the stereo stage's float noise, and each point moves the splat), vertex
  Chamfer under 0.1 voxel; `run_multi_reference` (2 reference views):
  the same views and method, per-reference and merged points within
  0.5%, faces within max(2, 2%).
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

from tpu3drec.ops import implicit as jimp
from tpu3drec.ops import mesh as jmesh
from tpu3drec.ops import pointcloud as jpc
from tpu3drec.pipelines.dense import DenseReconstructionPipeline as JPipe
from tpu3drec_torch.ops import implicit as timp
from tpu3drec_torch.ops import mesh as tmesh
from tpu3drec_torch.ops import pointcloud as tpc
from tpu3drec_torch.pipelines.dense import DenseReconstructionPipeline

from test_torch_dense import PIPE_KW, _folder

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import chamfer  # noqa: E402  (symmetric mean vertex distance)


def _t(a):
    return torch.from_numpy(np.array(a))


def _counts_close(got, ref, rtol):
    return abs(len(got) - len(ref)) <= rtol * len(ref)


@pytest.fixture(scope="module")
def sphere():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(1500, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32), v.astype(np.float32)  # points, normals


# the meshers at tests/test_implicit.py's settings
MESHERS = {
    "poisson": (lambda m, p, n, **k: m.poisson_mesh(p, n, resolution=56, **k)),
    "poisson_estimated_normals": (
        lambda m, p, n, **k: m.poisson_mesh(p, None, resolution=48, **k)),
    "alpha": (lambda m, p, n, **k: m.alpha_surface_mesh(p, alpha=0.15,
                                                        resolution=48, **k)),
    "ball_pivot": (lambda m, p, n, **k: m.ball_pivot_mesh(
        p, n, radius=0.15, resolution=48, **k)),
}


@pytest.fixture(scope="module")
def meshes(sphere):
    """Each mesher through both packages, once."""
    pts, nrm = sphere
    return {k: (f(jimp, pts, nrm), f(timp, pts, nrm, device="cpu"))
            for k, f in MESHERS.items()}


# ---------------------------------------------------------------------
# ops/implicit.py
# ---------------------------------------------------------------------

def test_grid_setup_dilation_and_spacing_match_jax(sphere):
    pts, _ = sphere
    for res, pad in ((56, 6.5), (96, 2.0), (20, 9.0)):
        a, b = timp._grid_setup(pts, res, pad), jimp._grid_setup(pts, res, pad)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
    m = np.random.default_rng(1).uniform(size=(9, 11, 7)) > 0.93
    for r in (0, 1, 3):
        np.testing.assert_array_equal(timp._dilate_mask(m, r),
                                      jimp._dilate_mask(m, r))
    assert timp._median_nn_spacing(pts) == jimp._median_nn_spacing(pts)


def _fft_gap_bound(V, voxel, sigma, screen):
    """How far two float32 implementations of the spectral solve may
    part, to first order: one FFT's rounding leaves each frequency within
    log2(n) eps32 sum|V| of the exact transform (each output sums n
    inputs over log2(n) stages); the solve multiplies frequency k by
    |T_k| (|dx| + |dy| + |dz|) (Gaussian over the screened Laplacian,
    times the central-difference derivatives) and the inverse transform
    averages over the n frequencies; twice that for two implementations."""
    n = V.shape[0] * V.shape[1] * V.shape[2]
    K = np.meshgrid(*(2 * np.pi * np.fft.fftfreq(m) for m in V.shape[:3]),
                    indexing="ij")
    h = float(np.float32(voxel))
    deriv = sum(np.abs(np.sin(k)) for k in K) / h
    lam = sum(2 * np.cos(k) - 2 for k in K) / (h * h) - screen
    gauss = np.exp(-0.5 * sigma * sigma * sum(k * k for k in K))
    T = np.where(np.abs(lam) < 1e-12, 0.0,
                 gauss / np.where(np.abs(lam) < 1e-12, 1.0, np.abs(lam)))
    return 2 * np.log2(n) * 2.0 ** -24 * np.abs(V).sum() * np.mean(T * deriv)


def test_splat_and_spectral_solve_match_jax(sphere):
    pts, nrm = sphere
    origin, voxel, dims = jimp._grid_setup(pts, 40, 6.5)
    mask = np.ones(len(pts), bool)
    mask[::7] = False
    jV, jd = jimp.splat_oriented_points(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(mask),
        jnp.asarray(origin), jnp.float32(voxel), dims)
    V, d = timp.splat_oriented_points(_t(pts), _t(nrm), _t(mask), _t(origin),
                                      voxel, dims)
    assert V.shape == (*dims, 3) and d.shape == dims
    np.testing.assert_allclose(V.numpy(), np.asarray(jV), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    # the same V into both solvers (screened and not)
    for screen in (0.0, 0.5):
        jchi = np.asarray(jimp.solve_poisson_spectral(
            jV, jnp.float32(voxel), jnp.float32(1.5), jnp.float32(screen)))
        chi = timp.solve_poisson_spectral(_t(np.asarray(jV)), voxel, 1.5,
                                          screen).numpy()
        assert chi.dtype == np.float32
        bound = _fft_gap_bound(np.asarray(jV), voxel, 1.5, screen)
        assert bound < 1e-3 * np.abs(jchi).max()
        np.testing.assert_allclose(chi, jchi, rtol=0, atol=bound)
    js, jc = jimp._sample_trilinear(jnp.asarray(jchi), jnp.asarray(pts * 1.3),
                                    jnp.asarray(mask), jnp.asarray(origin),
                                    jnp.float32(voxel))
    s, c = timp._sample_trilinear(_t(jchi), _t(pts * 1.3), _t(mask),
                                  _t(origin), voxel)
    np.testing.assert_allclose(float(s), float(js), rtol=1e-5)
    assert float(c) == float(jc)


def test_distance_grid_matches_jax():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    mask = rng.uniform(size=700) > 0.2
    origin = np.array([-1.2, -1.1, -1.3], np.float32)
    dims, voxel = (23, 19, 26), 0.1
    jd, ja = jimp.distance_grid(jnp.asarray(pts), jnp.asarray(mask),
                                jnp.asarray(origin), jnp.float32(voxel),
                                dims, chunk=1024)
    d, a = timp.distance_grid(_t(pts), _t(mask), _t(origin), voxel, dims,
                              chunk=1000)
    jd, ja = np.asarray(jd), np.asarray(ja)
    assert a.dtype == torch.int32 and d.shape == dims
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=2e-4)
    assert mask[a.numpy()].all()
    # argmin where the nearest point is clear of the second nearest
    ax = [np.arange(k) * np.float32(voxel) for k in dims]
    g = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, 3) + origin
    dd = np.linalg.norm(g[:, None] - pts[mask][None], axis=-1)
    two = np.sort(dd, 1)[:, :2]
    clear = (two[:, 1] - two[:, 0] > 1e-3).reshape(dims)
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(a.numpy()[clear], ja[clear])


def test_uob_field_uses_the_real_points(sphere):
    """The reference pads to 1024-point capacity with masked rows; the
    port takes the real count: the same field either way."""
    pts, nrm = sphere
    jf = jimp._uob_field(pts, 0.15, 24, max_points=1000, aux=nrm)
    tf = timp._uob_field(pts, 0.15, 24, max_points=1000, aux=nrm,
                         device="cpu")
    np.testing.assert_allclose(tf[0], jf[0], rtol=0, atol=2e-4)
    for a, b in zip(tf[2:], jf[2:]):
        np.testing.assert_array_equal(a, b)      # origin, voxel, subsample


@pytest.mark.parametrize("name", list(MESHERS))
def test_implicit_meshes_match_jax(meshes, name):
    ref, got = meshes[name]
    assert _counts_close(got["verts"], ref["verts"], 0.01)
    assert _counts_close(got["faces"], ref["faces"], 0.01)
    assert got["faces"].dtype == ref["faces"].dtype
    assert chamfer(got["verts"], ref["verts"]) < 0.01 * ref["voxel"]
    np.testing.assert_array_equal(got["origin"], ref["origin"])
    assert got["voxel"] == ref["voxel"]
    if "chi" in ref:
        np.testing.assert_allclose(got["chi"], ref["chi"], rtol=0,
                                   atol=1e-6 * np.abs(ref["chi"]).max())
        np.testing.assert_allclose(got["density"], ref["density"],
                                   rtol=1e-6, atol=1e-6)
        assert abs(got["iso"] - ref["iso"]) <= 1e-5 * abs(ref["iso"])
    else:
        np.testing.assert_allclose(got["distance"], ref["distance"], rtol=0,
                                   atol=2e-4)


def test_mesh_wrappers_match_the_meshers(sphere, meshes):
    pts, nrm = sphere
    for fn, kw, name in [
            (tmesh.create_mesh_poisson, dict(normals=nrm, resolution=56),
             "poisson"),
            (tmesh.create_mesh_ball_pivoting,
             dict(normals=nrm, radius=0.15, resolution=48), "ball_pivot"),
            (tmesh.create_mesh_alpha_shape, dict(alpha=0.15, resolution=48),
             "alpha")]:
        v, f = fn(pts, device="cpu", **kw)
        np.testing.assert_array_equal(v, meshes[name][1]["verts"])
        np.testing.assert_array_equal(f, meshes[name][1]["faces"])


HOST_ENTRIES = {
    "poisson_mesh": lambda p: timp.poisson_mesh(p, p),
    "alpha_surface_mesh": lambda p: timp.alpha_surface_mesh(p, 0.2),
    "ball_pivot_mesh": lambda p: timp.ball_pivot_mesh(p, p, radius=0.2),
    "create_mesh_poisson": lambda p: tmesh.create_mesh_poisson(p, p),
    "create_mesh_ball_pivoting": lambda p: tmesh.create_mesh_ball_pivoting(
        p, p, radius=0.2),
    "create_mesh_alpha_shape": lambda p: tmesh.create_mesh_alpha_shape(p, 0.2),
    "merge_point_clouds": lambda p: tpc.merge_point_clouds(
        [(p, None), (p, None)]),
    "DenseReconstructionPipeline(mesh_method='poisson')":
        lambda p: DenseReconstructionPipeline(mesh_method="poisson"),
}


@pytest.mark.parametrize("entry", list(HOST_ENTRIES))
def test_host_array_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means it")
    pts = np.random.default_rng(3).normal(size=(64, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        HOST_ENTRIES[entry](pts)


# ---------------------------------------------------------------------
# ops/pointcloud.py: FPS, ICP, merging
# ---------------------------------------------------------------------

def test_farthest_point_downsample_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 1, (1000, 3)).astype(np.float32)
    mask = rng.uniform(size=1000) > 0.3
    mask[:5] = False           # the first valid point is not row 0
    for m in (1, 50, 200):
        ref = np.asarray(jpc.farthest_point_downsample(
            jnp.asarray(pts), jnp.asarray(mask), m))
        got = tpc.farthest_point_downsample(_t(pts), _t(mask), m).numpy()
        np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got)) == 200 and mask[got].all()


def _misaligned_surface(n, seed):
    import cv2
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    base[:, 2] = 0.3 * np.sin(2 * base[:, 0]) + 0.2 * base[:, 1] ** 2
    R = cv2.Rodrigues(np.array([0.02, -0.03, 0.015]))[0].astype(np.float32)
    t = np.array([0.04, -0.03, 0.05], np.float32)
    return base, base @ R.T + t


def test_icp_register_matches_jax():
    src, dst = _misaligned_surface(400, 5)
    sm = np.ones(400, bool)
    dm = np.random.default_rng(6).uniform(size=400) > 0.1
    for mcd in (0.5, 0.05):
        jR, jt = jpc.icp_register(jnp.asarray(src), jnp.asarray(dst),
                                  jnp.asarray(sm), jnp.asarray(dm),
                                  max_corr_dist=mcd)
        R, t = tpc.icp_register(_t(src), _t(dst), _t(sm), _t(dm),
                                max_corr_dist=mcd)
        np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-5)
    moved = src @ R.numpy().T + t.numpy()
    assert np.median(np.linalg.norm(moved - dst, axis=1)) < 0.01


def test_icp_step_given_correspondences_and_replay():
    """`_icp_step` given its own correspondences repeats its step bit for
    bit, given others it takes theirs, and 20 steps from the identity are
    `icp_register` bit for bit (chip_smoke.icp_check replays ICP so)."""
    src, dst = (_t(a) for a in _misaligned_surface(400, 5))
    sm = torch.ones(400, dtype=torch.bool)
    dst2 = torch.sum(dst * dst, 1)
    R, t = torch.eye(3), torch.zeros(3)
    first = tpc._icp_step(src, dst, sm, sm, dst2, R, t, 0.5)
    for _ in range(20):
        Rn, tn, (j, w) = tpc._icp_step(src, dst, sm, sm, dst2, R, t, 0.5)
        Rc, tc, corr = tpc._icp_step(src, dst, sm, sm, dst2, R, t, 0.5,
                                     corr=(j, w))
        assert torch.equal(Rc, Rn) and torch.equal(tc, tn)
        assert corr[0] is j and corr[1] is w
        R, t = Rn, tn
    Rr, tr = tpc.icp_register(src, dst, sm, sm, max_corr_dist=0.5)
    assert torch.equal(R, Rr) and torch.equal(t, tr)
    (R1, t1, (j1, w1)) = first
    Rs, ts, _ = tpc._icp_step(src, dst, sm, sm, dst2, torch.eye(3),
                              torch.zeros(3), 0.5,
                              corr=(torch.roll(j1, 1), w1))
    assert not torch.allclose(Rs @ src[0] + ts, R1 @ src[0] + t1, atol=1e-4)


@pytest.mark.parametrize("registration", ["icp", "none"])
def test_merge_point_clouds_matches_jax(registration):
    base, second = _misaligned_surface(5000, 7)
    third = base[:900] + np.float32(0.01)
    colors = np.tile(np.float32([[1.0, 0.0, 0.0]]), (5000, 1))
    clouds = [(base, colors), (np.zeros((0, 3), np.float32), None),
              (second, colors), (third, None)]
    jp, jc = jpc.merge_point_clouds(clouds, registration=registration)
    tp, tc = tpc.merge_point_clouds(clouds, registration=registration,
                                    device="cpu")
    assert tp.shape == jp.shape == (10900, 3) and tp.dtype == jp.dtype
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tc, jc)
    err = np.median(np.linalg.norm(tp[5000:10000] - base, axis=1))
    assert (err < 0.01) == (registration == "icp")


# ---------------------------------------------------------------------
# ops/mesh.py
# ---------------------------------------------------------------------

def test_simplify_and_compare_meshes_match_jax(meshes):
    ref = meshes["poisson_estimated_normals"][0]
    v, f = ref["verts"], ref["faces"]
    for target in (len(f), len(f) // 4, 200, 0):
        a, b = tmesh.simplify_mesh(v, f, target), jmesh.simplify_mesh(v, f,
                                                                      target)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    sv, sf = tmesh.simplify_mesh(v, f, len(f) // 4)
    assert 0 < len(sf) <= len(f) // 4
    bv, bf = meshes["ball_pivot"][0]["verts"], meshes["ball_pivot"][0]["faces"]
    for args in ((v, f, v, f), (v, f, sv, sf), (v, f, bv, bf),
                 (v, f, np.zeros((0, 3)), np.zeros((0, 3), int)),
                 (None, f, v, f)):
        assert tmesh.compare_meshes(*args) == jmesh.compare_meshes(*args)


# ---------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------

PIPE_METHODS = ("poisson", "ball_pivot", "alpha")


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    """Each implicit mesh method and multi-reference mode through both
    packages' pipelines on the 3-view folder, once."""
    sparse, images = _folder()
    out = {}
    for m in PIPE_METHODS:
        jp = JPipe(use_sharded_stereo=False, mesh_method=m, **PIPE_KW)
        jres = jp.run_complete_pipeline(sparse, images)
        tp = DenseReconstructionPipeline(mesh_method=m, device="cpu",
                                         **PIPE_KW)
        tres = tp.run_complete_pipeline(sparse, images)
        out[m] = (jres, jp._arrays, tres, tp._arrays)
    jp = JPipe(use_sharded_stereo=False, mesh_method="poisson", **PIPE_KW)
    tp = DenseReconstructionPipeline(mesh_method="poisson", device="cpu",
                                     **PIPE_KW)
    multi_dir = tmp_path_factory.mktemp("multi")
    out["multi_reference"] = (
        jp.run_multi_reference(sparse, images, num_refs=2), jp._arrays,
        tp.run_multi_reference(sparse, images, num_refs=2,
                               output_dir=multi_dir), tp._arrays, multi_dir)
    return out


# faces within max(2, 2%): the plane folder's cloud is exactly planar,
# where ball pivoting's signed distance is zero on whole grid layers and
# both packages extract only a few faces
FACE_BAR = dict(poisson=100, alpha=100, ball_pivot=1)


def _faces_close(tf, jf):
    return abs(tf - jf) <= max(2, 0.02 * jf)


@pytest.mark.parametrize("method", PIPE_METHODS)
def test_pipeline_mesh_methods_match_jax(pipeline_runs, method):
    jres, jarr, tres, tarr = pipeline_runs[method]
    assert tres["mesh"]["method"] == jres["mesh"]["method"] == method
    jn, tn = jres["point_cloud"]["num_points"], tres["point_cloud"]["num_points"]
    assert abs(tn - jn) <= 0.005 * jn
    jf, tf = jres["mesh"]["num_faces"], tres["mesh"]["num_faces"]
    assert jf >= FACE_BAR[method] and _faces_close(tf, jf)
    voxel = (jarr["points"].max(0) - jarr["points"].min(0)).max() / 32
    assert chamfer(tarr["vertices"], jarr["vertices"]) < 0.1 * voxel
    assert set(tres) == set(jres)


def test_multi_reference_matches_jax(pipeline_runs):
    jres, jarr, tres, tarr, out = pipeline_runs["multi_reference"]
    assert tres["mode"] == jres["mode"] == "multi_reference"
    assert tres["reference_views"] == jres["reference_views"] \
        == ["v0.png", "v2.png"]
    assert tres["mesh"]["method"] == jres["mesh"]["method"] == "poisson"
    for ref, pv in jres["per_reference"].items():
        tv = tres["per_reference"][ref]
        assert abs(tv["num_points"] - pv["num_points"]) <= \
            0.005 * pv["num_points"]
        assert abs(tv["valid_fraction"] - pv["valid_fraction"]) < 1e-3
    jn, tn = jres["point_cloud"]["num_points"], tres["point_cloud"]["num_points"]
    assert abs(tn - jn) <= 0.005 * jn
    jf, tf = jres["mesh"]["num_faces"], tres["mesh"]["num_faces"]
    assert jf > 100 and _faces_close(tf, jf)
    assert set(tres) == set(jres) | {"output_dir"}
    assert set(tarr) == set(jarr)
    for f in ("point_cloud_merged.ply", "mesh_merged.obj",
              "dense_report.json"):
        assert (out / f).exists(), f


def _raise(exc):
    def fn(*a, **k):
        raise exc
    return fn


def test_a_device_fault_in_the_implicit_branch_propagates(monkeypatch):
    """A RuntimeError (a CUDA or kernel fault) is never a degraded mode,
    in either mode."""
    sparse, images = _folder()
    monkeypatch.setattr(tmesh, "create_mesh_poisson",
                        _raise(RuntimeError("CUDA error: an illegal memory "
                                            "access was encountered")))
    pipe = DenseReconstructionPipeline(mesh_method="poisson", device="cpu",
                                       **PIPE_KW)
    with pytest.raises(RuntimeError, match="illegal memory"):
        pipe.run_complete_pipeline(sparse, images)
    with pytest.raises(RuntimeError, match="illegal memory"):
        pipe.run_multi_reference(sparse, images, num_refs=2)


@pytest.mark.parametrize("fault", ["empty_mesh", "value_error", "index_error"])
def test_a_degenerate_cloud_degrades_like_the_reference(monkeypatch, fault):
    """An empty mesh, or what numpy raises on too few points, yields the
    depth-grid mesh, as in the reference; in multi-reference mode (run
    once) the merged cloud's mesh falls back to Delaunay."""
    sparse, images = _folder()
    fn = {"empty_mesh": lambda *a, **k: (np.zeros((0, 3), np.float32),
                                         np.zeros((0, 3), np.int64)),
          "value_error": _raise(ValueError("zero-size array")),
          "index_error": _raise(IndexError("index 0 is out of bounds"))}[fault]
    monkeypatch.setattr(tmesh, "create_mesh_ball_pivoting", fn)
    pipe = DenseReconstructionPipeline(mesh_method="ball_pivot", device="cpu",
                                       **PIPE_KW)
    res = pipe.run_complete_pipeline(sparse, images)
    assert res["mesh"]["method"] == "depth_grid"
    assert res["mesh"]["num_faces"] > 100
    if fault == "value_error":
        multi = pipe.run_multi_reference(sparse, images, num_refs=2)
        assert multi["mesh"]["method"] == "delaunay"
        assert multi["mesh"]["num_faces"] > 100


def test_too_few_points_degrade_to_the_depth_grid():
    """No points at all: numpy's empty reductions raise ValueError inside
    the meshers, which the branch turns into an empty mesh (and so the
    depth-grid mesh)."""
    pipe = DenseReconstructionPipeline(mesh_method="alpha", device="cpu")
    v, f = pipe._implicit_mesh(np.zeros((0, 3), np.float32),
                               np.zeros((0, 3), np.float32))
    assert v.shape == (0, 3) and f.shape == (0, 3)
    with pytest.raises(ValueError):
        timp.poisson_mesh(np.zeros((0, 3), np.float32),
                          np.zeros((0, 3), np.float32), device="cpu")
