"""Parity of the port's plane-sweep stereo (`plane_sweep_depth`, its
blockwise form, `box_blur`, `_sweep_validity`, the plane inverse depths)
with the JAX package on the CPU.

Same numpy inputs through both packages, on `tests/test_plane_sweep.py`'s
scenes (96x128 with 48 planes, 48x64 with 24, and its textureless
64x96). Tolerances:
- the plane inverse depths: bit-equal to the reference's `jnp.linspace`;
- valid masks: equal on >= 99.9% of pixels (the homographies are 3x3
  float32 products and inverses on two LAPACK builds, so the sample
  positions, and with them a near-tie of two planes, may move by an ulp);
- depth where both are valid: rtol 1e-5; fractional plane index: atol
  2e-3, the reference test's own bar for its parabola (on the noise
  pair the blockwise parabola's small denominators turn an ulp of cost
  into up to 3.6e-4 of plane index);
- `box_blur`: rtol / atol 1e-6 (convolutions summing in another order);
  `_sweep_validity` on the same volumes: equal.
The port's depth is also held to the reference test's own bars (valid
share > 0.3, median relative error < 0.08 inside the border).
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

from tpu3drec.ops import stereo as jst
from tpu3drec_torch.ops import stereo as tst

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import sweep_scene  # noqa: E402


def _scene_two_depths():
    """tests/test_plane_sweep.py:test_plane_sweep_recovers_depth's pair:
    a smoothed texture at depths 8 and 4, pure x-translation (chip_smoke.py
    draws it at full size)."""
    ref, other, K, R, t, depth = sweep_scene(96, 128, 100.0, 0.4)
    return dict(ref=ref, other=other, K=K, R=R, t=t, planes=48, depth=depth)


def _scene_random():
    """test_blockwise_plane_sweep_matches_full_wta's pair: two noise
    images, a small off-axis translation."""
    rng = np.random.default_rng(1)
    H, W = 48, 64
    f = 60.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return dict(ref=rng.uniform(0, 1, (H, W)).astype(np.float32),
                other=rng.uniform(0, 1, (H, W)).astype(np.float32), K=K,
                R=np.eye(3, dtype=np.float32),
                t=np.array([-0.4, 0.02, 0.01], np.float32), planes=24)


SCENES = {"two_depths_96x128": _scene_two_depths(),
          "random_48x64": _scene_random()}
VARIANTS = ("full", "blockwise")


def _run(pkg, variant, sc):
    mod = jst if pkg == "jax" else tst
    fn = (mod.plane_sweep_depth if variant == "full"
          else mod.plane_sweep_depth_blockwise)
    kw = {} if variant == "full" else {"slab": 8}
    if pkg == "jax":
        args = [jnp.asarray(sc[k]) for k in ("ref", "other", "K", "K", "R",
                                             "t")]
    else:
        args = [torch.from_numpy(sc["ref"]), torch.from_numpy(sc["other"]),
                sc["K"], sc["K"], sc["R"], sc["t"]]
    res = fn(*args, min_depth=2.0, max_depth=16.0,
             num_planes=sc["planes"], **kw)
    return tuple(np.asarray(a) for a in res)


@pytest.fixture(scope="module")
def sweeps():
    """Each (scene, variant) through both packages, once."""
    return {(s, v): (_run("jax", v, sc), _run("torch", v, sc))
            for s, sc in SCENES.items() for v in VARIANTS}


@pytest.mark.parametrize("n", [2, 24, 34, 35, 48, 64, 128])
@pytest.mark.parametrize("depths", [(2.0, 16.0), (0.7, 23.3), (1.3, 97.0)])
def test_plane_inv_depths_equal_the_reference_linspace(n, depths):
    # as plane_sweep_depth traces it: 1 / depth in float32, then linspace;
    # 34 planes is the last count XLA:CPU unrolls, 35 the first it does not
    ref = jax.jit(lambda a, b: jnp.linspace(1.0 / a, 1.0 / b, n))(*depths)
    got = tst.plane_inv_depths(*depths, n)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("scene", list(SCENES))
def test_plane_sweep_matches_jax(sweeps, scene, variant):
    (jd, jdepth, jv), (td, tdepth, tv) = sweeps[(scene, variant)]
    assert tv.dtype == bool and tdepth.shape == jdepth.shape
    assert (jv == tv).mean() >= 0.999
    both = jv & tv
    np.testing.assert_allclose(tdepth[both], jdepth[both], rtol=1e-5)
    assert (tdepth[~tv] == 0).all()
    np.testing.assert_allclose(td, jd, rtol=0, atol=2e-3)


@pytest.mark.parametrize("variant", VARIANTS)
def test_plane_sweep_recovers_depth_like_the_reference_test(sweeps, variant):
    sc = SCENES["two_depths_96x128"]
    _, (_, d, v) = sweeps[("two_depths_96x128", variant)]
    interior = np.zeros_like(v)
    interior[8:-8, 16:-8] = True
    m = v & interior
    assert m.mean() > 0.3
    rel_err = np.abs(d - sc["depth"])[m] / sc["depth"][m]
    assert np.median(rel_err) < 0.08, np.median(rel_err)


@pytest.mark.parametrize("variant", VARIANTS)
def test_textureless_scene_collapses_validity(variant):
    H, W = 64, 96
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)
    flat = torch.full((H, W), 0.5)
    fn = (tst.plane_sweep_depth if variant == "full"
          else tst.plane_sweep_depth_blockwise)
    res = fn(flat, flat, K, K, np.eye(3, dtype=np.float32),
             np.array([-0.4, 0, 0], np.float32), 2.0, 16.0, num_planes=24)
    assert res.valid.float().mean() < 0.05


def test_blockwise_needs_whole_slabs():
    sc = SCENES["random_48x64"]
    with pytest.raises(ValueError, match="multiple of slab"):
        tst.plane_sweep_depth_blockwise(
            torch.from_numpy(sc["ref"]), torch.from_numpy(sc["other"]),
            sc["K"], sc["K"], sc["R"], sc["t"], 2.0, 16.0, num_planes=20,
            slab=8)


@pytest.mark.parametrize("size", [1, 3, 5])
def test_box_blur_matches_jax(size):
    img = np.random.default_rng(2).uniform(0, 1, (3, 40, 56)).astype(
        np.float32)
    ref = np.stack([np.asarray(jst.box_blur(jnp.asarray(im), size))
                    for im in img])
    got = tst.box_blur(torch.from_numpy(img), size).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_validity_matches_jax(seed):
    rng = np.random.default_rng(seed)
    raw = rng.uniform(0, 0.3, (12, 24, 32)).astype(np.float32)
    agg = rng.uniform(0, 2, (12, 24, 32)).astype(np.float32)
    agg[3, :8] = 0.05      # clear winners
    agg[:, 20:] = 0.5      # ties: a flat volume
    ref = np.asarray(jst._sweep_validity(jnp.asarray(raw), jnp.asarray(agg),
                                         0.15, 10.0))
    got = tst._sweep_validity(torch.from_numpy(raw), torch.from_numpy(agg),
                              0.15, 10.0).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref.mean() < 1
