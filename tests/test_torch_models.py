"""Parity of the port's deep models (tpu3drec_torch.models) with the JAX
package's, on random parameters carried across with `models._params`.

Shapes are those of the JAX package's own tests: SuperPoint's network at
120x160 (tests/test_models.py; the extracted image is 117x157, padded to
it), DISK at 64x80 (tests/test_disk_parity.py; extracted from 60x76),
the ALIKED approximation at 96x128 (tests/test_disk_aliked.py),
ALIKED-n16 at 64x96 (tests/test_aliked_n16_parity.py; extracted from
60x90), LightGlue at D = 64, 4 heads, 2 layers with padding masks
(tests/test_lightglue_parity.py). Each model's reference runs once per
module: one jitted program for its dense outputs and its extraction.

Parameters come from the JAX modules' `init_random`; ALIKED-n16 has none,
so a seeded numpy state dict in the published order goes through both
packages' order-based `load_torch_weights`. The JAX side extracts through
its registry entry (`detect_*_features`, `match_features_lightglue`)
reading the npz the port wrote, so every extraction also holds the
checkpoint round trip; the other direction (the JAX converters' npz read
by the port) is held on SuperPoint and LightGlue.

Bars. Both packages compute in float32 and sum convolutions and products
in different orders, so dense values are held at a few hundred ulps of
their scale (the observed gaps are 7-200x below each bar). Keypoints are
compared slot by slot except among scores closer than that bar (a near
tie may order either way; exact ties, the zero and -inf peaks, go by
index in both, so invalid slots agree too); LightGlue's log-assignment
at tests/test_lightglue_parity.py's 5e-4 / 1e-3.
"""

import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_aliked_n16_parity import TorchALIKED  # noqa: E402
from test_lightglue_parity import TorchLG       # noqa: E402

import tpu3drec.models as jmodels                          # noqa: E402
from tpu3drec.core.types import Features as JFeatures      # noqa: E402
from tpu3drec.models import aliked as jal                  # noqa: E402
from tpu3drec.models import aliked_n16 as jn16             # noqa: E402
from tpu3drec.models import disk as jdk                    # noqa: E402
from tpu3drec.models import lightglue as jlg               # noqa: E402
from tpu3drec.models import superpoint as jsp              # noqa: E402
from tpu3drec.ops.match import match_features as jmatch    # noqa: E402
import tpu3drec_torch as tv                                # noqa: E402
import tpu3drec_torch.models as tmodels                    # noqa: E402
from tpu3drec_torch.core.registry import MatcherFactory   # noqa: E402
from tpu3drec_torch.core.types import Features as TFeatures  # noqa: E402
from tpu3drec_torch.models import _common, _params         # noqa: E402
from tpu3drec_torch.models import aliked as tal            # noqa: E402
from tpu3drec_torch.models import aliked_n16 as tn16       # noqa: E402
from tpu3drec_torch.models import disk as tdk              # noqa: E402
from tpu3drec_torch.models import lightglue as tlg         # noqa: E402
from tpu3drec_torch.models import superpoint as tsp        # noqa: E402
from tpu3drec_torch.ops.match import match_features as tmatch  # noqa: E402


def _image(h, w, seed, n=40):
    """Rectangles on black, normalised to [0, 1] (the JAX tests' images)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for _ in range(n):
        y, x = rng.integers(0, h - 12), rng.integers(0, w - 12)
        img[y:y + rng.integers(3, 12), x:x + rng.integers(3, 12)] += \
            rng.uniform(-0.5, 0.5)
    img -= img.min()
    return img / img.max()


@contextlib.contextmanager
def weights_in(path):
    """Both packages read their weights from `path`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodels, "WEIGHTS_DIR", path)
        mp.setattr(tmodels, "WEIGHTS_DIR", path)
        jlg._LG_CACHE.clear()
        tlg._LG_CACHE.clear()
        yield
    jlg._LG_CACHE.clear()
    tlg._LG_CACHE.clear()


def _np(f):
    return {k: np.asarray(getattr(f, k)) if not isinstance(getattr(f, k),
                                                           torch.Tensor)
            else getattr(f, k).numpy()
            for k in ("xy", "response", "scale", "desc", "mask")}


def near_ties(scores, bar):
    """Slots whose score is within `bar` of a neighbour's without being
    equal to it: their order may differ between two float32 runs."""
    with np.errstate(invalid="ignore"):
        d = np.abs(np.diff(scores.astype(np.float64)))
        close = (d < bar) & (d > 0)
    out = np.zeros(len(scores), bool)
    out[:-1] |= close
    out[1:] |= close
    return out


def assert_same_features(t, j, score_bar, xy_atol=0.0, desc_atol=1e-6):
    """Slot by slot away from near ties: mask and position (within
    `xy_atol`; 0 for integer positions), response within `score_bar`,
    descriptors within `desc_atol`."""
    t, j = _np(t), _np(j)
    keep = ~near_ties(j["response"], score_bar)
    assert keep.mean() > 0.9
    np.testing.assert_array_equal(t["mask"][keep], j["mask"][keep])
    np.testing.assert_allclose(t["xy"][keep], j["xy"][keep], rtol=0,
                               atol=xy_atol)
    np.testing.assert_allclose(t["response"], j["response"], rtol=0,
                               atol=score_bar)
    np.testing.assert_array_equal(t["scale"], j["scale"])
    m = keep & j["mask"]
    assert m.sum() > 20
    np.testing.assert_allclose(t["desc"][m], j["desc"][m], rtol=0,
                               atol=desc_atol)
    np.testing.assert_array_equal(t["desc"][~t["mask"]], 0)


# ---- SuperPoint ------------------------------------------------------------

SP_SHAPE = (117, 157)          # the network sees it padded to 120x160


@pytest.fixture(scope="module")
def superpoint(tmp_path_factory):
    img = _image(*SP_SHAPE, seed=0, n=60)
    ref = jsp.SuperPoint(max_features=256, matmul_precision="highest")
    params = ref.init_random((120, 160), seed=0)
    net = _params.load_tree(tsp.SuperPointNet(), params["params"]).eval()
    wd = tmp_path_factory.mktemp("sp_weights")
    tsp.save_weights(net, wd / "superpoint.npz")
    x = np.pad(img, ((0, 3), (0, 3)))[None, :, :, None]

    @jax.jit
    def run(im, x):
        return (ref._forward(params, x),
                jsp.detect_superpoint_features(im, max_features=256))
    with weights_in(wd):
        dense, feats = run(jnp.asarray(img), jnp.asarray(x))
    return dict(img=img, x=x, net=net, params=params, wd=wd,
                dense=jax.tree.map(np.asarray, dense), feats=feats)


def test_superpoint_dense_matches_jax(superpoint):
    sp = tsp.SuperPoint(superpoint["net"], matmul_precision="highest")
    heat, desc = sp.dense(torch.from_numpy(superpoint["x"]))
    jheat, jdesc = superpoint["dense"]
    assert heat.shape == jheat.shape == (1, 120, 160)
    assert desc.shape == jdesc.shape == (1, 15, 20, 256)
    # heat <= 1 (a softmax); desc unit vectors
    np.testing.assert_allclose(heat.numpy(), jheat, rtol=0, atol=1e-7)
    np.testing.assert_allclose(desc.numpy(), jdesc, rtol=0, atol=2e-6)


def test_superpoint_extract_matches_jax(superpoint):
    f = tsp.SuperPoint(superpoint["net"], max_features=256).extract(
        torch.from_numpy(superpoint["img"]))
    jf = superpoint["feats"]
    assert f.method == jf.method == "SuperPoint"
    assert f.image_shape == tuple(jf.image_shape) == SP_SHAPE
    assert 0 < int(f.mask.sum()) < 256     # the 0.005 threshold bites
    assert_same_features(f, jf, score_bar=1e-7, desc_atol=2e-6)


def test_superpoint_batch_equals_single_images(superpoint):
    sp = tsp.SuperPoint(superpoint["net"], max_features=256)
    imgs = np.stack([superpoint["img"], _image(*SP_SHAPE, seed=5)])
    fb = sp.extract(torch.from_numpy(imgs))
    assert fb.xy.shape == (2, 256, 2)
    for i in range(2):
        fi = sp.extract(torch.from_numpy(imgs[i]))
        for k in ("xy", "response", "desc", "mask"):
            torch.testing.assert_close(getattr(fb, k)[i], getattr(fi, k),
                                       rtol=0, atol=1e-6)


def test_superpoint_checkpoint_written_by_jax_reads_in_the_port(
        superpoint, tmp_path):
    """The port's SuperPointNet carries the published names, so its own
    state dict is a checkpoint the JAX converter takes."""
    pth = tmp_path / "superpoint_v1.pth"
    torch.save(superpoint["net"].state_dict(), pth)
    wd = tmp_path / "weights"
    with weights_in(wd):
        jsp.convert_torch_checkpoint(pth)
        assert sorted(tv.api._get_detector_registry()) == sorted(
            set(tv.api._DETECTORS) | {"SuperPoint"})
        f = tv.detect_features(superpoint["img"], "SuperPoint",
                               max_features=256, device="cpu")
    ref = tsp.SuperPoint(superpoint["net"], max_features=256).extract(
        torch.from_numpy(superpoint["img"]))
    for k in ("xy", "response", "desc", "mask"):
        torch.testing.assert_close(getattr(f, k), getattr(ref, k), rtol=0,
                                   atol=0)


# ---- DISK ------------------------------------------------------------------

DISK_SHAPE = (60, 76)          # padded to 64x80


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    img = _image(*DISK_SHAPE, seed=1, n=25)
    ref = jdk.DISK(max_features=128)
    params = ref.init_random((64, 80), seed=0)
    net = _params.load_tree(tdk.DISKNet(), params["params"]).eval()
    wd = tmp_path_factory.mktemp("disk_weights")
    tdk.save_weights(net, wd / "disk.npz")
    x = np.repeat(np.pad(img, ((0, 4), (0, 4)))[None, :, :, None], 3, -1)

    @jax.jit
    def run(im, x):
        return (ref.net.apply(params, x),
                jdk.detect_disk_features(im, max_features=128))
    with weights_in(wd):
        dense, feats = run(jnp.asarray(img), jnp.asarray(x))
    return dict(img=img, x=x, net=net, dense=jax.tree.map(np.asarray, dense),
                feats=feats)


def test_disk_dense_matches_jax(disk):
    heat, desc = tdk.DISK(disk["net"], matmul_precision="highest").dense(
        torch.from_numpy(disk["x"]))
    jheat, jdesc = disk["dense"]
    assert heat.shape == (1, 64, 80) and desc.shape == (1, 64, 80, 128)
    # nine instance norms deep: the heat's gap reaches ~3e-6 of its scale
    scale = np.abs(jheat).max()
    np.testing.assert_allclose(heat.numpy(), jheat, rtol=0, atol=5e-5 * scale)
    np.testing.assert_allclose(desc.numpy(), jdesc, rtol=0, atol=2e-5)


def test_disk_extract_matches_jax(disk):
    f = tdk.DISK(disk["net"], max_features=128).extract(
        torch.from_numpy(disk["img"]))
    jf = disk["feats"]
    assert f.method == "DISK" and f.image_shape == DISK_SHAPE
    assert 0 < int(f.mask.sum()) < 128     # threshold 0 and -inf peaks
    bar = 5e-5 * np.abs(disk["dense"][0]).max()
    assert_same_features(f, jf, score_bar=bar, desc_atol=2e-5)


def test_instance_norm_variance_is_the_biased_one():
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 3, 5, 7)).astype(np.float32))
    want = torch.nn.functional.instance_norm(x, eps=1e-5)
    torch.testing.assert_close(tdk._instance_norm(x), want, rtol=0,
                               atol=2e-6)


# ---- ALIKED (the approximation) ----------------------------------------------

@pytest.fixture(scope="module")
def aliked(tmp_path_factory):
    img = _image(96, 128, seed=2, n=25)
    ref = jal.ALIKED(max_features=128)
    params = ref.init_random((96, 128), seed=0)
    net = _params.load_tree(tal.ALIKEDNet(), params["params"]).eval()
    wd = tmp_path_factory.mktemp("aliked_weights")
    tal.save_weights(net, wd / "aliked.npz")

    @jax.jit
    def run(im):
        return (ref.net.apply(params, im[None, :, :, None]),
                jal.detect_aliked_features(im, max_features=128))
    with weights_in(wd):
        dense, feats = run(jnp.asarray(img))
    return dict(img=img, net=net, wd=wd, dense=jax.tree.map(np.asarray, dense),
                feats=feats)


def test_aliked_matches_jax(aliked):
    img = torch.from_numpy(aliked["img"])
    heat, desc = aliked["net"](img[None, :, :, None])
    jheat, jdesc = aliked["dense"]
    bar = 1e-5 * np.abs(jheat).max()
    np.testing.assert_allclose(heat.detach().numpy(), jheat, rtol=0, atol=bar)
    np.testing.assert_allclose(desc.detach().numpy(), jdesc, rtol=0, atol=2e-6)
    with weights_in(aliked["wd"]):
        f = tal.detect_aliked_features(img, max_features=128)
    assert int(f.mask.sum()) > 0
    # sub-pixel offsets divide differences of neighbouring heat values
    assert_same_features(f, aliked["feats"], score_bar=bar, xy_atol=1e-4)


def test_aliked_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(
        torch.nn.functional.gelu(x, approximate="tanh").numpy(), want,
        rtol=0, atol=1e-6)
    assert not np.allclose(torch.nn.functional.gelu(x).numpy(), want,
                           atol=1e-4)


# ---- ALIKED-n16 --------------------------------------------------------------

N16_SHAPE = (60, 90)           # padded to 64x96


def _n16_state_dict(seed):
    """A seeded numpy state dict in the published ALIKED-n16 order (the
    torch mirror's): weights normal over their fan-in, BN statistics
    away from the identity."""
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in TorchALIKED().state_dict().items():
        shape = tuple(v.shape)
        if not shape:
            sd[k] = np.asarray(0)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.6, 1.5, shape).astype(np.float32)
        elif k.endswith(("running_mean", "bias")):
            sd[k] = rng.uniform(-0.2, 0.2, shape).astype(np.float32)
        elif k.endswith("bn1.weight") or k.endswith("bn2.weight"):
            sd[k] = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        else:
            fan_in = np.prod(shape[1:]) if not k.endswith("agg") \
                else shape[0] * shape[1]
            sd[k] = (rng.normal(size=shape) / np.sqrt(fan_in)).astype(
                np.float32)
    return sd


@pytest.fixture(scope="module")
def n16(tmp_path_factory):
    sd = _n16_state_dict(0)
    jparams = jn16.load_torch_weights(sd)
    tree = tn16.load_torch_weights(sd)
    net = _params.load_tree(tn16.ALIKEDN16Net(), tree).eval()
    wd = tmp_path_factory.mktemp("n16_weights")
    tn16.save_weights(net, wd / "aliked.npz")
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (64, 96, 3)).astype(np.float32)
    xy = np.stack([rng.uniform(5, 90, 12), rng.uniform(5, 58, 12)],
                  axis=1).astype(np.float32)
    img = _image(*N16_SHAPE, seed=3, n=25)

    @jax.jit
    def run(x, xy, im):
        score, feat = jn16.forward_dense(jparams, x)
        return (score, feat, jn16.sddh_descriptors(jparams["sddh"], feat, xy),
                jal.detect_aliked_features(im, max_features=128))
    with weights_in(wd):
        out = run(jnp.asarray(x), jnp.asarray(xy), jnp.asarray(img))
    return dict(sd=sd, jparams=jparams, tree=tree, net=net, x=x, xy=xy,
                img=img, dense=[np.asarray(a) for a in out[:3]],
                feats=out[3])


def test_aliked_n16_converters_agree(n16):
    flat_j = dict(jax.tree_util.tree_flatten_with_path(n16["jparams"])[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(n16["tree"])[0])
    assert flat_j.keys() == flat_t.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], np.asarray(flat_j[k]))
    broken = dict(list(n16["sd"].items())[:-1])
    with pytest.raises(ValueError):
        tn16.load_torch_weights(broken)


@torch.no_grad()
def test_aliked_n16_dense_and_sddh_match_jax(n16):
    score, feat = n16["net"](torch.from_numpy(n16["x"])[None])
    jscore, jfeat, jdesc = n16["dense"]
    # the JAX package's own bars for this network (2e-4 / 1e-3, 5e-4)
    np.testing.assert_allclose(score[0].numpy(), jscore, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(feat[0].numpy(), jfeat, atol=2e-5, rtol=1e-4)
    desc = n16["net"].sddh(feat, torch.from_numpy(n16["xy"])[None])[0]
    np.testing.assert_allclose(desc.numpy(), jdesc, atol=5e-5, rtol=1e-4)


def test_aliked_n16_extract_matches_jax(n16):
    f = tn16.ALIKEDN16(n16["net"], max_features=128).extract(
        torch.from_numpy(n16["img"]))
    assert f.method == "ALIKED" and f.image_shape == N16_SHAPE
    assert_same_features(f, n16["feats"], score_bar=2e-6, xy_atol=1e-4,
                         desc_atol=5e-5)


# ---- LightGlue ---------------------------------------------------------------

LG = dict(dim=64, n_layers=2, heads=4, input_dim=64)


def _lg_features(seed, n, cap=16, shape=(120, 160)):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 150, (n, 2))
    desc = rng.normal(size=(n, 64))
    return (JFeatures.from_numpy(xy, desc, capacity=cap, image_shape=shape,
                                 method="SuperPoint"),
            TFeatures.from_numpy(xy, desc, capacity=cap, image_shape=shape,
                                 method="SuperPoint", device="cpu"))


@pytest.fixture(scope="module")
def lightglue(tmp_path_factory):
    ref = jlg.LightGlue(**LG, matmul_precision="highest")
    params = ref.init_random(n=16, seed=0)
    net = _params.load_tree(tlg.LightGlueNet(**LG), params["params"]).eval()
    wd = tmp_path_factory.mktemp("lg_weights")
    tlg.save_weights(net, wd / "lightglue_d64.npz")
    (j0, t0), (j1, t1) = _lg_features(0, 10), _lg_features(1, 13)

    def nxy(f):
        return jlg.normalize_keypoints(f.xy, 120, 160)
    # the same program with view 1's keys all masked: -1e9, never NaN
    outs = [ref._forward(params, j0.desc, j1.desc, nxy(j0), nxy(j1), j0.mask,
                         m1) for m1 in (j1.mask, jnp.zeros(16, bool))]
    with weights_in(wd):
        matches = jlg.match_features_lightglue(j0, j1, filter_threshold=0.0)
    return dict(net=net, feats=(t0, t1), dense=[
        [np.asarray(a) for a in o] for o in outs], matches=matches)


def _lg_forward(lightglue, mask1):
    t0, t1 = lightglue["feats"]
    lg = tlg.LightGlue(lightglue["net"], matmul_precision="highest")
    return [a[0].numpy() for a in lg.forward(
        t0.desc[None], t1.desc[None],
        tlg.normalize_keypoints(t0.xy, 120, 160)[None],
        tlg.normalize_keypoints(t1.xy, 120, 160)[None],
        t0.mask[None], mask1[None])]


def test_lightglue_forward_matches_jax(lightglue):
    t1 = lightglue["feats"][1]
    for got, want in zip(_lg_forward(lightglue, t1.mask),
                         lightglue["dense"][0]):
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)


def test_lightglue_fully_masked_view_matches_jax(lightglue):
    got = _lg_forward(lightglue, torch.zeros(16, dtype=torch.bool))
    want = lightglue["dense"][1]
    assert np.isfinite(got[0]).all() and np.isfinite(want[0]).all()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=1e-3)


def test_lightglue_match_matches_jax(lightglue):
    t0, t1 = lightglue["feats"]
    m = tlg.LightGlue(lightglue["net"]).match(t0, t1, filter_threshold=0.0)
    jm = lightglue["matches"]
    assert m.score_type == jm.score_type == "confidence"
    assert m.method == jm.method == "lightglue"
    np.testing.assert_array_equal(m.idx1.numpy(), np.asarray(jm.idx1))
    np.testing.assert_array_equal(m.idx2.numpy(), np.asarray(jm.idx2))
    np.testing.assert_array_equal(m.mask.numpy(), np.asarray(jm.mask))
    assert int(m.mask.sum()) > 3
    np.testing.assert_allclose(m.score.numpy(), np.asarray(jm.score),
                               atol=5e-5, rtol=1e-4)


def test_lightglue_checkpoint_written_by_jax_reads_in_the_port(tmp_path):
    """cvg/LightGlue's layout (the JAX tests' torch mirror) through the
    JAX converter; the port's matcher on it equals the mirror's forward."""
    torch.manual_seed(3)
    tnet = TorchLG(input_dim=64, d=64, h=4, n_layers=2).eval()
    pth = tmp_path / "superpoint_lightglue.pth"
    torch.save(tnet.state_dict(), pth)
    wd = tmp_path / "weights"
    (_, t0), (_, t1) = _lg_features(4, 16), _lg_features(5, 16)
    with weights_in(wd):
        jlg.convert_torch_checkpoint(pth)
        m = MatcherFactory().create_matcher(
            "SuperPoint", "lightglue")(t0, t1)
        net = tlg._LG_CACHE[64].net
    with torch.no_grad():
        la, _, _, _ = tnet(t0.desc, t1.desc,
                           tlg.normalize_keypoints(t0.xy, 120, 160),
                           tlg.normalize_keypoints(t1.xy, 120, 160))
        got, _, _, _ = net(t0.desc[None], t1.desc[None],
                           tlg.normalize_keypoints(t0.xy, 120, 160)[None],
                           tlg.normalize_keypoints(t1.xy, 120, 160)[None],
                           t0.mask[None], t1.mask[None])
    np.testing.assert_allclose(got[0].numpy(), la.numpy(), atol=5e-4,
                               rtol=1e-3)
    assert m.method == "lightglue" and m.idx2.shape == (16,)


def test_lightglue_dimension_mismatch_raises_import_error(lightglue, tmp_path):
    tlg.save_weights(lightglue["net"], tmp_path / "lightglue.npz")
    t0 = TFeatures.from_numpy(np.zeros((4, 2)), np.ones((4, 128)),
                              device="cpu")
    with weights_in(tmp_path):
        with pytest.raises(ImportError, match="128-d"):
            tlg.match_features_lightglue(t0, t0)


# ---- the chain: deep features -> knn2's float32 path -------------------------

@pytest.mark.parametrize("model", ["superpoint", "disk"])
def test_deep_features_match_like_jax(model, request):
    """The folder engine's kNN on deep descriptors (knn2's float32 `l2`
    path) against the reference's on its own extraction of the same image
    and a shifted copy."""
    fx = request.getfixturevalue(model)
    cls = {"superpoint": tsp.SuperPoint, "disk": tdk.DISK}[model]
    img2 = np.roll(fx["img"], 2, axis=1)
    ext = cls(fx["net"], max_features=fx["feats"].capacity)
    t1, t2 = ext.extract(torch.from_numpy(fx["img"])), ext.extract(
        torch.from_numpy(img2))
    tm = tmatch(t1, t2)
    # the reference's features for the second image, from the port's (the
    # first image's extraction is held above), so both match the same sets
    j2 = JFeatures(**{k: jnp.asarray(getattr(t2, k).numpy()) for k in (
        "xy", "response", "scale", "angle", "desc", "mask")},
        method=t2.method, desc_kind=t2.desc_kind, image_shape=t2.image_shape)
    jm = jmatch(fx["feats"], j2)
    ok = np.asarray(jm.mask)
    assert ok.sum() > 10
    np.testing.assert_array_equal(tm.mask.numpy(), ok)
    np.testing.assert_array_equal(tm.idx2.numpy()[ok], np.asarray(jm.idx2)[ok])
    # |d - d'| <= |a - a'| + |b - b'| for the two descriptor sets' gap,
    # plus float32 cancellation in |a|^2 + |b|^2 - 2 a.b (unit vectors)
    d = np.asarray(jm.score)
    desc_bar = {"superpoint": 2e-6, "disk": 2e-5}[model]
    bar = 2 * np.sqrt(t1.desc.shape[-1]) * desc_bar + 1e-6 / np.maximum(d, 1e-3)
    assert (np.abs(tm.score.numpy() - d) <= bar).all()


# ---- wiring --------------------------------------------------------------

def _deep_weights(path, gen):
    """Random SuperPoint, DISK and LightGlue d256 / d128 checkpoints."""
    tsp.save_weights(tsp.SuperPoint().init_random(gen), path / "superpoint.npz")
    tdk.save_weights(tdk.DISK().init_random(gen), path / "disk.npz")
    for d in (256, 128):
        tlg.save_weights(tlg.LightGlue(dim=64, n_layers=1, input_dim=d)
                         .init_random(gen), path / f"lightglue_d{d}.npz")


def test_deep_learning_preset_runs_lightglue_per_pair_and_knn_batched(
        tmp_path):
    gen = torch.Generator().manual_seed(0)
    wd = tmp_path / "weights"
    wd.mkdir()
    img1 = _image(64, 80, seed=7)
    img2 = np.roll(img1, 3, axis=1)
    with weights_in(wd):
        with pytest.raises(ValueError, match="no available detectors"):
            tv.create_pipeline("deep_learning", device="cpu")
        _deep_weights(wd, gen)
        pipe = tv.create_pipeline(
            "deep_learning", {"max_features": 256}, device="cpu")
        assert pipe.methods == ["SuperPoint", "DISK"]
        per_pair = pipe.match(img1, img2, "a", "b")
        batched = pipe._match_pairs_batched({"a": img1, "b": img2},
                                            [("a", "b")])[("a", "b")]
    for m in ("SuperPoint", "DISK"):
        mr = per_pair[m]
        assert not mr.error and mr.matcher_used == "lightglue"
        assert mr.matches.score_type == "confidence"
        assert batched[m].matcher_used == "knn-batched[l2]"
        ref = tmatch(mr.features1, mr.features2)
        torch.testing.assert_close(batched[m].matches.mask, ref.mask)


def test_lightglue_fallback_is_recorded(tmp_path):
    wd = tmp_path / "weights"
    gen = torch.Generator().manual_seed(1)
    tsp.save_weights(tsp.SuperPoint().init_random(gen), wd / "superpoint.npz")
    img = _image(64, 80, seed=8)
    with weights_in(wd):
        pipe = tv.create_pipeline("deep_learning", {"max_features": 128},
                                  device="cpu")
        assert pipe.methods == ["SuperPoint"]
        mr = pipe.match(img, np.roll(img, 2, axis=0))["SuperPoint"]
    assert mr.matcher_used.startswith("knn (lightglue fallback: ")
    assert "256-d" in mr.matcher_used and not mr.error


# ---- knobs ---------------------------------------------------------------

def test_tf32_is_allowed_inside_the_forward_only():
    seen = []
    sp = tsp.SuperPoint(tsp.SuperPoint().init_random(
        torch.Generator().manual_seed(2)), max_features=32)
    sp.net.register_forward_hook(lambda *a: seen.append(
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32)))
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    assert before == (False, False)          # the package's setting
    sp.extract(torch.zeros(16, 24))
    assert seen == [(True, True)]
    sp.matmul_precision = "highest"
    sp.extract(torch.zeros(16, 24))
    assert seen[-1] == (False, False)
    with pytest.raises(RuntimeError):
        with _common.precision("default"):
            raise RuntimeError("inside the forward")
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before
    with pytest.raises(ValueError):
        with _common.precision("bfloat16"):
            pass


def test_bfloat16_activations_track_float32():
    """The reference's test_bf16_activation_storage_tracks_f32 on the
    port: the parameters stay float32, the outputs follow."""
    gen = torch.Generator().manual_seed(0)
    img = torch.from_numpy(_image(120, 160, seed=0, n=60))
    net = tsp.SuperPoint().init_random(gen)
    f32 = tsp.SuperPoint(net, max_features=256).extract(img)
    fbf = tsp.SuperPoint(net, max_features=256,
                         activation_dtype="bfloat16").extract(img)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    a = set(map(tuple, f32.xy[f32.mask].int().tolist()))
    b = set(map(tuple, fbf.xy[fbf.mask].int().tolist()))
    assert len(a & b) / max(len(a), 1) > 0.8
    lg = tlg.LightGlue(n_layers=3)
    lg.init_random(gen)
    lgbf = tlg.LightGlue(lg.net, activation_dtype="bfloat16")
    rng = np.random.default_rng(0)
    d0, d1 = (torch.from_numpy(rng.standard_normal((1, 256, 256)).astype(
        np.float32)) for _ in range(2))
    xy = torch.from_numpy(rng.uniform(-1, 1, (1, 256, 2)).astype(np.float32))
    m = torch.ones(1, 256, dtype=torch.bool)
    _, sim32, _, _ = lg.forward(d0, d1, xy, xy, m, m)
    _, simbf, _, _ = lgbf.forward(d0, d1, xy, xy, m, m)
    assert simbf.dtype == torch.float32
    corr = np.corrcoef(sim32.numpy().ravel(), simbf.numpy().ravel())[0, 1]
    agree = (sim32.argmax(-1) == simbf.argmax(-1)).float().mean()
    assert corr > 0.98 and agree > 0.9, (corr, agree)
