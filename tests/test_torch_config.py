"""Parity of the port's configuration, matcher registry and result types
(tpu3drec_torch.core.{config, registry, types, multi_match}) with the JAX
package's.

These are host-side copies, so they must agree exactly: equal tables,
equal dicts for every preset, merge, validation and hardware adjustment,
equal registry answers on every detector x matcher pair of the JSON,
equal rankings, summaries and merged correspondence sets given results
built from the same numpy arrays, and bit-equal descriptor packing.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tpu3drec.core import config as jcfg                       # noqa: E402
from tpu3drec.core import multi_match as jmm                   # noqa: E402
from tpu3drec.core import registry as jreg                     # noqa: E402
from tpu3drec.core import types as jt                          # noqa: E402
from tpu3drec_torch.core import config as tcfg                 # noqa: E402
from tpu3drec_torch.core import multi_match as tmm             # noqa: E402
from tpu3drec_torch.core import registry as treg               # noqa: E402
from tpu3drec_torch.core import types as tt                    # noqa: E402

TABLES = ("KNOWN_DETECTORS", "DEEP_DETECTORS", "KNOWN_MATCHERS",
          "COMBINE_STRATEGIES", "DEFAULT_CONFIG", "PRESET_CONFIGS",
          "DETECTOR_SPECIFIC_CONFIGS", "MATCHER_SPECIFIC_CONFIGS")


@pytest.mark.parametrize("name", TABLES)
def test_config_tables_equal(name):
    assert getattr(tcfg, name) == getattr(jcfg, name)


@pytest.mark.parametrize("preset", sorted(jcfg.PRESET_CONFIGS))
def test_presets_merge_and_adjust_like_jax(preset):
    custom = {"max_features": 777, "filtering": {"top_k": 3},
              "detector_params": {"SIFT": {"sigma": 2.0}}}
    for c in (None, custom):
        assert tcfg.create_config_from_preset(preset, c) \
            == jcfg.create_config_from_preset(preset, c)
    cfg = jcfg.create_config_from_preset(preset)
    for have in (False, True):
        assert tcfg.adjust_config_for_hardware(cfg, have) \
            == jcfg.adjust_config_for_hardware(cfg, have)
    # both packages read the same weights directory
    assert tcfg.adjust_config_for_hardware(cfg) \
        == jcfg.adjust_config_for_hardware(cfg)


def test_deep_learning_without_weights_falls_back_to_sift_bf():
    cfg = tcfg.create_config_from_preset("deep_learning")
    out = tcfg.adjust_config_for_hardware(cfg, have_deep_weights=False)
    assert out["methods"] == ["SIFT"] and out["matcher_config"]["SIFT"] == "bf"
    assert out == jcfg.adjust_config_for_hardware(cfg, have_deep_weights=False)


MERGE_CASES = [
    ({"a": 1, "b": {"c": 2, "d": [1, 2]}}, {"b": {"c": 3}, "e": 4}),
    ({"a": {"b": {"c": 1}}}, {"a": {"b": 5}}),
    ({"a": 1}, None),
    ({"a": [1, 2]}, {"a": {"x": 1}}),
]


@pytest.mark.parametrize("base,override", MERGE_CASES)
def test_merge_configs_like_jax(base, override):
    out = tcfg.merge_configs(base, override)
    assert out == jcfg.merge_configs(base, override)
    if override:
        override["mutated"] = True          # a deep copy, not a view
        assert "mutated" not in out


VALIDATE_CASES = [
    {},
    {"methods": ["SIFT"], "max_features": 10, "combine_strategy": "best"},
    {"methods": ["SIFT", "Nope"], "max_features": 0,
     "combine_strategy": "mix", "matcher_config": {"SIFT": "kd"}},
    {"methods": ["GFTT"], "max_features": 2.5, "combine_strategy": "weighted"},
]


@pytest.mark.parametrize("cfg", VALIDATE_CASES)
def test_validate_config_like_jax(cfg):
    assert tcfg.validate_config(cfg) == jcfg.validate_config(cfg)


def test_save_and_load_read_each_other(tmp_path):
    cfg = jcfg.create_config_from_preset("balanced")
    tcfg.save_config(cfg, tmp_path / "t.json")
    jcfg.save_config(cfg, tmp_path / "j.json")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert jcfg.load_config(tmp_path / "t.json") == tcfg.load_config(
        tmp_path / "j.json")


def _registry_pairs():
    m = jreg.MatcherCompatibilityManager()
    return [(d, k) for d in sorted(m.detectors) for k in sorted(m.matchers)]


def test_compatibility_manager_answers_like_jax(capsys):
    jm, tm = jreg.MatcherCompatibilityManager(), treg.MatcherCompatibilityManager()
    assert tm.version == jm.version and tm.data == jm.data
    for det, mat in _registry_pairs() + [("Nope", "bf"), ("SIFT", "auto"),
                                         ("SIFT", None)]:
        assert tm.is_compatible(det, mat) == jm.is_compatible(det, mat)
        assert tm.get_matcher_params(det, mat) == jm.get_matcher_params(det, mat)
        assert tm.validate_configuration(det, mat) \
            == jm.validate_configuration(det, mat)
    for det in sorted(jm.detectors) + ["Nope"]:
        assert tm.get_default_matcher(det) == jm.get_default_matcher(det)
        assert tm.get_recommended_matcher(det) == jm.get_recommended_matcher(det)
        assert tm.descriptor_info(det) == jm.descriptor_info(det)
    assert tm.print_compatibility_matrix() == jm.print_compatibility_matrix()
    capsys.readouterr()


def _resolve(factory, det, mat):
    try:
        return factory._determine_matcher_type(det, mat)
    except ValueError as e:
        return ("ValueError", str(e))


def test_matcher_factory_resolves_like_jax():
    jf, tf = jreg.MatcherFactory(), treg.MatcherFactory()
    cases = _registry_pairs() + [(d, None) for d in sorted(jf.compat.detectors)] \
        + [(d, "auto") for d in sorted(jf.compat.detectors)]
    for det, mat in cases:
        assert _resolve(tf, det, mat) == _resolve(jf, det, mat), (det, mat)


def _feature_pair(kind, rng, n=48, d=None):
    if kind == "binary":
        d = d or 256
        desc = rng.choice([-1.0, 1.0], (2, n, d)).astype(np.float32)
        method = "ORB"
    else:
        d = d or 128
        desc = rng.integers(0, 64, (2, n, d)).astype(np.float32)
        desc[1, :n // 2] = desc[0, :n // 2] + rng.integers(0, 2, (n // 2, d))
        method = "SIFT"
    xy = rng.uniform(0, 100, (2, n, 2)).astype(np.float32)
    feats = []
    for pkg, kw in ((jt, {}), (tt, {"device": "cpu"})):
        feats.append([pkg.Features.from_numpy(
            xy[i], desc[i], response=np.linspace(1, 0, n), method=method,
            desc_kind=kind, capacity=n + 4, **kw) for i in range(2)])
    return feats


@pytest.mark.parametrize("det,kind", [("SIFT", "float"), ("ORB", "binary")])
def test_matcher_factory_knn_matches_like_jax(det, kind):
    rng = np.random.default_rng(3)
    (j1, j2), (t1, t2) = _feature_pair(kind, rng)
    for mat in ("bf", "flann", None):
        jm = jreg.MatcherFactory().create_matcher(det, mat)(j1, j2)
        tm = treg.MatcherFactory().create_matcher(det, mat)(t1, t2)
        a, b = jm.to_numpy(), tm.to_numpy()
        for k in ("idx1", "idx2"):
            np.testing.assert_array_equal(b[k], a[k])
        np.testing.assert_allclose(b["score"], a["score"], rtol=1e-6)


def test_lightglue_matcher_names_the_deep_model_item(tmp_path, monkeypatch):
    """The factory's LightGlue matcher is the deep model: without converted
    weights both packages' raise the same ImportError (the pipeline's kNN
    fallback), with a converted checkpoint the port's returns LightGlue's
    confidence-scored mutual matches."""
    import tpu3drec.models as jmodels
    import tpu3drec_torch.models as tmodels
    from tpu3drec.models import lightglue as jlg
    from tpu3drec_torch.models import lightglue as tlg
    (j1, j2), (t1, t2) = _feature_pair("float", np.random.default_rng(4))
    for mod in (jmodels, tmodels):
        monkeypatch.setattr(mod, "WEIGHTS_DIR", tmp_path)
    monkeypatch.setattr(jlg, "_LG_CACHE", {})
    monkeypatch.setattr(tlg, "_LG_CACHE", {})
    errors = []
    for reg, f1, f2 in ((jreg, j1, j2), (treg, t1, t2)):
        fn = reg.MatcherFactory().create_matcher("SuperPoint", "lightglue")
        with pytest.raises(ImportError) as e:
            fn(f1, f2)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == (
        f"lightglue weights not available for {t1.desc.shape[-1]}-d "
        f"descriptors")
    lg = tlg.LightGlue(dim=32, n_layers=1, input_dim=t1.desc.shape[-1])
    tlg.save_weights(lg.init_random(torch.Generator().manual_seed(0)),
                     tmp_path / "lightglue.npz")
    m = treg.MatcherFactory().create_matcher("SuperPoint", "lightglue")(t1, t2)
    assert m.method == "lightglue" and m.score_type == "confidence"
    assert m.idx1.shape == (t1.capacity,)
    ok = m.mask.numpy()
    assert not ok[~t1.mask.numpy()].any()
    assert ((m.score.numpy()[ok] > 0.1) & (m.score.numpy()[ok] <= 1)).all()


def _method_results(pkg, rng_seed, specs, **kw):
    """{method: MethodResult} from the same numpy arrays in either
    package: specs = [(method, kind, n_matches, inlier_ratio, reproj)]."""
    rng = np.random.default_rng(rng_seed)
    out = {}
    for method, kind, n_match, ratio, reproj in specs:
        n = 40
        xy1 = rng.uniform(0, 50, (n, 2)).astype(np.float32)
        xy2 = xy1 + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
        desc = np.zeros((n, 4), np.float32)
        f1 = pkg.Features.from_numpy(xy1, desc, method=method,
                                     desc_kind=kind, **kw)
        f2 = pkg.Features.from_numpy(xy2, desc, method=method,
                                     desc_kind=kind, **kw)
        idx2 = rng.permutation(n).astype(np.int32)
        score = rng.uniform(0, 0.9, n).astype(np.float32)
        m = pkg.Matches.from_numpy(np.arange(n_match), idx2[:n_match],
                                   score[:n_match], capacity=n,
                                   method=method, **kw) \
            if pkg is tt else pkg.Matches(
                idx1=jnp.arange(n, dtype=jnp.int32), idx2=jnp.asarray(idx2),
                score=jnp.asarray(np.where(np.arange(n) < n_match, score, 0)),
                mask=jnp.asarray(np.arange(n) < n_match), method=method)
        out[method] = pkg.MethodResult(
            method=method, features1=f1, features2=f2, matches=m,
            inlier_ratio=ratio, reprojection_error=reproj,
            detection_time=0.5, matching_time=0.25)
    return out


SPECS = [
    [("SIFT", "float", 30, 0.8, 1.0), ("ORB", "binary", 35, 0.7, 2.0)],
    [("SIFT", "float", 12, None, None), ("ORB", "binary", 0, 0.9, 0.5)],
    [("ORB", "binary", 20, 0.5, 3.0), ("SIFT", "float", 20, 0.5, 3.0)],
]


@pytest.mark.parametrize("specs", SPECS)
def test_matching_result_ranks_and_summarises_like_jax(specs):
    res = {}
    for pkg, kw in ((jt, {}), (tt, {"device": "cpu"})):
        res[pkg] = pkg.MatchingResult(
            results=_method_results(pkg, 7, specs, **kw), image1_name="a",
            image2_name="b", total_processing_time=1.5)
    j, t = res[jt], res[tt]
    assert [k for k, _ in t.rank_methods()] == [k for k, _ in j.rank_methods()]
    assert t.get_best().method == j.get_best().method
    assert t.get_best_method_name() == j.get_best_method_name()
    assert t.summary() == j.summary()
    assert ("SIFT" in t) and list(t.keys()) == list(j.keys())


@pytest.mark.parametrize("specs", SPECS[:2])
def test_merge_method_matches_like_jax(specs):
    j = jmm.merge_method_matches(_method_results(jt, 11, specs))
    t = tmm.merge_method_matches(_method_results(tt, 11, specs,
                                                 device="cpu"))
    assert sorted(t) == sorted(j)
    for k in j:
        if isinstance(j[k], np.ndarray):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        else:
            assert t[k] == j[k], k


def test_descriptor_packing_is_bit_equal():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (17, 256))
    pm = tt.pack_binary_descriptors(bits)
    np.testing.assert_array_equal(pm, jt.pack_binary_descriptors(bits))
    assert pm.dtype == np.float32
    dot = pm @ pm[::-1].T
    np.testing.assert_array_equal(
        tt.hamming_from_pm1(torch.from_numpy(dot), 256).numpy(),
        np.asarray(jt.hamming_from_pm1(jnp.asarray(dot), 256)))
    ham = tt.hamming_from_pm1(dot, 256)
    np.testing.assert_array_equal(ham, (bits[:, None] != bits[::-1][None]).sum(-1))


def test_features_and_matches_helpers_like_jax():
    rng = np.random.default_rng(5)
    n = 24
    xy = rng.uniform(0, 9, (n, 2)).astype(np.float32)
    resp = np.round(rng.uniform(0, 1, n), 1).astype(np.float32)  # ties
    desc = rng.normal(size=(n, 8)).astype(np.float32)
    jf = jt.Features.from_numpy(xy, desc, response=resp, capacity=n + 6)
    tf = tt.Features.from_numpy(xy, desc, response=resp, capacity=n + 6,
                                device="cpu")
    for k in (5, n + 6):
        a, b = jf.top_k(k), tf.top_k(k)
        for f in ("xy", "response", "mask", "desc"):
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(a, f)))
    e = tt.Features.empty(7, 3, method="ORB", device="cpu")
    je = jt.Features.empty(7, 3, method="ORB")
    assert e.desc.shape == je.desc.shape and e.method == je.method
    assert not bool(e.mask.any()) and e.capacity == 7

    score = np.round(rng.uniform(0, 1.5, n), 1).astype(np.float32)
    mask = rng.uniform(size=n) < 0.8
    idx = np.arange(n, dtype=np.int32)
    for st in ("distance", "confidence"):
        jm = jt.Matches(idx1=jnp.asarray(idx), idx2=jnp.asarray(idx[::-1]),
                        score=jnp.asarray(score), mask=jnp.asarray(mask),
                        score_type=st)
        tm = tt.Matches(idx1=torch.from_numpy(idx),
                        idx2=torch.from_numpy(idx[::-1].copy()),
                        score=torch.from_numpy(score),
                        mask=torch.from_numpy(mask), score_type=st)
        np.testing.assert_array_equal(tm.quality().numpy(),
                                      np.asarray(jm.quality()))
        np.testing.assert_array_equal(tm.as_distance().numpy(),
                                      np.asarray(jm.as_distance()))
        np.testing.assert_array_equal(tm.filter_by_score(0.6).mask.numpy(),
                                      np.asarray(jm.filter_by_score(0.6).mask))
        a, b = jm.top_k(9), tm.top_k(9)
        for f in ("idx1", "idx2", "score", "mask"):
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(a, f)))
