"""Parity of tpu3drec_torch.ops.match / pallas_match with the reference.

Tolerances: `l2_int8` and `hamming_pm1` are exact integer arithmetic in
both packages, so indices and squared distances must be bit-equal; the
final float32 square root differs by at most one ulp (XLA's CPU sqrt is
not correctly rounded), hence rtol 2.4e-7 on the distances themselves.
`l2` sums float32 products in another order, so distances agree to rtol
1e-5 and indices wherever the two nearest are not within that tolerance
of a tie.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

from tpu3drec.ops import match as jm
from tpu3drec.ops.pallas_match import fused_knn2
from tpu3drec_torch.ops import match as tm
from tpu3drec_torch.ops import pallas_match as tpm


def _sift_like(rng, n, d=128):
    """Descriptors on the 0..255 scale with near-duplicate rows."""
    x = rng.uniform(0, 160, (n, d)).astype(np.float32)
    x[n // 2:n // 2 + 8] = x[:8] + rng.uniform(-2, 2, (8, d)).astype(np.float32)
    return x


def _both(fn_t, fn_j, *arrays, **kw):
    got = fn_t(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kw)
    ref = fn_j(*[jnp.asarray(a) for a in arrays], **kw)
    return [t.numpy() for t in got], [np.asarray(r) for r in ref]


def _assert_same_int_distances(dist, rdist):
    """Exact integer squared distances; the sqrt to one ulp."""
    np.testing.assert_array_equal(np.round(dist.astype(np.float64) ** 2),
                                  np.round(rdist.astype(np.float64) ** 2))
    np.testing.assert_allclose(dist, rdist, rtol=2.4e-7, atol=0)


def _masks(rng, n, m):
    m1 = rng.random(n) > 0.1
    m2 = rng.random(m) > 0.2
    return m1, m2


def test_knn2_l2_int8_bit_equal():
    rng = np.random.default_rng(0)
    d1, d2 = _sift_like(rng, 300), _sift_like(rng, 417)
    d2[5] = d2[9]                        # an exact tie
    d1[3] = d2[5]
    m1, m2 = _masks(rng, 300, 417)
    m2[[5, 9]] = True
    (idx, dist), (ridx, rdist) = _both(tm.knn2, jm.knn2, d1, d2, m1, m2,
                                       metric="l2_int8")
    np.testing.assert_array_equal(idx, ridx)
    _assert_same_int_distances(dist, rdist)
    assert tuple(idx[3]) == (5, 9) and dist[3, 0] == dist[3, 1] == 0


def test_knn2_hamming_pm1_bit_equal():
    rng = np.random.default_rng(1)
    b1 = rng.integers(0, 2, (200, 256)).astype(np.float32) * 2 - 1
    b2 = rng.integers(0, 2, (333, 256)).astype(np.float32) * 2 - 1
    b2[7] = b2[2]
    m1, m2 = _masks(rng, 200, 333)
    (idx, dist), (ridx, rdist) = _both(tm.knn2, jm.knn2, b1, b2, m1, m2,
                                       metric="hamming_pm1")
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(dist, rdist)


def test_knn2_l2_matches_away_from_ties():
    rng = np.random.default_rng(2)
    d1 = rng.normal(size=(256, 64)).astype(np.float32)
    d2 = rng.normal(size=(300, 64)).astype(np.float32)
    m1, m2 = _masks(rng, 256, 300)
    (idx, dist), (ridx, rdist) = _both(tm.knn2, jm.knn2, d1, d2, m1, m2,
                                       metric="l2")
    np.testing.assert_allclose(dist, rdist, rtol=1e-5, atol=1e-5)
    clear = (rdist[:, 1] - rdist[:, 0]) > 1e-5 * rdist[:, 1] + 1e-5
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(idx[clear, 0], ridx[clear, 0])


@pytest.mark.parametrize("metric", ["l2_int8", "hamming_pm1", "l2"])
def test_knn2_fully_masked_and_single_column(metric):
    """No valid column: both neighbours are column 0 at the pad distance;
    one valid column: it wins and the second is column 0 at the pad."""
    rng = np.random.default_rng(3)
    d1 = _sift_like(rng, 20, 32)
    d2 = _sift_like(rng, 24, 32)
    if metric == "hamming_pm1":
        d1, d2 = np.sign(d1 - 80) + (d1 == 80), np.sign(d2 - 80) + (d2 == 80)
    m1 = np.ones(20, bool)
    for m2 in (np.zeros(24, bool), np.eye(24, dtype=bool)[11]):
        (idx, dist), (ridx, rdist) = _both(tm.knn2, jm.knn2, d1, d2, m1, m2,
                                           metric=metric)
        np.testing.assert_array_equal(idx, ridx)
        np.testing.assert_allclose(dist, rdist, rtol=1e-6)


def test_knn2_batched_equals_per_pair():
    rng = np.random.default_rng(4)
    d1 = np.stack([_sift_like(rng, 128) for _ in range(3)])
    d2 = np.stack([_sift_like(rng, 150) for _ in range(3)])
    m2 = rng.random((3, 150)) > 0.3
    m1 = np.ones((3, 128), bool)
    bi, bd = tm.knn2(*[torch.from_numpy(a) for a in (d1, d2, m1, m2)],
                     metric="l2_int8")
    for b in range(3):
        ri, rd = jm.knn2(jnp.asarray(d1[b]), jnp.asarray(d2[b]),
                         jnp.asarray(m1[b]), jnp.asarray(m2[b]),
                         metric="l2_int8")
        np.testing.assert_array_equal(bi[b].numpy(), np.asarray(ri))
        _assert_same_int_distances(bd[b].numpy(), np.asarray(rd))


def test_plain_kernel_matches_jax_fused_knn2_interpret():
    """The plain `knn2_raw` function against the reference's Pallas kernel
    (interpret mode), float32, one shape; values to rtol/atol 1e-4 as the
    reference's own kernel test."""
    rng = np.random.default_rng(5)
    n, m, d = 128, 256, 64
    d1 = rng.normal(size=(n, d)).astype(np.float32)
    d2 = rng.normal(size=(m, d)).astype(np.float32)
    mask2 = np.ones(m, bool)
    mask2[100:140] = False
    ridx, rv1, rv2 = fused_knn2(jnp.asarray(d1), jnp.asarray(d2),
                                jnp.asarray(mask2), block_n=128, block_m=128,
                                interpret=True)
    a, b = torch.from_numpy(d1)[None], torch.from_numpy(d2)[None]
    idx, raw = tpm.knn2_raw(a, b, (b * b).sum(-1), torch.from_numpy(mask2)[None])
    dist = torch.sqrt(torch.clamp(raw[0] + (a[0] * a[0]).sum(-1)[:, None],
                                  min=0)).numpy()
    np.testing.assert_array_equal(idx[0, :, 0].numpy(), np.asarray(ridx))
    np.testing.assert_allclose(dist[:, 0], np.asarray(rv1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dist[:, 1], np.asarray(rv2), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric,cross_check",
                         [("l2_int8", False), ("l2_int8", True), ("l2", True)])
def test_ratio_test_and_cross_check_match_reference(metric, cross_check):
    rng = np.random.default_rng(6)
    if metric == "l2_int8":
        base = _sift_like(rng, 180)
        d1 = base + rng.normal(0, 3, base.shape).astype(np.float32)
        d2 = np.concatenate([base[::-1], _sift_like(rng, 60)])
    else:
        # unit-scale floats: |a|^2 + |b|^2 - 2ab cancels far less than
        # on the 0..255 scale, so float32 distances agree to 1e-5
        base = rng.normal(size=(180, 64)).astype(np.float32)
        d1 = base + rng.normal(0, 0.3, base.shape).astype(np.float32)
        d2 = np.concatenate([base[::-1],
                             rng.normal(size=(60, 64)).astype(np.float32)])
    m1, m2 = _masks(rng, 180, 240)
    got = tm.match_descriptors(torch.from_numpy(d1), torch.from_numpy(d2),
                               torch.from_numpy(m1), torch.from_numpy(m2),
                               ratio=0.75, cross_check=cross_check,
                               metric=metric)
    ref = jm.match_descriptors(jnp.asarray(d1), jnp.asarray(d2),
                               jnp.asarray(m1), jnp.asarray(m2), ratio=0.75,
                               cross_check=cross_check, metric=metric)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    ok = np.asarray(ref.mask)
    assert ok.sum() > 50
    np.testing.assert_array_equal(got.idx2.numpy()[ok], np.asarray(ref.idx2)[ok])
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score),
                               rtol=1e-5)


def test_match_features_metric_choice_and_auto_matcher():
    from tpu3drec_torch.core.types import DescriptorKind, Features
    f = Features.from_numpy(np.zeros((3, 2)), np.zeros((3, 8)),
                            method="SIFT", device="cpu")
    assert tm._metric_for(f) == "l2_int8"
    assert tm._metric_for(f.replace(method="SuperPoint")) == "l2"
    b = f.replace(desc_kind=DescriptorKind.BINARY.value)
    assert tm._metric_for(b) == "hamming_pm1"
    assert tm.auto_select_matcher(f) == "flann"
    assert tm.auto_select_matcher(b) == "bf"


@pytest.mark.parametrize("metric", ["l2", "l2_int8", "hamming_pm1"])
def test_blockwise_knn_exact(metric, monkeypatch):
    """Above the threshold the plain version scans column tiles with a
    running top-2; tiles forced small at a small N give the untiled
    result (the reference's `knn2_blockwise` against its `knn2`), with
    scattered masks, a fully masked tile, exact ties across tiles and a
    last partial tile. Integer metrics exactly, `l2` to rtol 1e-6."""
    rng = np.random.default_rng(0)
    n, m, d = 300, 517, 64
    if metric == "hamming_pm1":
        d1 = rng.choice([-1.0, 1.0], (2, n, d)).astype(np.float32)
        d2 = rng.choice([-1.0, 1.0], (2, m, d)).astype(np.float32)
    elif metric == "l2_int8":
        d1, d2 = rng.uniform(0, 160, (2, n, d)), rng.uniform(0, 160, (2, m, d))
        d1, d2 = d1.astype(np.float32), d2.astype(np.float32)
    else:
        d1 = rng.standard_normal((2, n, d)).astype(np.float32)
        d2 = rng.standard_normal((2, m, d)).astype(np.float32)
    d2[:, 400] = d2[:, 3]                   # a tie across tiles
    d1[:, 7] = d2[:, 3]
    m1 = rng.random((2, n)) > 0.1
    m2 = rng.random((2, m)) > 0.1
    m2[:, 128:256] = False                  # one tile fully masked
    m2[:, [3, 400]] = True
    m2[1] = False                           # a pair with no valid column
    m2[1, 300] = True                       # ... but one
    args = [torch.from_numpy(a) for a in (d1, d2, m1, m2)]
    i_full, v_full = tm.knn2(*args, metric=metric)
    monkeypatch.setattr(tpm, "BLOCKWISE_THRESHOLD", 256)
    monkeypatch.setattr(tpm, "BLOCK_COLUMNS", 128)
    i_blk, v_blk = tm.knn2(*args, metric=metric)
    np.testing.assert_array_equal(i_blk.numpy(), i_full.numpy())
    if metric == "l2":
        np.testing.assert_allclose(v_blk.numpy(), v_full.numpy(), rtol=1e-6)
    else:
        np.testing.assert_array_equal(v_blk.numpy(), v_full.numpy())
    assert int(i_full[0, 7, 0]) == 3        # the tie goes to the lower index


def test_large_n_routes_to_blockwise(monkeypatch):
    """At N >= BLOCKWISE_THRESHOLD the plain version never builds the
    (B, N, M) matrix: it matches in column tiles (the reference's
    `_match_impl` switch, `tpu3drec/ops/match.py:241-243`) and agrees
    with the reference's blockwise kNN on probe rows."""
    assert tpm.BLOCKWISE_THRESHOLD == jm.BLOCKWISE_THRESHOLD == 8192
    rng = np.random.default_rng(1)
    n = tpm.BLOCKWISE_THRESHOLD
    d1 = rng.standard_normal((n, 32)).astype(np.float32)
    d2 = rng.standard_normal((n, 32)).astype(np.float32)
    ones = np.ones(n, bool)
    widths = []
    real = tpm._raw_block

    def spy(a, b, bnorm, mask2):
        widths.append(b.shape[1])
        return real(a, b, bnorm, mask2)

    monkeypatch.setattr(tpm, "_raw_block", spy)
    best, dist, ok = tm._match_impl(
        torch.from_numpy(d1), torch.from_numpy(d2), torch.from_numpy(ones),
        torch.from_numpy(ones), 0.95, False, "l2")
    assert widths and max(widths) == tpm.BLOCK_COLUMNS
    assert len(widths) == n // tpm.BLOCK_COLUMNS
    i_blk, _ = jm.knn2_blockwise(jnp.asarray(d1[:64]), jnp.asarray(d2),
                                 jnp.asarray(ones[:64]), jnp.asarray(ones),
                                 block=2048)
    np.testing.assert_array_equal(best[:64].numpy(), np.asarray(i_blk[:, 0]))
