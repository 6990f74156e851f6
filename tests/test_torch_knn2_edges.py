"""`knn2`'s edge cases, held against the reference's XLA `knn2`.

The card's `knn2` kernel sweeps a device list of each pair's valid
columns, on the int8 tensor cores or, for `l2`, in float32 on the CUDA
cores; `chip_smoke.py` holds it against `knn2_plain` on the inputs
below (int8 bit for bit). Here the same inputs go through the port's
`knn2` (the plain version on the CPU) and through
`tpu3drec.ops.match.knn2` (XLA, not the interpret-mode Pallas kernel,
whose every new shape costs a long compile): scattered masks, no valid
column, one valid column, exact duplicate columns (ties), N and M that
are multiples of no tile, D of 64, 100 and 256, for `l2_int8`,
`hamming_pm1` and `l2` (unit-scale float32 rows, as SuperPoint's and
DISK's).

Tolerances: `l2_int8` and `hamming_pm1` are exact integer arithmetic in
both packages, so indices and squared distances (Hamming counts) must be
equal; the final float32 square root of `l2_int8` may differ by one ulp
(XLA's CPU sqrt is not correctly rounded), hence rtol 2.4e-7 on the
distances. `l2` sums float32 products in another order in XLA:CPU's dot
and torch's CPU matmul, and the reference adds |a|^2 + |b|^2 - 2 a.b in
another order than the port's (|b|^2 - 2 a.b) + |a|^2: on unit rows the
squared distances differ by ~1e-7 (`L2_SQ_GAP` 1e-5 bounds it), which
is a relative 1e-5 of a distance above ~0.1 plus XLA's sqrt, and at
most sqrt(1e-6) = 1e-3 of a distance near 0 (a row equal to a column,
where the three terms cancel): rtol 1e-5, atol 1e-3. Indices are equal
on every row whose exact (float64) best two are more than `L2_SQ_GAP`
apart in squared distance, the second where the second and third are
too; exact ties (duplicate columns) go to the lower column in both.
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

from tpu3drec.ops import match as jm
from tpu3drec_torch.ops import match as tm
from tpu3drec_torch.ops import pallas_match as tpm

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the card's float32 edge inputs)

L2_SQ_GAP = 1e-5

CASES = ["scattered", "no_valid", "one_valid", "duplicates", "odd_shape"]


def _descriptors(rng, n, d, metric):
    if metric == "hamming_pm1":
        return rng.integers(0, 2, (n, d)).astype(np.float32) * 2 - 1
    if metric == "l2":
        x = rng.standard_normal((n, d))
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    return rng.uniform(0, 200, (n, d)).astype(np.float32)


def _case(case, metric, d, seed):
    """A batch of two pairs: (desc1 (2, N, D), desc2 (2, M, D), mask2 (2, M))."""
    rng = np.random.default_rng(seed)
    n, m = (131, 97) if case == "odd_shape" else (64, 80)
    d1 = np.stack([_descriptors(rng, n, d, metric) for _ in range(2)])
    d2 = np.stack([_descriptors(rng, m, d, metric) for _ in range(2)])
    # random, not a prefix: the listed columns are scattered over M
    m2 = rng.random((2, m)) < 0.35
    if case == "no_valid":
        m2[0] = False
        m2[1] = rng.random(m) < 0.1
    elif case == "one_valid":
        m2[:] = False
        m2[0, m - 3] = True
        m2[1, 0] = True
    elif case == "duplicates":
        # exact duplicate columns, both valid, and rows of A equal to them:
        # the value ties and the lower column must win, both places
        for p in range(2):
            cols = np.flatnonzero(m2[p])
            lo, hi = cols[1], cols[-2]
            d2[p, hi] = d2[p, lo]
            d2[p, cols[-1]] = d2[p, lo]
            d1[p, :5] = d2[p, lo]
    return d1, d2, m2


def _pad(metric, d):
    """The distance both packages report for a masked column."""
    if metric == "l2":
        return np.sqrt(np.float32(tpm.F32_BIG))
    big = np.float32(tpm.INT_BIG)
    return np.sqrt(big) if metric == "l2_int8" else (big + d) * np.float32(0.5)


def _exact_top3(a, b, bnorm, mask):
    """float64 `bnorm - 2 a.b` of one pair (masked: inf), sorted: the
    three smallest values of each row."""
    raw = bnorm.astype(np.float64)[None, :] \
        - 2 * a.astype(np.float64) @ b.astype(np.float64).T
    raw = np.where(mask[None, :], raw, np.inf)
    k = min(3, raw.shape[1])
    return np.sort(np.partition(raw, k - 1, axis=1)[:, :k], axis=1)


def _clear_rows(top3, gap):
    """(best, second): rows whose exact best two (second and third) differ
    by more than `gap`; a missing third counts as infinitely far."""
    t = np.pad(top3, ((0, 0), (0, 3 - top3.shape[1])), constant_values=np.inf)
    with np.errstate(invalid="ignore"):
        c1 = t[:, 1] - t[:, 0] > gap
        c2 = c1 & (t[:, 2] - t[:, 1] > gap)
    return c1, c2


def _assert_same(metric, idx, dist, ridx, rdist, clear=None):
    if metric == "l2":
        c1, c2 = clear
        np.testing.assert_array_equal(idx[c1, 0], ridx[c1, 0])
        np.testing.assert_array_equal(idx[c2, 1], ridx[c2, 1])
        np.testing.assert_allclose(dist, rdist, rtol=1e-5, atol=1e-3)
        return
    np.testing.assert_array_equal(idx, ridx)
    if metric == "l2_int8":
        np.testing.assert_array_equal(np.round(dist.astype(np.float64) ** 2),
                                      np.round(rdist.astype(np.float64) ** 2))
        np.testing.assert_allclose(dist, rdist, rtol=2.4e-7, atol=0)
    else:
        np.testing.assert_array_equal(dist, rdist)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("metric,d", [("l2_int8", 64), ("l2_int8", 100),
                                      ("hamming_pm1", 256), ("l2", 64),
                                      ("l2", 100), ("l2", 256)])
def test_knn2_edges_match_reference(case, metric, d):
    d1, d2, m2 = _case(case, metric, d, seed=CASES.index(case) * 7 + d)
    m1 = np.ones(d1.shape[:2], bool)
    idx, dist = tm.knn2(*[torch.from_numpy(x) for x in (d1, d2, m1, m2)],
                        metric=metric)
    for p in range(2):
        ridx, rdist = jm.knn2(jnp.asarray(d1[p]), jnp.asarray(d2[p]),
                              jnp.asarray(m1[p]), jnp.asarray(m2[p]),
                              metric=metric)
        clear = None
        if metric == "l2":
            top3 = _exact_top3(d1[p], d2[p], (d2[p].astype(np.float64) ** 2)
                               .sum(1), m2[p])
            clear = _clear_rows(top3, L2_SQ_GAP)
        _assert_same(metric, idx[p].numpy(), dist[p].numpy(),
                     np.asarray(ridx), np.asarray(rdist), clear)
    if case == "no_valid":
        assert (idx[0].numpy() == 0).all()
        assert (dist[0].numpy() == _pad(metric, d)).all()
    if case == "one_valid":
        for p, c in ((0, d2.shape[1] - 3), (1, 0)):
            assert (idx[p, :, 0].numpy() == c).all()
            assert (idx[p, :, 1].numpy() == 0).all()
            assert (dist[p, :, 1].numpy() == _pad(metric, d)).all()
    if case == "duplicates":
        for p in range(2):
            cols = np.flatnonzero(m2[p])
            lo = cols[1]
            assert (idx[p, :5, 0].numpy() == lo).all()
            # the equal columns tie exactly: the next is the lower copy
            assert (idx[p, :5, 1].numpy() == cols[-2]).all()
            if metric == "l2":   # |a|^2 + |b|^2 - 2 a.b cancels in float32
                assert (dist[p, :5, 0].numpy() <= 1e-3).all()
            else:
                assert (dist[p, :5, 0].numpy() == 0).all()


# `chip_smoke.KNN2_F32_CASES` at small sizes: pairs, N and M cut so that a
# float64 top-2 of every row is cheap, D and the masks as on the card
# (duplicates use columns up to 364, so M stays above)
F32_SMALL_N, F32_SMALL_M = 131, 397


@pytest.mark.parametrize("case", chip_smoke.KNN2_F32_CASES,
                         ids=[c[0] for c in chip_smoke.KNN2_F32_CASES])
def test_knn2_f32_edge_inputs_plain_vs_float64(case):
    """The card's float32 edge inputs (`chip_smoke.knn2_operands`, metric
    "l2") through `knn2_plain`, against a float64 top-2 of the same
    operands: the raw values within 1e-5 (float32 rounding of unit-scale
    sums: |raw| <= 3, D <= 1024), indices equal off near-ties (the
    card's gap, `KNN2_F32_TOL`); what each case claims to build holds."""
    label, metric, B, N, M, D, masks = case
    N, M = min(N, F32_SMALL_N), min(M, F32_SMALL_M)
    a, b, n2, m2 = chip_smoke.knn2_operands(torch, metric, B, N, M, D, masks,
                                            seed=7, dev="cpu")
    assert a.dtype == b.dtype == n2.dtype == torch.float32
    assert a.is_contiguous() and b.is_contiguous()
    if masks == "offset":
        assert a.data_ptr() % 16 != 0 and b.data_ptr() % 16 != 0
    np.testing.assert_allclose(a.norm(dim=-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(b.norm(dim=-1).numpy(), 1.0, rtol=1e-5)
    idx, val = tpm.knn2_plain(a, b, n2, m2)
    big = np.float32(tpm.F32_BIG)
    tol = chip_smoke.KNN2_F32_TOL
    for p in range(B):
        an, bn, nn, mk = (t[p].numpy() for t in (a, b, n2, m2))
        top3 = _exact_top3(an, bn, nn, mk)
        ip, vp = idx[p].numpy(), val[p].numpy()
        nvalid = int(mk.sum())
        for s in range(min(2, nvalid)):
            np.testing.assert_allclose(vp[:, s], top3[:, s], rtol=0, atol=1e-5)
        # a slot with no valid column: column 0 and BIG
        assert (ip[:, nvalid:] == 0).all() and (vp[:, nvalid:] == big).all()
        c1, c2 = _clear_rows(top3, tol)
        exact = bn.astype(np.float64) @ an.astype(np.float64).T   # (M, N)
        raw = np.where(mk[:, None], nn[:, None] - 2 * exact, np.inf)
        order = np.argsort(raw, axis=0, kind="stable")
        np.testing.assert_array_equal(ip[c1, 0], order[0, c1])
        if nvalid >= 2:
            np.testing.assert_array_equal(ip[c2, 1], order[1, c2])
        if masks == "scattered" and nvalid >= 3:
            assert c1.mean() > 0.9, "the generator makes no clear nearest neighbours"
    if masks == "duplicates":
        # rows 0..31 of A equal columns 100..131, copied to 300.. and 301..
        assert torch.equal(b[:, 300:364:2], b[:, 100:132])
        assert torch.equal(b[:, 301:365:2], b[:, 100:132])
        assert torch.equal(idx[:, :32, 0], torch.arange(100, 132, dtype=torch.int32)
                           .expand(B, 32))
        assert torch.equal(idx[:, :32, 1], torch.arange(300, 364, 2, dtype=torch.int32)
                           .expand(B, 32))
    if masks == "edge":
        assert not m2[0].any() and int(m2[1].sum()) == 1 and int(m2[2].sum()) == 1
        assert (idx[1, :, 0] == M // 2).all() and (idx[2, :, 0] == 0).all()


@pytest.mark.parametrize("d", [1, 31, 37, 100, 128, 256])
def test_pad_depth_keeps_the_plain_result(d):
    """The wrapper's depth padding (zero columns to a multiple of 128)
    changes no raw value; it copies nothing when D is a multiple."""
    rng = np.random.default_rng(d)
    a = torch.from_numpy(rng.integers(-128, 128, (2, 45, d)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (2, 51, d)).astype(np.int8))
    bnorm = b.to(torch.int32).square().sum(-1, dtype=torch.int32)
    mask2 = torch.from_numpy(rng.random((2, 51)) < 0.5)
    pa, pb = tpm.pad_depth(a, b)
    step = tpm.I8_DEPTH_STEP
    assert pa.shape[2] % step == 0 and pa.shape[2] - d < step
    assert pb.shape[2] == pa.shape[2]
    assert torch.equal(pa[..., :d], a) and not pa[..., d:].any()
    assert torch.equal(pb[..., :d], b) and not pb[..., d:].any()
    if d % step == 0:
        assert pa.data_ptr() == a.data_ptr() and pb.data_ptr() == b.data_ptr()
    want = tpm.knn2_plain(a, b, bnorm, mask2)
    got = tpm.knn2_plain(pa, pb, bnorm, mask2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_pad_depth_realigns_an_offset_view_and_leaves_float32():
    flat = torch.arange(1 + 3 * 128).to(torch.int8)
    a = flat[1:].view(1, 3, 128)
    assert a.data_ptr() % 16 != 0
    pa, pb = tpm.pad_depth(a, a)
    assert pa.data_ptr() % 16 == 0 and pb.data_ptr() % 16 == 0
    assert torch.equal(pa, a)
    f = torch.zeros(1, 3, 37)
    assert tpm.pad_depth(f, f)[0] is f
