"""`knn2`'s edge cases, held against the reference's XLA `knn2`.

The card's `knn2` kernel sweeps a device list of each pair's valid
columns on the int8 tensor cores; `chip_smoke.py` holds it bit for bit
against `knn2_plain` on the inputs below. Here the same inputs go
through the port's `knn2` (the plain version on the CPU) and through
`tpu3drec.ops.match.knn2` (XLA, not the interpret-mode Pallas kernel,
whose every new shape costs a long compile): scattered masks, no valid
column, one valid column, exact duplicate columns (ties), N and M that
are multiples of no tile, D of 64, 100 and 256, for `l2_int8` and
`hamming_pm1`.

Tolerances: both metrics are exact integer arithmetic in both packages,
so indices and squared distances (Hamming counts) must be equal; the
final float32 square root of `l2_int8` may differ by one ulp (XLA's CPU
sqrt is not correctly rounded), hence rtol 2.4e-7 on the distances.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

from tpu3drec.ops import match as jm
from tpu3drec_torch.ops import match as tm
from tpu3drec_torch.ops import pallas_match as tpm

CASES = ["scattered", "no_valid", "one_valid", "duplicates", "odd_shape"]


def _descriptors(rng, n, d, metric):
    if metric == "hamming_pm1":
        return rng.integers(0, 2, (n, d)).astype(np.float32) * 2 - 1
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
    big = np.float32(tpm.INT_BIG)
    return np.sqrt(big) if metric == "l2_int8" else (big + d) * np.float32(0.5)


def _assert_same(metric, idx, dist, ridx, rdist):
    np.testing.assert_array_equal(idx, ridx)
    if metric == "l2_int8":
        np.testing.assert_array_equal(np.round(dist.astype(np.float64) ** 2),
                                      np.round(rdist.astype(np.float64) ** 2))
        np.testing.assert_allclose(dist, rdist, rtol=2.4e-7, atol=0)
    else:
        np.testing.assert_array_equal(dist, rdist)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("metric,d", [("l2_int8", 64), ("l2_int8", 100),
                                      ("hamming_pm1", 256)])
def test_knn2_edges_match_reference(case, metric, d):
    d1, d2, m2 = _case(case, metric, d, seed=CASES.index(case) * 7 + d)
    m1 = np.ones(d1.shape[:2], bool)
    idx, dist = tm.knn2(*[torch.from_numpy(x) for x in (d1, d2, m1, m2)],
                        metric=metric)
    for p in range(2):
        ridx, rdist = jm.knn2(jnp.asarray(d1[p]), jnp.asarray(d2[p]),
                              jnp.asarray(m1[p]), jnp.asarray(m2[p]),
                              metric=metric)
        _assert_same(metric, idx[p].numpy(), dist[p].numpy(),
                     np.asarray(ridx), np.asarray(rdist))
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
            lo = np.flatnonzero(m2[p])[1]
            assert (idx[p, :5, 0].numpy() == lo).all()
            assert (dist[p, :5, 0].numpy() == 0).all()


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
