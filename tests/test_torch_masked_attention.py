"""Masked softmax attention, `ops/attention.py:masked_attention`, in both
forms.

On the CPU the wrapper runs the plain form, which must give the same bits
as the compositions LightGlue's blocks computed before it: the self block's
scores divided by sqrt(dh) on rotary q and k (dh 16 and 64, where sqrt(dh)
is a power of two, so dividing by it and multiplying by its reciprocal
round alike), and the cross block's one similarity with a softmax over each
of its axes, in both directions with scale 1. Around it: a row whose keys
are all masked is the mean of v over all keys, Nq != Nk, N = 1 and ragged
N against a float64 loop, the route table, the CPU route launching
nothing, TF32 rounding, and the limit the card tests use rejecting a key
mask ignored or a key tile lost.

On a card the wrapper runs the kernel `csrc/masked_attention.cu`, with TF32
operands, float32 softmax and accumulators. It is held to
`ops.attention.float64_answer_and_limit`: within 4 times the larger of two
TF32 errors measured on the same operands (the plain form's under the TF32
flag, and the float64 answer's on operands rounded to TF32) of the float64
answer, and within the same limit of the plain form under TF32. The
kernel's own error reads 0.20-0.35 of that limit at every case below, while
a key mask ignored or a key tile lost reads 8 times it and more (the
planted faults, which must fail). The cases: the deep cell's shapes (self
at 32 x 2,048; cross in both directions), N of 1, 65, 1,000 and 2,047 and
N0 != N1, dh 64, 32 and others (the 64-row tile at dh above 64), with keys
partly masked, one valid key, a sequence all masked, and q, k and v as
LightGlue's blocks hand them over (the self block's are views into the
packed `Wqkv` output). Tests marked `card` skip without a CUDA card; on one
they run with
`python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_masked_attention.py`
(the card's machine has no JAX, which `tests/conftest.py` imports).
"""

import copy
import math

import numpy as np
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

from tpu3drec_torch.models import lightglue as lg
from tpu3drec_torch.ops import attention as at
from tpu3drec_torch.utils.profiling import counters

LAUNCHES = "masked_attention.launches"


def _launches():
    return counters().get(LAUNCHES, 0)


def _operands(B, nq, nk, h, dh, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, n, h, dh, generator=g) for n in (nq, nk, nk))
    return q.to(device), k.to(device), v.to(device)


def _mask(kind, B, nk, seed, device="cpu"):
    """Key masks: all valid, 30% masked at random, a valid prefix (the
    top-k detectors' layout), one valid key, or sequence 0 all masked."""
    g = torch.Generator().manual_seed(seed)
    if kind == "all":
        m = torch.ones(B, nk, dtype=torch.bool)
    elif kind == "part":
        m = torch.rand(B, nk, generator=g) > 0.3
    elif kind == "prefix":
        n = torch.randint(1, nk + 1, (B,), generator=g)
        m = torch.arange(nk)[None] < n[:, None]
    elif kind == "one_key":
        m = torch.zeros(B, nk, dtype=torch.bool)
        m[torch.arange(B), torch.randint(0, nk, (B,), generator=g)] = True
    elif kind == "seq_masked":
        m = torch.rand(B, nk, generator=g) > 0.3
        m[0] = False
    else:
        raise ValueError(kind)
    return m.to(device)


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


# ---- the compositions the blocks computed before the wrapper

def _old_self(blk, x, cos_i, sin_i, mask):
    B, n, _ = x.shape
    dh = blk.dim // blk.heads
    qkv = blk.Wqkv(x).reshape(B, n, dh, blk.heads, 3)
    q, k, v = (qkv[..., i].transpose(-1, -2) for i in range(3))
    q = lg.apply_rotary(q, cos_i, sin_i)
    k = lg.apply_rotary(k, cos_i, sin_i)
    att = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(dh)
    att = att.masked_fill(~mask[:, None, None, :], -1e9)
    att = torch.softmax(att, dim=-1)
    ctx = torch.einsum("bhnm,bmhd->bnhd", att, v).reshape(B, n, blk.dim)
    return x + blk.ffn(torch.cat([x, blk.out_proj(ctx)], dim=-1))


def _old_cross_messages(qk0, qk1, v0, v1, mask0, mask1):
    sim = torch.einsum("bnhd,bmhd->bhnm", qk0, qk1)
    att01 = torch.softmax(
        sim.masked_fill(~mask1[:, None, None, :], -1e9), dim=-1)
    att10 = torch.softmax(sim.transpose(-1, -2).masked_fill(
        ~mask0[:, None, None, :], -1e9), dim=-1)
    m0 = torch.einsum("bhnm,bmhd->bnhd", att01, v1)
    m1 = torch.einsum("bhmn,bnhd->bmhd", att10, v0)
    return m0, m1


def _old_cross(blk, x0, x1, mask0, mask1):
    B, h = x0.shape[0], blk.heads
    dh = blk.dim // h
    scale = dh ** -0.25
    qk0 = blk.to_qk(x0).reshape(B, -1, h, dh) * scale
    qk1 = blk.to_qk(x1).reshape(B, -1, h, dh) * scale
    v0 = blk.to_v(x0).reshape(B, -1, h, dh)
    v1 = blk.to_v(x1).reshape(B, -1, h, dh)
    m0, m1 = _old_cross_messages(qk0, qk1, v0, v1, mask0, mask1)
    m0 = blk.to_out(m0.reshape(B, -1, blk.dim))
    m1 = blk.to_out(m1.reshape(B, -1, blk.dim))
    return (x0 + blk.ffn(torch.cat([x0, m0], dim=-1)),
            x1 + blk.ffn(torch.cat([x1, m1], dim=-1)))


def _views(B, n0, n1, dim, seed):
    g = torch.Generator().manual_seed(seed)
    x0 = torch.randn(B, n0, dim, generator=g)
    x1 = torch.randn(B, n1, dim, generator=g)
    xy0 = torch.rand(B, n0, 2, generator=g) * 2 - 1
    xy1 = torch.rand(B, n1, 2, generator=g) * 2 - 1
    m0 = torch.rand(B, n0, generator=g) > 0.25
    m1 = torch.rand(B, n1, generator=g) > 0.25
    m1[0] = False                     # a view whose keys are all masked
    return x0, x1, xy0, xy1, m0, m1


BLOCK_SHAPES = [(16, 4, 2, 37, 53), (64, 4, 2, 61, 40), (256, 4, 1, 130, 97)]


@pytest.mark.parametrize("dim,heads,B,n0,n1", BLOCK_SHAPES)
def test_self_block_bits_unchanged(dim, heads, B, n0, n1):
    torch.manual_seed(0)
    blk = lg.SelfBlock(dim, heads).eval()
    pe = lg.FourierPE(dim // heads)
    x0, x1, xy0, xy1, m0, m1 = _views(B, n0, n1, dim, 1)
    with torch.no_grad():
        for x, xy, m in ((x0, xy0, m0), (x1, xy1, m1)):
            cos_i, sin_i = pe(xy)
            assert _same_bits(blk(x, cos_i, sin_i, m),
                              _old_self(blk, x, cos_i, sin_i, m))


@pytest.mark.parametrize("dim,heads,B,n0,n1", BLOCK_SHAPES)
def test_cross_block_bits_unchanged(dim, heads, B, n0, n1):
    torch.manual_seed(0)
    blk = lg.CrossBlock(dim, heads).eval()
    x0, x1, _, _, m0, m1 = _views(B, n0, n1, dim, 2)
    with torch.no_grad():
        got = blk(x0, x1, m0, m1)
        want = _old_cross(blk, x0, x1, m0, m1)
    assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])


@pytest.mark.parametrize("n0,n1", [(37, 53), (128, 128), (1, 9)])
def test_plain_cross_directions_bits_unchanged(n0, n1):
    """Each direction of the cross block through `masked_attention_plain`
    with scale 1 equals that direction of the one-similarity composition."""
    qk0, _, v0 = _operands(2, n0, n0, 4, 16, 3)
    qk1, _, v1 = _operands(2, n1, n1, 4, 16, 4)
    m0, m1 = _mask("part", 2, n0, 5), _mask("seq_masked", 2, n1, 6)
    want0, want1 = _old_cross_messages(qk0, qk1, v0, v1, m0, m1)
    assert _same_bits(at.masked_attention_plain(qk0, qk1, v1, m1, 1.0), want0)
    assert _same_bits(at.masked_attention_plain(qk1, qk0, v0, m0, 1.0), want1)


def _loop_reference(q, k, v, mask, scale):
    """The formula in float64, one (sequence, head, row) at a time."""
    q, k, v = (t.double().numpy() for t in (q, k, v))
    mask = mask.numpy()
    B, nq, h, dh = q.shape
    out = np.zeros((B, nq, h, dh))
    for b in range(B):
        for i in range(h):
            s = scale * q[b, :, i] @ k[b, :, i].T
            s = np.where(mask[b][None, :], s, -1e9)
            w = np.exp(s - s.max(axis=1, keepdims=True))
            out[b, :, i] = (w / w.sum(axis=1, keepdims=True)) @ v[b, :, i]
    return torch.from_numpy(out)


@pytest.mark.parametrize("nq,nk,dh,kind", [
    (1, 1, 8, "all"), (1, 65, 16, "part"), (65, 1, 16, "all"),
    (33, 70, 24, "prefix"), (70, 33, 64, "one_key"), (17, 29, 32,
                                                      "seq_masked")])
def test_cpu_wrapper_against_float64(nq, nk, dh, kind):
    q, k, v = _operands(2, nq, nk, 3, dh, 7)
    m = _mask(kind, 2, nk, 8)
    got = at.masked_attention(q, k, v, m, dh ** -0.5)
    assert got.shape == (2, nq, 3, dh) and got.dtype == torch.float32
    want = _loop_reference(q, k, v, m, dh ** -0.5)
    assert torch.allclose(got.double(), want, rtol=0, atol=2e-6)


def test_cpu_fully_masked_rows_are_the_mean_of_v():
    q, k, v = _operands(2, 11, 23, 4, 16, 9)
    m = _mask("part", 2, 23, 10)
    m[1] = False
    got = at.masked_attention(q, k, v, m, 0.25)
    assert torch.allclose(got[1], v[1].mean(dim=0, keepdim=True).expand(
        11, 4, 16), rtol=0, atol=1e-6)
    # a partly masked row gives its masked keys exactly 0: moving them
    # changes nothing
    v2 = v.clone()
    v2[0, ~m[0]] = 1e6
    assert torch.equal(at.masked_attention(q, k, v2, m, 0.25)[0], got[0])


def test_cpu_route_launches_nothing(monkeypatch):
    def no_kernel(*args, **kwargs):
        raise AssertionError("the CPU route launched the kernel")

    monkeypatch.setattr(at, "masked_attention_kernel", no_kernel)
    before = _launches()
    torch.manual_seed(0)
    net = lg.LightGlueNet(input_dim=32, dim=32, n_layers=2, heads=4).eval()
    x0, x1, xy0, xy1, m0, m1 = _views(2, 20, 24, 32, 11)
    with torch.no_grad():
        net(x0, x1, xy0, xy1, m0, m1)
    assert _launches() == before


@pytest.mark.parametrize("device,dtypes,autocast,tf32,want", [
    ("cpu", (torch.float32,) * 3, False, True, "plain"),
    ("cpu", (torch.float64,) * 3, False, False, "plain"),
    ("cuda", (torch.float32,) * 3, False, True, "kernel"),
    ("cuda", (torch.float32,) * 3, True, True, "kernel"),
    ("cuda", (torch.float32,) * 3, True, False, "kernel"),
    ("cuda", (torch.bfloat16, torch.float32, torch.bfloat16), False, True,
     "kernel"),
    ("cuda", (torch.bfloat16,) * 3, False, False, "kernel"),
    ("cuda", (torch.float32,) * 3, False, False, "kernel_float32"),
    ("cuda", (torch.float16,) * 3, False, True, TypeError),
    ("cuda", (torch.float64,) * 3, False, False, TypeError),
    ("mps", (torch.float32,) * 3, False, True, ValueError),
])
def test_route_table(device, dtypes, autocast, tf32, want):
    if isinstance(want, str):
        assert at.tf32.route("masked_attention", device, dtypes, autocast,
                             tf32) == want
    else:
        with pytest.raises(want):
            at.tf32.route("masked_attention", device, dtypes, autocast,
                          tf32)


@pytest.mark.parametrize("bad", ["rank3", "dh_mismatch", "batch_mismatch",
                                 "v_shape", "mask_dtype", "mask_shape"])
def test_wrapper_rejects(bad):
    q, k, v = _operands(2, 5, 7, 2, 8, 12)
    m = _mask("all", 2, 7, 0)
    if bad == "rank3":
        q = q[0]
    elif bad == "dh_mismatch":
        q = q[..., :4]
    elif bad == "batch_mismatch":
        q = q[:1]
    elif bad == "v_shape":
        v = v[:, :6]
    elif bad == "mask_dtype":
        m = m.float()
    else:
        m = m[:, :6]
    with pytest.raises(ValueError):
        at.masked_attention(q, k, v, m, 1.0)


def test_kernel_route_rejects_cpu_tensors():
    q, k, v = _operands(1, 4, 4, 1, 8, 13)
    with pytest.raises(ValueError):
        at.masked_attention_kernel(q, k, v, _mask("all", 1, 4, 0), 1.0)


def test_tf32_round():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -12, 1 + 3 * 2 ** -12,
                      -(1 + 2 ** -11), 1 + 2 ** -10 - 2 ** -23, 0.0, -0.0,
                      3.0, 2.0 ** -130])
    want = torch.tensor([1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -10,
                         -(1 + 2 ** -10), 1 + 2 ** -10, 0.0, -0.0, 3.0,
                         2.0 ** -130])
    assert _same_bits(at.tf32_round(x), want)
    g = torch.Generator().manual_seed(14)
    x = torch.randn(10000, generator=g) * 10.0 ** torch.randint(
        -20, 20, (10000,), generator=g)
    r = at.tf32_round(x)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((r - x).abs() <= 2.0 ** -11 * x.abs()).all()
    lo = at.split_round(x) - r
    assert (at.tf32_round(lo) == lo).all()
    assert ((at.split_round(x).double() - x.double()).abs()
            <= 2.0 ** -22 * x.double().abs()).all()


def _faulty_mask(m, fault):
    """The key mask a planted fault reads: all keys valid (the mask
    ignored) or keys 64-127 masked (a key tile lost)."""
    if fault == "mask_ignored":
        return torch.ones_like(m)
    bad = m.clone()
    bad[:, 64:128] = False
    return bad


@pytest.mark.parametrize("fault", ["none", "mask_ignored", "tile_dropped"])
@pytest.mark.parametrize("B,nq,nk,dh,kind", [(2, 150, 200, 16, "part"),
                                             (3, 64, 300, 64, "prefix")])
@pytest.mark.parametrize("full_float32", [False, True])
def test_limit_rejects_planted_faults(fault, B, nq, nk, dh, kind,
                                      full_float32):
    """On the CPU, with the plain form in float32 on operands rounded as
    the kernel reads them standing in for the kernel: it is within the
    limit, and a key mask ignored or a key tile lost is not."""
    q, k, v = _operands(B, nq, nk, 2, dh, 30)
    m = _mask(kind, B, nk, 31)
    m[:, :128] = True          # the lost tile holds valid keys
    want, limit = at.float64_answer_and_limit(q, k, v, m, dh ** -0.5,
                                              full_float32)
    mask = m if fault == "none" else _faulty_mask(m, fault)
    rnd = at.split_round if full_float32 else at.tf32_round
    got = at.masked_attention_plain(rnd(q), rnd(k), rnd(v), mask, dh ** -0.5)
    err = float((got.double() - want).abs().max())
    assert (err <= limit) == (fault == "none"), (err, limit)


# ---------------------------------------------------------------- the card

U = 2.0 ** -11      # TF32's unit roundoff: 10 stored mantissa bits


@pytest.fixture
def card():
    """Skips where no CUDA card is present (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpu3drec_torch import _nvcc
    _nvcc.load("masked_attention")
    return torch.device("cuda")


@pytest.fixture
def tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def _check_on_card(q, k, v, m, scale, label, full_float32=False):
    """Two launches give the same bits, and the kernel is within
    `float64_answer_and_limit`'s limit of the float64 answer and of the
    plain form in the same precision (TF32, or full float32)."""
    before = _launches()
    out = at.masked_attention_kernel(q, k, v, m, scale, full_float32)
    again = at.masked_attention_kernel(q, k, v, m, scale, full_float32)
    torch.backends.cuda.matmul.allow_tf32 = not full_float32
    try:
        plain = at.masked_attention_plain(q, k, v, m, scale)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True
    torch.cuda.synchronize()
    assert _launches() - before == 2, label
    assert torch.isfinite(out).all(), label
    assert _same_bits(out, again), f"{label}: two launches differ"
    want, limit = at.float64_answer_and_limit(q, k, v, m, scale,
                                              full_float32)
    err = float((out.double() - want).abs().max())
    assert err <= limit, f"{label}: {err:.3e} from float64, limit {limit:.3e}"
    err_plain = float((out - plain).abs().max())
    assert err_plain <= limit, \
        f"{label}: {err_plain:.3e} from the plain form, limit {limit:.3e}"


CARD_CASES = [
    # B, nq, nk, h, dh, mask
    (2, 1, 1, 4, 64, "all"),
    (2, 65, 65, 4, 64, "part"),
    (2, 1000, 1000, 4, 64, "prefix"),
    (2, 2047, 2047, 4, 64, "seq_masked"),
    (3, 1000, 777, 4, 64, "part"),
    (3, 777, 1000, 4, 64, "one_key"),
    (2, 300, 200, 4, 32, "part"),
    (2, 300, 200, 4, 32, "seq_masked"),
    (2, 2047, 65, 4, 32, "prefix"),
    (2, 100, 130, 2, 128, "part"),
    (2, 200, 130, 2, 96, "seq_masked"),
    (2, 100, 130, 2, 8, "prefix"),
    (2, 100, 130, 2, 40, "one_key"),
    (1, 1, 2047, 1, 64, "part"),
]


@pytest.mark.card
@pytest.mark.parametrize("B,nq,nk,h,dh,kind", CARD_CASES)
@pytest.mark.parametrize("full_float32", [False, True])
def test_card_kernel_cases(card, tf32, B, nq, nk, h, dh, kind, full_float32):
    q, k, v = _operands(B, nq, nk, h, dh, 20, card)
    m = _mask(kind, B, nk, 21, card)
    _check_on_card(q, k, v, m, 1 / math.sqrt(dh),
                   f"{B}x{nq}x{nk} h{h} dh{dh} {kind}", full_float32)


@pytest.mark.card
@pytest.mark.parametrize("fault", ["mask_ignored", "tile_dropped"])
@pytest.mark.parametrize("B,n,kind,full_float32", [
    (32, 2048, "prefix", False), (3, 1000, "part", False),
    (3, 1000, "part", True)])
def test_card_limit_rejects_planted_faults(card, tf32, fault, B, n, kind,
                                           full_float32):
    """The kernel run on the mask a fault would read (all keys valid, or
    keys 64-127 masked) is outside the limit of the true answer."""
    q, k, v = _operands(B, n, n, 4, 64, 32, card)
    m = _mask(kind, B, n, 33, card)
    want, limit = at.float64_answer_and_limit(q, k, v, m, 0.125,
                                              full_float32)
    out = at.masked_attention_kernel(q, k, v, _faulty_mask(m, fault), 0.125,
                                     full_float32)
    err = float((out.double() - want).abs().max())
    assert err > limit, f"{fault}: {err:.3e} within the limit {limit:.3e}"


@pytest.mark.card
def test_card_fully_masked_sequence_is_the_mean_of_v(card, tf32):
    q, k, v = _operands(2, 300, 257, 4, 64, 22, card)
    m = _mask("seq_masked", 2, 257, 23, card)
    out = at.masked_attention(q, k, v, m, 0.125)
    mean = v[0].double().mean(dim=0)
    assert float((out[0].double() - mean).abs().max()) \
        <= (3 * U + 257 * 2.0 ** -23) * float(v.abs().max())


@pytest.mark.card
@pytest.mark.parametrize("direction", ["self", "cross_01", "cross_10"])
@pytest.mark.parametrize("full_float32", [False, True])
def test_card_kernel_at_the_cell_shapes(card, tf32, direction, full_float32):
    """The deep cell's batch: 32 pairs of 2,048 keypoints, 4 heads of 64,
    valid prefixes as SuperPoint's top-k leaves them; self with
    1/sqrt(dh), cross with dh^-0.25 on each side and scale 1."""
    B, n, h, dh = 32, 2048, 4, 64
    q, k, v = _operands(B, n, n, h, dh, 24, card)
    m = _mask("prefix", B, n, 25, card)
    if direction == "self":
        scale = 1 / math.sqrt(dh)
    else:
        q, k, scale = q * dh ** -0.25, k * dh ** -0.25, 1.0
        if direction == "cross_10":
            q, k = k, q
    _check_on_card(q, k, v, m, scale, direction, full_float32)


def _block_operands(card, B, n0, n1, dim, heads):
    """q, k, v, mask and scale of every `masked_attention` call of one
    LightGlue layer, as the blocks hand them over."""
    seen = []
    real = lg.masked_attention

    def spy(q, k, v, mask, scale):
        seen.append((q, k, v, mask, scale))
        return real(q, k, v, mask, scale)

    torch.manual_seed(0)
    layer = lg.GlueLayer(dim, heads).to(card).eval()
    pe = lg.FourierPE(dim // heads).to(card)
    x0, x1, xy0, xy1, m0, m1 = (t.to(card) for t in _views(B, n0, n1, dim, 26))
    lg.masked_attention = spy
    try:
        with torch.no_grad():
            layer(x0, x1, pe(xy0), pe(xy1), m0, m1)
    finally:
        lg.masked_attention = real
    return seen


@pytest.mark.card
@pytest.mark.parametrize("B,n0,n1,dim", [(4, 2048, 2048, 256),
                                         (3, 1000, 777, 256),
                                         (2, 65, 300, 128)])
def test_card_kernel_on_the_blocks_operands(card, tf32, B, n0, n1, dim):
    calls = _block_operands(card, B, n0, n1, dim, 4)
    assert len(calls) == 4            # two self views, two cross directions
    assert not calls[0][0].is_contiguous() or not calls[0][2].is_contiguous()
    for i, (q, k, v, m, scale) in enumerate(calls):
        _check_on_card(q, k, v, m, scale, f"call {i}")


@pytest.mark.card
def test_card_counts_one_launch_a_call(card, tf32):
    torch.manual_seed(0)
    net = lg.LightGlueNet(input_dim=64, dim=64, n_layers=3, heads=4)
    net = net.to(card).eval()
    x0, x1, xy0, xy1, m0, m1 = (t.to(card) for t in _views(2, 100, 90, 64, 27))
    before = _launches()
    with torch.no_grad():
        net(x0, x1, xy0, xy1, m0, m1)
    torch.cuda.synchronize()
    assert _launches() - before == 4 * 3


@pytest.mark.card
def test_card_bfloat16_operands_and_autocast_take_the_kernel(card, tf32):
    """bfloat16 operands are read as float32 (exactly) by the kernel, and
    a call under autocast takes the kernel whatever its operands."""
    q, k, v = _operands(2, 300, 257, 4, 64, 34, card)
    m = _mask("part", 2, 257, 35, card)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    before = _launches()
    got = at.masked_attention(qb, kb, vb, m, 0.125)
    want = at.masked_attention_kernel(qb.float(), kb.float(), vb.float(), m,
                                      0.125)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        got_auto = at.masked_attention(q, k, v, m, 0.125)
    torch.cuda.synchronize()
    assert _launches() - before == 3
    assert got.dtype == torch.float32 and _same_bits(got, want)
    assert _same_bits(got_auto, at.masked_attention_kernel(q, k, v, m, 0.125))


@pytest.mark.card
@pytest.mark.parametrize("mode", ["highest", "bfloat16"])
def test_card_other_modes(card, mode):
    """LightGlue on the card launches the kernel in every block under
    `matmul_precision="highest"` (full float32) and under bfloat16
    activations. At "highest" its log-assignment is within 8 times the
    CPU's float32 error (against float64) of the CPU's, as
    `chip_smoke.py` holds the full-size network; under bfloat16 it tracks
    the float32 answer as on the CPU
    (`test_torch_models.py:test_bfloat16_activations_track_float32`)."""
    torch.manual_seed(0)
    net = lg.LightGlueNet(input_dim=64, dim=64, n_layers=2, heads=4).eval()
    views = _views(2, 100, 90, 64, 28)
    x0, x1, xy0, xy1, m0, m1 = (t.to(card) for t in views)
    before = _launches()
    wrapper = (lg.LightGlue(net.to(card), matmul_precision="highest")
               if mode == "highest"
               else lg.LightGlue(net.to(card), activation_dtype="bfloat16"))
    la, sim, _, _ = wrapper.forward(x0, x1, xy0, xy1, m0, m1)
    torch.cuda.synchronize()
    assert _launches() - before == 4 * 2
    ok = m0[:, :, None] & m1[:, None, :]
    if mode == "highest":
        cpu = lg.LightGlue(net.cpu(), matmul_precision="highest")
        la32 = cpu.forward(*views)[0]
        wide = lg.LightGlue(copy.deepcopy(net).double(),
                            matmul_precision="highest")
        la64 = wide.forward(*(t.double() if t.is_floating_point() else t
                              for t in views))[0]
        okc = ok.cpu()
        err32 = float((la32.double() - la64)[okc].abs().max())
        gap = float((la.cpu().double() - la32.double())[okc].abs().max())
        assert gap <= 8 * err32, (gap, err32)
        return
    _, sim32, _, _ = lg.LightGlue(net).forward(x0, x1, xy0, xy1, m0, m1)
    assert sim.dtype == torch.float32
    corr = np.corrcoef(sim32[ok].cpu().numpy(), sim[ok].cpu().numpy())[0, 1]
    agree = (sim32.argmax(-1) == sim.argmax(-1))[m0].float().mean()
    assert corr > 0.98 and agree > 0.9, (corr, agree)
