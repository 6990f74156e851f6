"""Channels-last convolution with bias, ReLU and 2x2 max pool,
`ops/conv.py:conv2d_nhwc`, in both forms, and SuperPoint's forward on it.

On the CPU the wrapper runs the plain form, which must give what
`F.conv2d`, the ReLU and `max_pool2d` give in NCHW (1x1 and 3x3, Cin 1, 64
and 128, with and without the ReLU and the pool, odd and even sizes), and
SuperPoint's channels-last forward must give the descriptor bits of the
NCHW forward it replaced and the heat bits of its logits under a softmax
over the last axis. Around it: the route table, the wrapper's rejections,
the CPU route launching nothing, and the limit the card tests use
rejecting a dropped bias, a dropped ReLU, a pool window shifted by one
pixel and a halo read as zero inside the image.

On a card the wrapper runs the kernel `csrc/conv_nhwc.cu`, with TF32
operands and float32 accumulators, or in 3xTF32 with TF32 off. It is held
to `ops.conv.float64_answer_and_limit` (4 times the largest of the plain
form's error in the same precision, the error of operands rounded as the
kernel reads them and 2^-23 of the largest sum of magnitudes) of the
float64 answer, and within the same limit of the plain form in the same
precision, at every SuperPoint layer's shape at 768x1024, at ragged
edges and at a batch of one; the planted faults above must fall outside
it. Tests marked `card` skip without a CUDA card; on one they run with
`python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_conv_nhwc.py`
(the card's machine has no JAX, which `tests/conftest.py` imports).
"""

import pytest
import torch
import torch.nn.functional as F
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

from tpu3drec_torch.models import superpoint as sp
from tpu3drec_torch.models._common import l2_normalize, precision
from tpu3drec_torch.ops import conv as cv
from tpu3drec_torch.ops.tf32 import split_round, tf32_round
from tpu3drec_torch.utils.profiling import counters

LAUNCHES = "conv_nhwc.launches"


def _launches():
    return counters().get(LAUNCHES, 0)


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _operands(B, H, W, cin, cout, k, seed, device="cpu"):
    """x (B, H, W, Cin) as a layer sees it (an image in [0, 1] at Cin 1,
    else ReLU'd activations), He-scaled weights (Cout, Cin, k, k) and a
    bias of spread 0.5, so a dropped bias or ReLU shows."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand(B, H, W, 1, generator=g) if cin == 1
         else torch.relu(torch.randn(B, H, W, cin, generator=g)))
    w = torch.randn(cout, cin, k, k, generator=g) * (2 / (cin * k * k)) ** 0.5
    b = torch.randn(cout, generator=g) * 0.5
    return x.to(device), w.to(device), b.to(device)


def _nchw(x, w, b, relu, pool):
    """The composition in NCHW: conv, ReLU, max_pool2d, as NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2).contiguous(), w, b,
                 padding=w.shape[-1] // 2)
    if relu:
        y = F.relu(y)
    if pool:
        y = F.max_pool2d(y, 2, 2)
    return y.permute(0, 2, 3, 1)


PLAIN_CASES = [
    # k, Cin, Cout, H, W, relu, pool
    (3, 1, 64, 10, 13, True, False),
    (3, 1, 64, 12, 16, True, True),
    (3, 64, 64, 12, 16, True, True),
    (3, 64, 64, 9, 15, True, False),
    (3, 64, 128, 11, 13, True, True),
    (3, 128, 128, 8, 14, False, False),
    (3, 128, 256, 7, 9, True, False),
    (1, 64, 65, 7, 9, False, False),
    (1, 128, 256, 6, 11, False, False),
    (1, 128, 64, 10, 12, True, True),
]


@pytest.mark.parametrize("k,cin,cout,H,W,relu,pool", PLAIN_CASES)
def test_plain_against_nchw(k, cin, cout, H, W, relu, pool):
    x, w, b = _operands(2, H, W, cin, cout, k, 1)
    got = cv.conv2d_nhwc(x, w, b, relu, pool)
    shape = (2, H // 2, W // 2, cout) if pool else (2, H, W, cout)
    assert got.shape == shape and got.dtype == torch.float32
    want = _nchw(x, w, b, relu, pool)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    # on the NCHW view of an NCHW tensor it is the same call: same bits
    xv = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert _same_bits(cv.conv2d_nhwc(xv, w, b, relu, pool), want)
    if not relu and not pool:
        assert _same_bits(cv.conv2d_nhwc(xv, w, None),
                          _nchw(xv, w, None, False, False))


def _old_forward(net, x):
    """SuperPointNet's forward before it went channels-last, and its
    detector logits."""
    x = x.permute(0, 3, 1, 2)
    for i, (name, _, _) in enumerate(sp._CONVS):
        x = F.relu(getattr(net, name)(x), inplace=True)
        if i in (1, 3, 5):
            x = F.max_pool2d(x, 2, 2)
    semi = net.convPb(F.relu(net.convPa(x)))
    prob = torch.softmax(semi.float(), dim=1)[:, :64]
    heat = F.pixel_shuffle(prob, 8)[:, 0]
    desc = net.convDb(F.relu(net.convDa(x))).float()
    return heat, l2_normalize(desc, 1).permute(0, 2, 3, 1), semi


@pytest.mark.parametrize("B,H,W", [(2, 48, 64), (1, 40, 72), (3, 16, 24)])
def test_superpoint_forward_bits_unchanged(B, H, W):
    """The descriptors keep their bits. The heat keeps the bits of the old
    logits under the softmax over the last axis; the old softmax over the
    channel axis of NCHW sums its 65 terms in another order (a few 1e-9)."""
    net = sp.SuperPoint().init_random(torch.Generator().manual_seed(2))
    x = torch.rand(B, H, W, 1, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        heat, desc = net(x)
        old_heat, old_desc, semi = _old_forward(net, x)
    assert heat.shape == (B, H, W) and desc.shape == (B, H // 8, W // 8, 256)
    assert _same_bits(desc, old_desc)
    prob = torch.softmax(semi.float().permute(0, 2, 3, 1), dim=-1)[..., :64]
    assert _same_bits(heat, F.pixel_shuffle(
        prob.permute(0, 3, 1, 2), 8)[:, 0])
    assert float((heat - old_heat).abs().max()) <= 2.0 ** -23


F32 = (torch.float32,) * 2


@pytest.mark.parametrize("device,dtypes,autocast,cudnn,matmul,want", [
    ("cpu", F32, False, True, True, "plain"),
    ("cpu", (torch.float64,) * 2, False, False, False, "plain"),
    ("cpu", (torch.bfloat16, torch.float32), True, False, False, "plain"),
    ("cuda", F32, False, True, True, "kernel"),
    ("cuda", F32, False, True, False, "kernel"),
    ("cuda", F32, False, False, True, "kernel_float32"),
    ("cuda", F32, True, True, True, "kernel"),
    ("cuda", F32, True, False, False, "kernel"),
    ("cuda", (torch.bfloat16, torch.float32), False, False, False, "kernel"),
    ("cuda", (torch.bfloat16,) * 2, False, True, True, "kernel"),
    ("cuda", F32, False, False, False, "kernel_float32"),
    ("cuda", (torch.float16, torch.float32), False, True, True, TypeError),
    ("cuda", (torch.float64,) * 2, False, False, False, TypeError),
    ("mps", F32, False, True, True, ValueError),
])
def test_route_table(monkeypatch, device, dtypes, autocast, cudnn, matmul,
                     want):
    """`conv2d_nhwc` hands `ops.tf32.route` its dtypes and cuDNN's TF32
    flag, which governs the plain form's convolutions, whatever cuBLAS's
    flag says; the table then gives `want` on `device`. The call is made
    on the CPU and its arguments replayed with `device` and `autocast`."""
    seen = []
    table = cv.tf32.route

    def spy(what, device_type, dts, auto, allow_tf32):
        seen.append((what, dts, allow_tf32))
        raise StopIteration

    monkeypatch.setattr(cv.tf32, "route", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", cudnn)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", matmul)
    x = torch.zeros(1, 4, 4, 4, dtype=dtypes[0])
    w = torch.zeros(8, 4, 3, 3, dtype=dtypes[1])
    with pytest.raises(StopIteration):
        cv.conv2d_nhwc(x, w, None, True, False)
    what, dts, allow_tf32 = seen[0]
    assert what == "conv_nhwc" and dts == dtypes and allow_tf32 == cudnn
    if isinstance(want, str):
        assert table(what, device, dts, autocast, allow_tf32) == want
    else:
        with pytest.raises(want):
            table(what, device, dts, autocast, allow_tf32)


@pytest.mark.parametrize("bad", ["rank3", "weight_rank3", "cin_mismatch",
                                 "k5", "k_not_square", "bias_shape",
                                 "devices"])
def test_wrapper_rejects(bad):
    x, w, b = _operands(1, 6, 8, 4, 8, 3, 4)
    if bad == "rank3":
        x = x[0]
    elif bad == "weight_rank3":
        w = w[..., 0]
    elif bad == "cin_mismatch":
        w = w[:, :3]
    elif bad == "k5":
        w = torch.zeros(8, 4, 5, 5)
    elif bad == "k_not_square":
        w = w[..., :1]
    elif bad == "bias_shape":
        b = b[:7]
    else:
        b = b.to("meta")
    with pytest.raises(ValueError):
        cv.conv2d_nhwc(x, w, b, True, False)


@pytest.mark.parametrize("bad", ["cpu", "cin3", "cout_not_4_at_cin1",
                                 "cout_over_1024_at_cin1", "k1_at_cin1",
                                 "pool_at_cin1", "float64"])
def test_kernel_route_rejects(bad):
    """The kernel's own route takes CUDA float32 with Cin a multiple of 4,
    or Cin 1 in a 3x3 convolution without the pool (SuperPoint's first
    layer) with Cout a multiple of 4 up to 1024; everything it refuses
    raises before a launch."""
    cin, cout = {"cin3": (3, 8), "cout_not_4_at_cin1": (1, 6),
                 "cout_over_1024_at_cin1": (1, 1028), "k1_at_cin1": (1, 8),
                 "pool_at_cin1": (1, 8)}.get(bad, (4, 8))
    x, w, b = _operands(1, 6, 8, cin, cout, 1 if bad == "k1_at_cin1" else 3,
                        5)
    if bad == "float64":
        x = x.double()
    before = _launches()
    with pytest.raises(TypeError if bad == "float64" else ValueError):
        cv.conv2d_nhwc_kernel(x, w, b, True, bad == "pool_at_cin1")
    assert _launches() == before


def test_cpu_route_launches_nothing(monkeypatch):
    def no_kernel(*args, **kwargs):
        raise AssertionError("the CPU route launched the kernel")

    monkeypatch.setattr(cv, "conv2d_nhwc_kernel", no_kernel)
    before = _launches()
    net = sp.SuperPoint().init_random(torch.Generator().manual_seed(6))
    with torch.no_grad():
        net(torch.rand(1, 16, 24, 1))
    assert _launches() == before


def test_kernel_weight_is_k_major():
    w = torch.arange(2 * 3 * 3 * 3, dtype=torch.float32).reshape(2, 3, 3, 3)
    kw = cv.kernel_weight(w)
    assert kw.shape == (2, 3, 3, 3) and kw.is_contiguous()
    assert kw[1, 2, 0, 1] == w[1, 1, 2, 0]


def _faulty(run, x, w, b, relu, pool, fault):
    """What a kernel with a planted fault would give, from `run(x, w, b,
    relu, pool)` on the inputs the fault reads: the bias dropped, the ReLU
    dropped, the pool's windows one pixel to the right (the input shifted
    left by a column), or the halo read as zero at a seam inside the image
    (the two sides run apart, split at a multiple of 32 columns)."""
    if fault == "none":
        return run(x, w, b, relu, pool)
    if fault == "bias_dropped":
        return run(x, w, torch.zeros_like(b), relu, pool)
    if fault == "relu_dropped":
        return run(x, w, b, False, pool)
    if fault == "pool_shifted":
        xs = torch.cat([x[:, :, 1:], torch.zeros_like(x[:, :, :1])], 2)
        return run(xs, w, b, relu, pool)
    cut = 32 * max(1, x.shape[2] // 64)
    return torch.cat([run(x[:, :, :cut], w, b, relu, pool),
                      run(x[:, :, cut:], w, b, relu, pool)], 2)


FAULTS = ["none", "bias_dropped", "relu_dropped", "pool_shifted",
          "halo_zero"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cin", [1, 64])
@pytest.mark.parametrize("full_float32", [False, True])
def test_limit_rejects_planted_faults(fault, cin, full_float32):
    """On the CPU, with the plain form on operands rounded as the kernel
    reads them standing in for the kernel: it is within the limit, and
    each planted fault is not. Pooled at Cin 64 (conv1b), not at Cin 1
    (conv1a), as SuperPoint has them."""
    x, w, b = _operands(2, 16, 70, cin, 64, 3, 7)
    pool = cin > 1
    want, limit = cv.float64_answer_and_limit(x, w, b, True, pool,
                                              full_float32)
    rnd = split_round if full_float32 else tf32_round

    def stand_in(x, w, b, relu, pool):
        return cv.conv2d_nhwc_plain(rnd(x), rnd(w), b, relu, pool)

    got = _faulty(stand_in, x, w, b, True, pool, fault)
    err = float((got.double() - want).abs().max())
    assert (err <= limit) == (fault == "none"), (err, limit)


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    """Skips where no CUDA card is present (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpu3drec_torch import _nvcc
    _nvcc.load("conv_nhwc")
    return torch.device("cuda")


def _check_on_card(x, w, b, relu, pool, label, full_float32=False):
    """Two launches give the same bits, and the kernel is within
    `float64_answer_and_limit`'s limit of the float64 answer and of the
    plain form in the same precision (cuDNN's TF32 flag on, or off)."""
    before = _launches()
    out = cv.conv2d_nhwc_kernel(x, w, b, relu, pool, full_float32)
    again = cv.conv2d_nhwc_kernel(x, w, b, relu, pool, full_float32)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = not full_float32
    try:
        plain = cv.conv2d_nhwc_plain(x, w, b, relu, pool)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    torch.cuda.synchronize()
    assert _launches() - before == 2, label
    assert torch.isfinite(out).all(), label
    assert _same_bits(out, again), f"{label}: two launches differ"
    want, limit = cv.float64_answer_and_limit(x, w, b, relu, pool,
                                              full_float32)
    err = float((out.double() - want).abs().max())
    assert err <= limit, f"{label}: {err:.3e} from float64, limit {limit:.3e}"
    err_plain = float((out - plain).abs().max())
    assert err_plain <= limit, \
        f"{label}: {err_plain:.3e} from the plain form, limit {limit:.3e}"


# SuperPoint's twelve layers at 768x1024: name, input (H, W), Cin, Cout,
# k, relu, pool
SP_LAYERS = [
    ("conv1a", 768, 1024, 1, 64, 3, True, False),
    ("conv1b", 768, 1024, 64, 64, 3, True, True),
    ("conv2a", 384, 512, 64, 64, 3, True, False),
    ("conv2b", 384, 512, 64, 64, 3, True, True),
    ("conv3a", 192, 256, 64, 128, 3, True, False),
    ("conv3b", 192, 256, 128, 128, 3, True, True),
    ("conv4a", 96, 128, 128, 128, 3, True, False),
    ("conv4b", 96, 128, 128, 128, 3, True, False),
    ("convPa", 96, 128, 128, 256, 3, True, False),
    ("convPb", 96, 128, 256, 65, 1, False, False),
    ("convDa", 96, 128, 128, 256, 3, True, False),
    ("convDb", 96, 128, 256, 256, 1, False, False),
]


@pytest.mark.card
@pytest.mark.parametrize("layer", SP_LAYERS, ids=[r[0] for r in SP_LAYERS])
@pytest.mark.parametrize("full_float32", [False, True])
def test_card_superpoint_layers(card, layer, full_float32):
    name, H, W, cin, cout, k, relu, pool = layer
    x, w, b = _operands(2, H, W, cin, cout, k, 20, card)
    _check_on_card(x, w, b, relu, pool, name, full_float32)


@pytest.mark.card
@pytest.mark.parametrize("B,H,W,cin,cout,k,relu,pool", [
    (3, 37, 53, 64, 64, 3, True, True),      # odd sizes, pooled
    (3, 37, 53, 64, 64, 3, True, False),
    (2, 19, 45, 128, 128, 3, False, False),
    (2, 21, 70, 256, 65, 1, False, False),   # Cout 65: a ragged block
    (2, 37, 53, 1, 64, 3, True, False),
    (2, 5, 3, 12, 20, 3, True, False),       # smaller than a tile
    (1, 1, 1, 4, 8, 1, False, False),
    (1, 768, 1024, 64, 64, 3, True, True),   # a batch of one
    (1, 768, 1024, 1, 64, 3, True, False),
])
@pytest.mark.parametrize("full_float32", [False, True])
def test_card_ragged_and_batch_one(card, B, H, W, cin, cout, k, relu, pool,
                                   full_float32):
    x, w, b = _operands(B, H, W, cin, cout, k, 21, card)
    _check_on_card(x, w, b, relu, pool, f"{B}x{H}x{W} {cin}->{cout} k{k}",
                   full_float32)


@pytest.mark.card
@pytest.mark.parametrize("layer", SP_LAYERS[:2], ids=["conv1a", "conv1b"])
@pytest.mark.parametrize("full_float32", [False, True])
def test_card_offsets_past_2_31(card, layer, full_float32):
    """At 48 images of 768x1024, conv1a's output and conv1b's input hold
    2.4e9 floats, past 2^31: the last image, all of it past that offset,
    is within the limit of its float64 answer and has the bits of the
    same image launched alone (the deep cell gives each layer 64)."""
    name, H, W, cin, cout, k, relu, pool = layer
    _, w, b = _operands(1, 1, 1, cin, cout, k, 26, card)
    gen = torch.Generator(device=card).manual_seed(27)
    x = (torch.rand(48, H, W, 1, device=card, generator=gen) if cin == 1
         else torch.randn(48, H, W, cin, device=card, generator=gen).relu_())
    assert max(x.numel(), 48 * H * W * cout) > 2 ** 31
    last = cv.conv2d_nhwc_kernel(x, w, b, relu, pool, full_float32)[-1:]
    x1 = x[-1:].clone()
    del x
    alone = cv.conv2d_nhwc_kernel(x1, w, b, relu, pool, full_float32)
    torch.cuda.synchronize()
    assert _same_bits(last, alone), f"{name}: the last image's bits moved"
    want, limit = cv.float64_answer_and_limit(x1, w, b, relu, pool,
                                              full_float32)
    err = float((last.double() - want).abs().max())
    assert err <= limit, f"{name}: {err:.3e} from float64, limit {limit:.3e}"


@pytest.mark.card
@pytest.mark.parametrize("fault", FAULTS[1:])
@pytest.mark.parametrize("cin", [1, 64])
@pytest.mark.parametrize("full_float32", [False, True])
def test_card_limit_rejects_planted_faults(card, fault, cin, full_float32):
    """The kernel run on the inputs a fault reads (or without the bias or
    the ReLU, or on two sides of a seam) is outside the limit of the true
    answer; pooled at Cin 64, not at Cin 1."""
    x, w, b = _operands(2, 64, 192, cin, 64, 3, 22, card)
    pool = cin > 1
    want, limit = cv.float64_answer_and_limit(x, w, b, True, pool,
                                              full_float32)

    def kernel(x, w, b, relu, pool):
        return cv.conv2d_nhwc_kernel(x, w, b, relu, pool, full_float32)

    out = _faulty(kernel, x, w, b, True, pool, fault)
    err = float((out.double() - want).abs().max())
    assert err > limit, f"{fault}: {err:.3e} within the limit {limit:.3e}"


@pytest.mark.card
def test_card_bfloat16_and_autocast_take_the_kernel(card):
    """bfloat16 operands are read as float32 (exactly) by the TF32 kernel,
    and a call under autocast takes it whatever its operands; float32
    with cuDNN's TF32 flag off takes 3xTF32 though cuBLAS's is on."""
    x, w, b = _operands(2, 40, 56, 64, 64, 3, 23, card)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        before = _launches()
        got = cv.conv2d_nhwc(x.bfloat16(), w, b, True, True)
        want = cv.conv2d_nhwc_kernel(x.bfloat16().float(), w, b, True, True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got_auto = cv.conv2d_nhwc(x, w, b, True, True)
        full = cv.conv2d_nhwc(x, w, b, True, True)
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    assert _launches() - before == 4
    assert got.dtype == torch.float32 and _same_bits(got, want)
    assert _same_bits(got_auto, cv.conv2d_nhwc_kernel(x, w, b, True, True))
    assert _same_bits(full, cv.conv2d_nhwc_kernel(x, w, b, True, True, True))


@pytest.mark.card
@pytest.mark.parametrize("mode", ["default", "highest"])
def test_card_superpoint_forward(card, mode):
    """SuperPointNet on the card makes 12 launches a forward, and tracks
    the CPU's float32 forward: within TF32's error under "default", within
    8 times the CPU's own float32 error (against float64) under
    "highest"."""
    net = sp.SuperPoint().init_random(torch.Generator().manual_seed(24))
    x = torch.rand(2, 96, 128, 1, generator=torch.Generator().manual_seed(25))
    with torch.no_grad():
        heat32, desc32 = net(x)
        wide = sp.SuperPointNet().double()
        wide.load_state_dict(net.state_dict())
        heat64, desc64 = wide(x.double())
        net.to(card)
        before = _launches()
        with precision(mode):
            heat, desc = net(x.to(card))
        torch.cuda.synchronize()
    assert _launches() - before == 12
    assert heat.dtype == desc.dtype == torch.float32
    gap = max(float((heat.cpu() - heat32).abs().max()),
              float((desc.cpu() - desc32).abs().max()))
    if mode == "default":
        assert gap <= 5e-3, gap
    else:
        err32 = max(float((heat32.double() - heat64).abs().max()),
                    float((desc32.double() - desc64).abs().max()))
        assert gap <= 8 * err32, (gap, err32)
