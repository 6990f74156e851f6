"""SIFT's DoG extrema stage, `ops/sift.py:dog_extrema`, in both forms.

On the CPU the wrapper runs the plain form, which must equal the stage's
composition bit for bit: the level subtraction, `_dog_extrema_mask` and
the `where` that builds the score. On a card the wrapper runs the
`dog_extrema` kernel (`csrc/dog_extrema.cu`), which compares values only,
so it too must give the same bits as the plain form, on the card and on
the CPU, on:
- crafted stacks: |dog| one float32 ulp either side of the contrast gate,
  ties and plateaus among the 27 neighbours, a NaN, octaves of 10x10,
  11x11 and 12x13 (the 5-px border keeps at most one pixel), widths that
  are no multiple of 4 and a stack off a 16-byte boundary (the kernel's
  scalar path);
- the Gaussian stacks of the pair step's 192 images at 480x640 (five
  octaves), of the `upscale` base (960x1280) and of the folder chain's
  batch of 6, as `octave_samples` hands them over.
Crafted stacks hold dyadic values with few bits, so every DoG value is
exactly the one intended. Tests marked `card` skip without a CUDA card;
on one they run with
`python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_dog_extrema.py`
(the card's machine has no JAX, which `tests/conftest.py` imports).
"""

import numpy as np
import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

from tpu3drec_torch.ops import sift
from tpu3drec_torch.ops.image import gaussian_blur_matmul
from tpu3drec_torch.utils.profiling import counters

CT = 0.04
S = sift.N_LAYERS + 3
# the contrast gate as the comparison sees it: rounded to float32
PRELIM = np.float32(0.5 * CT / sift.N_LAYERS)
PEAK_VALUES = [np.nextafter(PRELIM, np.float32(0)), PRELIM,
               np.nextafter(PRELIM, np.float32(1))]


def _stack_from_dog(dog: np.ndarray, base: np.ndarray) -> torch.Tensor:
    """The Gaussian stack whose level differences are `dog` (B, S-1, h, w),
    from level 0 `base` (B, h, w): partial sums, exact for dyadic values
    of few bits."""
    g = np.concatenate([base[:, None], dog], axis=1).astype(np.float64)
    g = np.cumsum(g, axis=1).astype(np.float32)
    assert np.array_equal(g[:, 1:] - g[:, :-1], dog.astype(np.float32))
    return torch.from_numpy(np.ascontiguousarray(g))


def _dyadic(rng, shape, lo=-3, hi=4, denom=64.0):
    return (rng.integers(lo, hi, shape) / denom).astype(np.float32)


def _peaks():
    """Isolated single-pixel peaks of |dog| at one ulp below, at and one
    ulp above the gate, both signs, on each kept level; (stack, the
    pixels whose score must be |v|)."""
    dog = np.zeros((1, S - 1, 28, 36), np.float32)
    kept = []
    k = 0
    for level in range(1, S - 2):
        for v in PEAK_VALUES:
            for sign in (1, -1):
                y, x = 6 + 4 * (k // 7), 6 + 4 * (k % 7)
                dog[0, level, y, x] = sign * v
                if v > PRELIM:
                    kept.append((level, y, x))
                k += 1
    return _stack_from_dog(dog, np.zeros((1, 28, 36), np.float32)), kept


def _plateau():
    """Flat 3x3x3 and wider blocks of equal |dog| above the gate (every
    pixel ties its maximum), beside blocks one step lower."""
    dog = np.zeros((1, S - 1, 32, 32), np.float32)
    dog[0, 1:4, 6:9, 6:9] = 0.25
    dog[0, 2, 14:20, 6:12] = -0.125
    dog[0, 1:4, 20:26, 18:26] = 0.0625
    dog[0, 2, 22, 20] = 0.125
    dog[0, :, 6:12, 20:26] = 0.03125
    return _stack_from_dog(dog, np.full((1, 32, 32), 0.5, np.float32))


def _ties(shape, seed):
    """Few-valued dyadic DoG values: ties among neighbours everywhere."""
    rng = np.random.default_rng(seed)
    B, h, w = shape
    return _stack_from_dog(_dyadic(rng, (B, S - 1, h, w)),
                           _dyadic(rng, (B, h, w), 0, 64))


def _smooth(shape, seed):
    """A real octave: the pyramid of a blurred noise image."""
    gen = torch.Generator().manual_seed(seed)
    img = gaussian_blur_matmul(torch.rand(shape, generator=gen), 1.0)
    return sift._gaussian_pyramid(img).contiguous()


def _with_nan():
    g = _ties((2, 24, 32), 5).clone()
    g[0, 2, 12, 13] = float("nan")
    g[1, 4, 7, 7] = float("nan")
    return g


CRAFTED = {
    "peaks_at_the_gate": lambda: _peaks()[0],
    "plateaus": _plateau,
    "ties": lambda: _ties((2, 20, 36), 1),
    "octave_10x10": lambda: _ties((3, 10, 10), 2),
    "octave_11x11": lambda: _ties((3, 11, 11), 3),
    "octave_12x13": lambda: _ties((3, 12, 13), 4),
    "odd_width": lambda: _ties((2, 33, 45), 6),
    "smooth": lambda: _smooth((2, 40, 52), 7),
    "smooth_odd_width": lambda: _smooth((2, 37, 61), 8),
    "nan": _with_nan,
}


def _composition(gauss):
    """The stage as `octave_samples` computed it before the wrapper."""
    dog = gauss[:, 1:] - gauss[:, :-1]
    ext = sift._dog_extrema_mask(dog, CT)
    return dog, torch.where(ext, dog.abs(), torch.zeros_like(dog))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, a NaN matching any NaN (the card writes the
    canonical NaN where the CPU keeps the input's)."""
    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    return torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


@pytest.mark.parametrize("case", sorted(CRAFTED))
def test_cpu_wrapper_equals_composition(case):
    g = CRAFTED[case]()
    dog, score = sift.dog_extrema(g, CT)
    ref_dog, ref_score = _composition(g)
    assert _same_bits(dog, ref_dog)
    assert _same_bits(score, ref_score)
    assert dog.shape == score.shape == (g.shape[0], S - 1) + g.shape[2:]


def test_cpu_gate_is_strict_in_float32():
    """The crafted peaks mean what they say: only |dog| one ulp above the
    float32 gate scores, at exactly |dog|."""
    g, kept = _peaks()
    _, score = sift.dog_extrema(g, CT)
    nz = {tuple(int(i) for i in t) for t in torch.nonzero(score[0])}
    assert nz == set(kept)
    for level, y, x in kept:
        assert score[0, level, y, x] == torch.tensor(PEAK_VALUES[2])


def test_cpu_border_leaves_small_octaves_empty():
    """10 px a side leaves no pixel 5 px inside every edge; 11 leaves one."""
    for h, w, most in ((10, 10, 0), (11, 11, 1), (12, 13, 2 * 3)):
        g = _ties((3, h, w), 11)
        _, score = sift.dog_extrema(g, CT)
        kept = (score != 0).sum(dim=(1, 2, 3))
        assert int(kept.max()) <= most * (S - 3)
        assert torch.all(score[:, :, :5] == 0) and torch.all(score[..., :5] == 0)


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "rank3",
                                 "five_levels"])
def test_wrapper_rejects(bad):
    g = _ties((2, 16, 20), 9)
    if bad == "float64":
        g, err = g.double(), TypeError
    elif bad == "non_contiguous":
        g, err = g.transpose(2, 3), ValueError
    elif bad == "rank3":
        g, err = g[0], TypeError
    else:
        g, err = g[:, :5].contiguous(), ValueError
    with pytest.raises(err):
        sift.dog_extrema(g, CT)


def test_detector_goes_through_the_wrapper(monkeypatch):
    """`octave_samples` takes each octave's DoG and score from
    `dog_extrema`, once an octave."""
    seen = []
    real = sift.dog_extrema

    def spy(gauss, ct):
        seen.append(tuple(gauss.shape))
        return real(gauss, ct)

    monkeypatch.setattr(sift, "dog_extrema", spy)
    gen = torch.Generator().manual_seed(0)
    sift.detect_and_compute(torch.rand((2, 64, 80), generator=gen),
                            max_features=128)
    assert seen == [(2, S, 64 >> o, 80 >> o)
                    for o in range(sift.num_octaves(64, 80))]


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    """Skips where no CUDA card is present (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpu3drec_torch import _nvcc
    _nvcc.load("dog_extrema")
    return torch.device("cuda")


def _check_on_card(g_cpu, g_dev, label):
    dog, score = sift.dog_extrema(g_dev, CT)
    pd, ps = sift.dog_extrema_plain(g_dev, CT)
    torch.cuda.synchronize()
    assert _same_bits(dog, pd), f"{label}: DoG differs from the card's plain form"
    assert _same_bits(score, ps), f"{label}: score differs from the card's plain form"
    if g_cpu is not None:
        cd, cs = sift.dog_extrema_plain(g_cpu, CT)
        assert _same_bits(dog, cd), f"{label}: DoG differs from the CPU's"
        assert _same_bits(score, cs), f"{label}: score differs from the CPU's"
    again = sift.dog_extrema(g_dev, CT)
    assert _same_bits(again[1], score), f"{label}: two launches differ"


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(CRAFTED))
def test_card_kernel_on_crafted_stacks(card, case):
    g = CRAFTED[case]()
    _check_on_card(g, g.to(card), case)


@pytest.mark.card
def test_card_kernel_off_16_bytes(card):
    """A stack one float off a 16-byte boundary, of width 36: the scalar
    path, where every row is otherwise vector-aligned."""
    g = _ties((2, 24, 36), 12)
    buf = torch.empty(g.numel() + 1, device=card)
    g_dev = buf[1:].view(g.shape)
    g_dev.copy_(g)
    assert g_dev.data_ptr() % 16 != 0 and g_dev.is_contiguous()
    _check_on_card(g, g_dev, "off 16 bytes")


def _path_stacks(card, B, h, w, upscale=False, seed=0):
    """The Gaussian stacks `octave_samples` hands to `dog_extrema` for B
    images of noise at two scales of blur."""
    gen = torch.Generator().manual_seed(seed)
    imgs = torch.rand((B, h, w), generator=gen).to(card)
    imgs[B // 2:] = gaussian_blur_matmul(imgs[B // 2:], 2.0)
    seen = []
    real = sift.dog_extrema

    def spy(gauss, ct):
        seen.append(gauss)
        return real(gauss, ct)

    sift.dog_extrema = spy
    try:
        for _ in sift.octave_samples(imgs, 2048, upscale=upscale):
            pass
    finally:
        sift.dog_extrema = real
    return seen


@pytest.mark.card
@pytest.mark.parametrize("path,B,h,w,upscale", [
    ("pair_step_b96", 192, 480, 640, False),
    ("upscale_base", 2, 480, 640, True),
    ("folder_batch", 6, 480, 640, False),
])
def test_card_kernel_on_path_octaves(card, path, B, h, w, upscale):
    stacks = _path_stacks(card, B, h, w, upscale)
    h0, w0 = (2 * h, 2 * w) if upscale else (h, w)
    assert [tuple(g.shape) for g in stacks] == [
        (B, S, h0 >> o, w0 >> o) for o in range(sift.num_octaves(h0, w0))]
    for o, g in enumerate(stacks):
        _check_on_card(None, g, f"{path} octave {o}")
    kept = sum(int((sift.dog_extrema(g, CT)[1] != 0).sum()) for g in stacks)
    assert kept > 0


@pytest.mark.card
@pytest.mark.parametrize("upscale", [False, True])
def test_card_launches_one_an_octave(card, upscale):
    gen = torch.Generator().manual_seed(1)
    imgs = torch.rand((2, 120, 160), generator=gen).to(card)
    before = counters().get("dog_extrema.launches", 0)
    sift.detect_and_compute(imgs, max_features=256, upscale=upscale)
    torch.cuda.synchronize()
    h, w = (240, 320) if upscale else (120, 160)
    assert counters().get("dog_extrema.launches", 0) - before \
        == sift.num_octaves(h, w)
