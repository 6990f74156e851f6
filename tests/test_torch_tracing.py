"""The port's spans and counters (`tpu3drec_torch/utils/profiling.py`) on
the pair step, on the CPU with two pairs of small images.

- Under a profiler, each `sift.*` span opens once per octave and
  `knn2.kernel` once, each inside its `pair_step.*` range on the same
  thread.
- With no profiler the pair step opens no `record_function` range,
  counts nothing on the device, and gives the profiled run's answers.
- The `knn2` counters equal their formulas; the upload counters equal
  the band matrices and constants of one 480x640 detection, from their
  shapes.
- The traced view starts again at a new profiler session while the
  process totals keep counting."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

from tpu3drec_torch.ops import pallas_match
from tpu3drec_torch.ops.sift import N_LAYERS, num_octaves
from tpu3drec_torch.pair_step import make_pair_fn
from tpu3drec_torch.utils import profiling
from tpu3drec_torch.utils.profiling import (
    count, counters, reset_counters, span, upload,
)

H, W = 96, 128
MAXF, K_HYP = 128, 16
SIFT_SPANS = ("sift.blur", "sift.extrema", "sift.refine", "sift.ori_desc",
              "sift.select")
STAGES = {"pair_step.detect": SIFT_SPANS, "pair_step.match": ("knn2.kernel",)}


def _images():
    """Two pairs: band-limited noise and a shifted copy of each."""
    g = np.random.default_rng(5)
    base = g.random((2, H + 8, W + 8), dtype=np.float32)
    k = np.ones(3, np.float32) / 3
    for ax in (1, 2):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax,
                                   base)
    img1 = torch.from_numpy(np.ascontiguousarray(base[:, 4:4 + H, 4:4 + W]))
    img2 = torch.from_numpy(np.ascontiguousarray(base[:, 2:2 + H, 5:5 + W]))
    return img1, img2


def _answers(out):
    return {k: v.numpy().copy() for k, v in out.items()}


def _profiled_step(fn, img1, img2):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(img1, img2)
    return _answers(out), prof.profiler.kineto_results.events()


@pytest.fixture(scope="module")
def traced():
    """One profiled pair step: its answers, its kineto events and the
    counters' traced view after it."""
    img1, img2 = _images()
    fn = make_pair_fn(MAXF, K_HYP)
    reset_counters()
    answers, events = _profiled_step(fn, img1, img2)
    return dict(fn=fn, img1=img1, img2=img2, answers=answers,
                spans=[(e.name(), e.start_thread_id(), e.start_ns(),
                        e.start_ns() + e.duration_ns()) for e in events],
                view=counters(traced=True))


def test_spans_open_once_per_octave_inside_their_stage(traced):
    spans = traced["spans"]
    n_oct = num_octaves(H, W)
    assert n_oct == 3
    for name in SIFT_SPANS:
        assert sum(s[0] == name for s in spans) == n_oct, name
    assert sum(s[0] == "knn2.kernel" for s in spans) == 1
    for stage, inner in STAGES.items():
        (outer,) = [s for s in spans if s[0] == stage]
        for s in spans:
            if s[0] in inner:
                assert s[1] == outer[1], (s, outer)
                assert outer[2] <= s[2] and s[3] <= outer[3], (s, outer)
    # the sift spans of one octave run in order and never overlap
    sift = sorted((s for s in spans if s[0] in SIFT_SPANS),
                  key=lambda s: s[2])
    assert [s[0] for s in sift] == list(SIFT_SPANS) * n_oct
    assert all(a[3] <= b[2] for a, b in zip(sift, sift[1:]))


def test_no_profiler_opens_no_range_and_counts_nothing_on_device(
        traced, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a record_function range without a profiler")

    def no_device_count(*args, **kwargs):
        raise AssertionError("knn2's work counted without a profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(pallas_match, "_count_work", no_device_count)
    before = counters(traced=True)
    out = _answers(traced["fn"](traced["img1"], traced["img2"]))
    for key, want in traced["answers"].items():
        np.testing.assert_array_equal(out[key], want, err_msg=key)
    assert counters(traced=True) == before == traced["view"]
    assert span("x") is span("y")          # the shared null context


def _masked_case(dtype, seed):
    g = torch.Generator().manual_seed(seed)
    B, N, M, D = 2, 37, 53, 64
    if dtype == torch.int8:
        a = torch.randint(-128, 128, (B, N, D), generator=g).to(torch.int8)
        b = torch.randint(-128, 128, (B, M, D), generator=g).to(torch.int8)
        bnorm = b.to(torch.int32).square().sum(-1, dtype=torch.int32)
    else:
        a = torch.randn(B, N, D, generator=g)
        b = torch.randn(B, M, D, generator=g)
        bnorm = (b * b).sum(-1)
    mask2 = torch.rand(B, M, generator=g) < 0.4
    return a, b, bnorm, mask2


@pytest.mark.parametrize("dtype,kind,size", [(torch.int8, "int8", 1),
                                             (torch.float32, "f32", 4)])
def test_knn2_counters_equal_the_formulas(dtype, kind, size):
    a, b, bnorm, mask2 = _masked_case(dtype, 3)
    B, N, D = a.shape
    M = b.shape[1]
    valid = int(mask2.sum())
    assert 0 < valid < B * M
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        pallas_match.knn2_raw(a, b, bnorm, mask2)
        pallas_match.knn2_raw(a, b, bnorm, mask2)
    view = counters(traced=True)
    assert view[f"knn2.macs.{kind}"] == 2 * N * valid * D
    assert view["knn2.bytes"] == 2 * (B * N * D * size
                                      + valid * (D * size + 4) + B * M
                                      + B * N * 2 * 8)
    other = "f32" if kind == "int8" else "int8"
    assert f"knn2.macs.{other}" not in view
    # device-valued counts enter the traced view alone
    assert "knn2.bytes" not in counters()


def test_uploads_of_one_vga_detection():
    from tpu3drec_torch.ops.sift import _STENCIL, detect_and_compute
    h, w = 480, 640
    img = torch.from_numpy(np.random.default_rng(1).random(
        (1, h, w), dtype=np.float32))
    reset_counters()
    detect_and_compute(img, 2048)
    c = counters()
    n_oct = num_octaves(h, w)
    # the base blur's two band matrices, then per octave two for each of
    # the pyramid's N_LAYERS + 2 sigmas; per octave the refinement's
    # stencil offsets (int64) and the descriptor's bin order (int64)
    shapes = [(h, w)] + [(h >> o, w >> o) for o in range(n_oct)
                         for _ in range(N_LAYERS + 2)]
    band = sum(4 * (hh * hh + ww * ww) for hh, ww in shapes)
    assert band == 19_610_000
    consts = n_oct * 8 * (len(_STENCIL) + 8)
    assert c["upload.copies"] == 2 * len(shapes) + 2 * n_oct == 62
    assert c["upload.bytes"] == band + consts


def test_traced_view_restarts_at_a_new_session(traced):
    fn, img1, img2 = traced["fn"], traced["img1"], traced["img2"]
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        fn(img1, img2)
        count("ori_desc.launches", 3)
    first = counters(traced=True)
    assert first["ori_desc.launches"] == 3
    assert first["upload.copies"] > 0
    # between the sessions, untraced work counts in the totals alone
    fn(img1, img2)
    count("ori_desc.launches", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        fn(img1, img2)
        count("ori_desc.launches", 1)
    second = counters(traced=True)
    assert second["ori_desc.launches"] == 1
    assert second["upload.copies"] == first["upload.copies"]
    assert second["knn2.bytes"] == first["knn2.bytes"]
    totals = counters()
    assert totals["ori_desc.launches"] == 6
    assert totals["upload.copies"] == 3 * first["upload.copies"]
    count("x", 3, per=2, plus=1)            # host counts: n * per + plus
    assert counters()["x"] == 7


def test_upload_counts_whatever_the_device():
    reset_counters()
    host = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = upload(host, "cpu")
    out[0, 0] = 99.0                      # a copy, never a view of `host`
    assert host[0, 0] == 0.0
    x = upload(2.5, torch.device("cpu"), torch.float32)
    assert x.dtype == torch.float32 and x.ndim == 0
    assert counters() == {"upload.copies": 2, "upload.bytes": 48 + 4}
    assert math.isclose(float(x), 2.5)
