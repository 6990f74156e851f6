"""The readers of the program's own spans and counters: `sift.*_ms`,
`knn2.kernel_roofline_pct` and `pair.upload_mb`. Each returns None where
the program has no such span or counter (as a program without them
has), and the per-batch value, divided by the stretch's batches,
where it has."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from recbench import harness
from recbench.tests.conftest import load, shrink
from recbench.trace.profile import Trace

SIFT = ["sift.blur_ms", "sift.extrema_ms", "sift.refine_ms",
        "sift.ori_desc_ms", "sift.select_ms"]
COUNTED = ["knn2.kernel_roofline_pct", "pair.upload_mb"]
NEW = SIFT + COUNTED


def _trace(ranges):
    return Trace(window_s=1.0, busy_s=0.5, ranges=ranges)


def _counted(**counts):
    """The program's registry with `counts` in its traced view."""
    from tpu3drec_torch.utils.profiling import count, reset_counters
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for name, n in counts.items():
            count(name.replace("__", "."), n)


def test_every_new_reader_is_listed():
    cell = load("pairs.sift-vga-2048.b8")
    listed = {m["name"]: m for m in cell.per_layer}
    for name in NEW:
        assert listed[name]["moves"] == "pairs_per_s"
        assert callable(harness.load_reader(name).read)
    assert listed["pair.upload_mb"]["source"] == "program_counter"


@pytest.mark.parametrize("name", NEW)
def test_none_without_the_programs_span_or_counter(name, monkeypatch):
    from tpu3drec_torch.utils import profiling
    profiling.reset_counters()
    ctx = {"trace": _trace({"pair_step.detect": [4, 10.0, 40.0],
                            "pair_step.match": [4, 1.0, 4.0]}),
           "batches": 4}
    reader = harness.load_reader(name)
    assert reader.read(ctx) is None
    # a program with no counter registry at all
    monkeypatch.delattr(profiling, "counters")
    assert reader.read(ctx) is None


@pytest.mark.parametrize("name", SIFT)
def test_sift_span_per_batch(name):
    span = name[:-3]
    ctx = {"trace": _trace({span: [20, 3.0, 60.0],
                            "pair_step.detect": [4, 10.0, 99.0]}),
           "batches": 4}
    assert harness.load_reader(name).read(ctx) == pytest.approx(15.0)


def test_upload_mb_per_batch():
    _counted(upload__bytes=8_000_000, upload__copies=10)
    ctx = {"trace": _trace({}), "batches": 4}
    assert harness.load_reader("pair.upload_mb").read(ctx) == \
        pytest.approx(2.0)


def test_knn2_kernel_roofline():
    reader = harness.load_reader("knn2.kernel_roofline_pct")
    ctx = {"trace": _trace({"knn2.kernel": [4, 1.0, 4.0],
                            "pair_step.match": [4, 2.0, 40.0]}),
           "batches": 4}
    # bytes bound: 3.35 GB at 3.35 TB/s is 1 ms, over 4 ms of the span
    _counted(knn2__bytes=3_350_000_000, knn2__macs__int8=1000)
    assert reader.read(ctx) == pytest.approx(25.0)
    # products bound: 2 ms of int8 plus 2 ms of float32 products, summed,
    # over the bytes' 1 ms; a device-valued count as the program makes it
    _counted(knn2__bytes=torch.tensor(3_350_000_000),
             knn2__macs__int8=1_979_000_000_000,
             knn2__macs__f32=67_000_000_000)
    assert reader.read(ctx) == pytest.approx(100.0)
    # no device time in the span (a CPU run): no share
    ctx["trace"] = _trace({"knn2.kernel": [4, 1.0, 0.0]})
    assert reader.read(ctx) is None


def test_traced_cpu_run_reports_the_counters():
    """A traced run of the shrunk b8 cell on the CPU: the span readers
    read 0 device ms, the roofline is absent and the uploads are the
    program's count."""
    cell = shrink(load("pairs.sift-vga-2048.b8"))
    result = harness.run_cell(cell, 2**31 + 11, 0.2, True, "cpu",
                              time.perf_counter())
    assert result["correct"] is True
    m = result["metrics"]
    assert "knn2.kernel_roofline_pct" not in m
    assert all(m[name]["value"] == 0.0 for name in SIFT)
    # 120x160, per batch: the base blur's two band matrices and ten per
    # octave (3 octaves), float32; per octave the stencil offsets and the
    # descriptor's bin order (int64); RANSAC's threshold (float32)
    band = 4 * (6 * (120 ** 2 + 160 ** 2) + 5 * (60 ** 2 + 80 ** 2)
                + 5 * (30 ** 2 + 40 ** 2))
    assert m["pair.upload_mb"]["value"] == pytest.approx(
        (band + 3 * 8 * (19 + 8) + 4) / 1e6, rel=1e-12)
