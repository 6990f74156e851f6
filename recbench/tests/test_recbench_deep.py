"""The deep cell `pairs.superpoint-lightglue-2048.b32`: it loads by name,
its driver runs through the program at a tiny size on the CPU, its own
readers read a recorded trace (None where the program has no such span),
the pair step's readers read it too, its work counts match a hand count
at the published widths, its control and planted faults read `correct`
false, its reference loads nothing of the program, and against a program
without the deep step it fails at once."""

import json
import subprocess
import sys
import time

import pytest
import torch

from recbench import harness, readings
from recbench.tests.conftest import ROOT
from recbench.trace import deep_work
from recbench.trace.profile import Trace

CELL = "pairs.superpoint-lightglue-2048.b32"
# the cell's own readers, and those it shares with the SIFT cells
READERS = ["lightglue.self_ms", "lightglue.cross_ms", "lightglue.assign_ms",
           "lightglue.roofline_pct", "deep.mfu_pct"]
SHARED = ["pair.detect_ms", "pair.match_ms", "pair.ransac_ms",
          "device.idle_pct.pairs", "pair.upload_mb"]
# one batch of the cell at the published widths, every slot valid
OP = {"pairs": 32, "height": 768, "width": 1024, "valid": [2048] * 64,
      "dim": 256, "n_layers": 9, "heads": 4, "input_dim": 256}


def tiny():
    """The cell at a size the CPU runs in seconds (widths cut: CPU only)."""
    cell = harness.load_cell(CELL)
    cell.config.update(height=64, width=96, max_features=64, dim=64,
                       n_layers=2)
    cell.traffic.update(batch=2, pool_batches=2, trace_batches=2)
    return cell


def _run(trace=False, seed=11):
    return harness.run_cell(tiny(), seed, 0.3, trace, "cpu",
                            time.perf_counter())


def _failed(result):
    return {k for k, c in result["checks"].items()
            if c["value"] is None or c["value"] > c["limit"]}


def test_the_cell_loads_by_name():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["driver"] == "deep_pairs"
    assert cell.traffic["batch"] == 32
    c = cell.config
    assert (c["height"], c["width"], c["max_features"], c["dim"],
            c["n_layers"], c["heads"], c["filter_threshold"]) == \
        (768, 1024, 2048, 256, 9, 4, 0.1)
    assert c["reduced"] == [] and c["departures"] and c["assumed"]
    assert [m["name"] for m in cell.end_to_end] == [
        "pairs_per_s", "batch_p95_ms", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == SHARED + READERS
    assert "answers_malformed" in cell.limits
    for name in SHARED + READERS:
        assert callable(harness.load_reader(name).read)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = [e for e in bench["configs"] if e["name"] == c["name"]][0]
    assert entry["source"] == c["source"] and entry["reduced"] == []


def test_work_matches_a_hand_count():
    """66.7 GMAC a 768x1024 SuperPoint image and 115.2 GMAC a 2,048 +
    2,048 keypoint LightGlue pair, to the 0.1 GMAC those are rounded to;
    the parameter count is the program's modules'."""
    from tpu3drec_torch.models.lightglue import LightGlueNet
    assert deep_work.superpoint_macs(768, 1024) == pytest.approx(66.7e9,
                                                                 abs=0.05e9)
    assert deep_work.lightglue_macs(2048, 2048, 256, 9, 4, 256) == \
        pytest.approx(115.2e9, abs=0.05e9)
    assert deep_work.lightglue_params(256, 9, 4, 256) == sum(
        p.numel() for p in LightGlueNet().parameters())
    sp, lg = deep_work.batch_flops(OP)
    assert sp + lg == pytest.approx(15.9e12, abs=0.05e12)
    # 7.37 TFLOP at 494.7 TFLOP/s: compute-bound, 14.9 ms
    assert deep_work.lightglue_bound_ms(OP) == pytest.approx(14.9, abs=0.05)
    # fewer valid keypoints, less work
    fewer = dict(OP, valid=[1024] * 64)
    assert deep_work.batch_flops(fewer)[1] < lg / 2


def _trace(ranges, busy=0.5):
    return Trace(window_s=1.0, busy_s=busy, ranges=ranges)


def test_readers_read_a_recorded_trace():
    ranges = {"pair_step.detect": [2, 10.0, 280.0],
              "pair_step.match": [2, 10.0, 600.0],
              "lightglue.self": [18, 5.0, 350.0],
              "lightglue.cross": [18, 5.0, 300.0],
              "lightglue.assign": [4, 1.0, 16.0]}
    ctx = {"trace": _trace(ranges), "batches": 2, "deep": [OP, OP]}
    got = {n: harness.load_reader(n).read(ctx)
           for n in READERS + ["pair.detect_ms", "device.idle_pct.pairs"]}
    assert got["pair.detect_ms"] == pytest.approx(140.0)
    assert got["lightglue.self_ms"] == pytest.approx(175.0)
    assert got["lightglue.cross_ms"] == pytest.approx(150.0)
    assert got["lightglue.assign_ms"] == pytest.approx(8.0)
    bound = 2 * deep_work.lightglue_bound_ms(OP)
    assert got["lightglue.roofline_pct"] == pytest.approx(100 * bound / 600)
    flops = 2 * sum(deep_work.batch_flops(OP))
    assert got["deep.mfu_pct"] == pytest.approx(
        100 * flops / deep_work.PEAK_TF32_OPS)
    assert got["device.idle_pct.pairs"] == pytest.approx(50.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_none_without_the_programs_spans(name):
    """A program without the deep step's spans (or a run with no device
    work, for the shares) reads None, never 0."""
    ctx = {"trace": _trace({"pair_step.ransac": [2, 1.0, 3.0]}, busy=0.0),
           "batches": 2}
    assert harness.load_reader(name).read(ctx) is None


def test_driver_runs_on_cpu():
    result = _run()
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"pairs_per_s", "batch_p95_ms",
                                      "setup_s"}
    assert set(result["checks"]) == set(tiny().limits)


def test_traced_run_on_cpu():
    """No device time on the CPU: the span readers read 0, the roofline
    and the model-FLOP share are absent; the RANSAC threshold is the one
    host constant uploaded, 4 bytes a batch."""
    result = _run(trace=True)
    m = result["metrics"]
    assert result["correct"] is True
    assert "lightglue.roofline_pct" not in m and "deep.mfu_pct" not in m
    assert all(m[n]["value"] == 0.0 for n in READERS[:3] + SHARED[:3])
    assert m["device.idle_pct.pairs"]["value"] == 100.0
    assert m["pair.upload_mb"]["value"] == pytest.approx(4e-6)


def test_control_fails_at_a_tiny_size():
    cell = tiny()
    res = readings.readings(cell, [2**31 + 3, 5], 0.2, "cpu")
    for prog in res["program"]:
        assert all(prog[k] <= v for k, v in cell.limits.items()), prog
    for ctrl in res["control"]:
        assert any(ctrl[k] > v for k, v in cell.limits.items()), ctrl


def _wrap_step(monkeypatch, wrap):
    import tpu3drec_torch.pair_step as ps
    real = ps.make_deep_pair_fn
    monkeypatch.setattr(ps, "make_deep_pair_fn",
                        lambda *a, **kw: wrap(real(*a, **kw)))


def test_stale_answer_fails(monkeypatch):
    def wrap(fn):
        first = {}

        def stale(img1, img2, u=None):
            if not first:
                first.update(fn(img1, img2, u))
            return dict(first)
        return stale

    _wrap_step(monkeypatch, wrap)
    assert _run()["correct"] is False


def test_half_the_batch_fails(monkeypatch):
    def wrap(fn):
        def half(img1, img2, u=None):
            out = fn(img1[:1], img2[:1], u)
            return {k: torch.cat([v, v]) for k, v in out.items()}
        return half

    _wrap_step(monkeypatch, wrap)
    assert _run()["correct"] is False


def test_rotary_halves_fail(monkeypatch):
    """LightGlue's rotary pairs laid out as two halves, not interleaved."""
    from tpu3drec_torch.models import lightglue

    def halves(x):
        a, b = x.chunk(2, dim=-1)
        return torch.cat([-b, a], dim=-1)

    monkeypatch.setattr(lightglue, "rotate_half", halves)
    assert _run()["correct"] is False


def test_altered_matchability_fails(monkeypatch):
    """The matchability logits z0 shifted by 0.1 where they are made."""
    from tpu3drec_torch.models import lightglue
    real = lightglue.LightGlueNet.forward

    def shifted(self, *a):
        la, sim, z0, z1 = real(self, *a)
        return la, sim, z0 + 0.1, z1

    monkeypatch.setattr(lightglue.LightGlueNet, "forward", shifted)
    assert _failed(_run()) == {"lg_matchability_gap"}


def test_descriptors_sampled_half_a_cell_off_fail(monkeypatch):
    """SuperPoint's descriptors read at x / 8 instead of x / 8 - 0.5."""
    from tpu3drec_torch.models import superpoint
    real = superpoint._sample_descriptors
    monkeypatch.setattr(superpoint, "_sample_descriptors",
                        lambda desc, xs, ys: real(desc, xs + 4, ys + 4))
    assert "sp_desc_gap" in _failed(_run())


@pytest.mark.parametrize("name", ["convDb.bias", "matchability.bias",
                                  "transformers.0.self_attn.Wqkv.bias"])
def test_a_dropped_bias_fails(monkeypatch, name):
    """The program drops a bias (SuperPoint's descriptor head, LightGlue's
    matchability, the first self block's Wqkv) that the reference keeps."""
    from tpu3drec_torch.models import lightglue, superpoint
    net, key = ((superpoint.SuperPointNet, name) if name.startswith("conv")
                else (lightglue.LightGlueNet, name))
    real = net.load_state_dict

    def drop(self, params, *a, **kw):
        params = dict(params, **{key: torch.zeros_like(params[key])})
        return real(self, params, *a, **kw)

    monkeypatch.setattr(net, "load_state_dict", drop)
    assert _run()["correct"] is False


def _decided(cell):
    """The tiny cell with the log-assignment's limit at the CPU's float32
    (its gaps are ~1e-5 here), so that most rows are decided."""
    cell.limits["lg_assign_max_gap"] = 1e-3
    return cell


def test_argmax_of_decided_rows_is_compared():
    cell = _decided(tiny())
    res = readings.readings(cell, [11], 0.2, "cpu", control=False)
    prog = res["program"][0]
    assert prog["lg_decided_rows_pct"] > 50
    assert prog["lg_argmax_flips"] == 0


@pytest.mark.parametrize("fault", ["best1", "mutual"])
def test_a_wrong_argmax_or_mutual_flag_fails(monkeypatch, fault):
    """Each row's argmax moved to the next slot, or the mutual flag
    inverted, on the timed path."""
    def wrap(fn):
        def wrong(img1, img2, u=None):
            out = fn(img1, img2, u)
            if fault == "best1":
                out["best1"] = (out["best1"] + 1) % out["best1"].shape[1]
            else:
                out["mutual"] = ~out["mutual"]
            return out
        return wrong

    _wrap_step(monkeypatch, wrap)
    cell = _decided(tiny())
    result = harness.run_cell(cell, 11, 0.3, False, "cpu",
                              time.perf_counter())
    assert _failed(result) == {"lg_argmax_flips"}


def test_ransac_on_the_wrong_view_fails(monkeypatch):
    """The deep step's RANSAC gathers its matches from the first view's
    keypoints instead of the second's."""
    import tpu3drec_torch.pair_step as ps
    real = ps.deep_ransac

    def wrong_view(xy, best1, ok, num_hypotheses, u=None):
        B = best1.shape[0]
        return real(torch.cat([xy[:B], xy[:B]]), best1, ok, num_hypotheses, u)

    monkeypatch.setattr(ps, "deep_ransac", wrong_view)
    assert {"ransac_inliers_gap_pct", "ransac_homography_diff_pct"} \
        <= _failed(_run())


def test_a_program_without_the_deep_step_fails_at_once(monkeypatch):
    """The parent of the cell's first commit has no `make_deep_pair_fn`:
    set-up raises before any work."""
    import tpu3drec_torch.pair_step as ps
    monkeypatch.delattr(ps, "make_deep_pair_fn")
    t0 = time.perf_counter()
    with pytest.raises(ImportError):
        _run()
    assert time.perf_counter() - t0 < 5


def test_reference_loads_nothing_of_the_program():
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import torch
from recbench.reference import deep
from recbench.tests.test_recbench_deep import tiny
from recbench.gen import photos
cfg = tiny().config
g = torch.Generator().manual_seed(0)
p = deep.random_params(deep.superpoint_shapes(), g)
img = photos.photos(1, 64, 96, g, "cpu")[0]
with deep.precision("float32", "cpu"):
    xy, s, d = deep.superpoint(p, img, 64, 0.0005, 4)
assert len(xy) == 64
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "tpu3drec_torch" not in tops
    assert not tops & set(harness.FORBIDDEN)


def test_a_run_loads_nothing_forbidden():
    """Every module a run of the cell loads, the program's included."""
    code = f"""
import json, sys, time
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from recbench import harness
from recbench.tests.test_recbench_deep import tiny
cell = tiny()
for m in cell.per_layer:
    harness.load_reader(m["name"])
harness.run_cell(cell, 3, 0.2, False, "cpu", time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "tpu3drec_torch" in tops
    assert not tops & set(harness.FORBIDDEN)
