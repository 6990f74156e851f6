"""The cell `pairs.aliked-lightglue-2048.b32`: it loads by name, its
driver runs through the program at a tiny size on the CPU and reads
`correct` true, a planted fault in ALIKED reads it false, its own
readers read a recorded trace (None where the program has no such span),
its work counts follow the published widths, and its reference loads
nothing of the program."""

import ast
import json
import time

import pytest
import torch

from recbench import harness
from recbench.tests.conftest import ROOT
from recbench.trace import aliked_work
from recbench.trace.profile import Trace

CELL = "pairs.aliked-lightglue-2048.b32"
SPANS = ["aliked.backbone_ms", "aliked.deform_ms", "aliked.head_ms",
         "aliked.select_ms", "aliked.sddh_ms"]
READERS = SPANS + ["deep_aliked.mfu_pct"]
SHARED = ["pair.detect_ms", "pair.match_ms", "pair.ransac_ms",
          "device.idle_pct.pairs", "pair.upload_mb", "lightglue.self_ms",
          "lightglue.cross_ms", "lightglue.assign_ms",
          "lightglue.roofline_pct", "lightglue.attention_ms"]
OP = {"pairs": 32, "height": 768, "width": 1024, "valid": [2048] * 64,
      "dim": 256, "n_layers": 9, "heads": 4, "input_dim": 128}


def tiny():
    """The cell at a size the CPU runs in seconds (LightGlue's width cut:
    CPU only; ALIKED is whole)."""
    cell = harness.load_cell(CELL)
    cell.config.update(height=96, width=128, max_features=64, dim=64,
                       n_layers=2)
    cell.traffic.update(batch=2, pool_batches=2, trace_batches=2)
    return cell


def _failed(result):
    return {k for k, c in result["checks"].items()
            if c["value"] is None or c["value"] > c["limit"]}


def test_the_cell_loads_by_name():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["driver"] == "aliked_pairs"
    c = cell.config
    assert (c["height"], c["width"], c["max_features"], c["nms_radius"],
            c["detection_threshold"], c["descriptor_dim"], c["dim"],
            c["n_layers"], c["heads"]) == (768, 1024, 2048, 2, 0.2, 128,
                                           256, 9, 4)
    assert c["reduced"] == [] and c["departures"] and c["assumed"]
    assert [m["name"] for m in cell.end_to_end] == [
        "pairs_per_s", "batch_p95_ms", "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert sorted(names) == sorted(SHARED + READERS)
    assert "deep.mfu_pct" not in names
    for name in names:
        assert callable(harness.load_reader(name).read)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = [e for e in bench["configs"] if e["name"] == c["name"]][0]
    assert entry["source"] == c["source"] and entry["reduced"] == []


def test_a_tiny_run_is_correct_and_traced():
    result = harness.run_cell(tiny(), 2**31 + 11, 0.3, True, "cpu",
                              time.perf_counter())
    assert result["correct"], result["checks"]
    # on the CPU the spans open but no device op runs
    for name in SPANS:
        assert result["metrics"][name]["value"] == 0.0


def test_a_fault_in_the_descriptor_head_fails(monkeypatch):
    """The program's SDDH without its `sf` transform."""
    from tpu3drec_torch.models import aliked_n16
    monkeypatch.setattr(aliked_n16._SDDH, "forward",
                        _sddh_without_sf(aliked_n16._SDDH.forward))
    result = harness.run_cell(tiny(), 7, 0.2, False, "cpu",
                              time.perf_counter())
    assert "al_desc_gap" in _failed(result)


@pytest.mark.parametrize("fault", ["nms_radius_1", "past_the_best"])
def test_a_fault_in_keypoint_selection_fails(fault, monkeypatch):
    """The program's keypoints off the reference's peaks: NMS at radius 1
    (non-maxima of the 5x5 window kept), or the top-k from the second
    best on (one peak lost, one past the budget taken). Each keypoint
    still lands on its own pixel's refinement, so only the keypoints
    one side has and the other lacks can read it."""
    from tpu3drec_torch.models import aliked_n16
    if fault == "nms_radius_1":
        real_init = aliked_n16.ALIKEDN16.__init__
        monkeypatch.setattr(
            aliked_n16.ALIKEDN16, "__init__",
            lambda self, *a, **kw: real_init(self, *a,
                                             **dict(kw, nms_radius=1)))
    else:
        real_top_k = aliked_n16.top_k_pixels

        def top_k_from_the_second(score, k):
            vals, xs, ys = real_top_k(score, k + 1)
            return vals[:, 1:], xs[:, 1:], ys[:, 1:]
        monkeypatch.setattr(aliked_n16, "top_k_pixels",
                            top_k_from_the_second)
    result = harness.run_cell(tiny(), 7, 0.2, False, "cpu",
                              time.perf_counter())
    assert {"al_keypoints_missing_pct", "al_keypoint_flips"} <= _failed(
        result)


def test_decided_flips_leave_near_ties_out():
    """Two peaks 3 px apart on a 1 x 12 score map, kept at radius 2 with
    a budget of one: taking the lower one is a flip only where the
    scores part by more than the margin."""
    from recbench.reference import aliked as reference
    for gap, flips in ((reference.SCORE_MARGIN / 4, 0),
                       (reference.SCORE_MARGIN * 4, 2)):
        score = torch.zeros(1, 12)
        score[0, 4], score[0, 7] = 0.5 + gap, 0.5
        peaks, _ = reference.select(score, 1, 0.2, 2)
        assert peaks.tolist() == [[4, 0]]
        got = reference.decided_flips(score, peaks, 1, 0.2, 2,
                                      torch.tensor([[7, 0]]))
        assert got == flips
        assert reference.decided_flips(score, peaks, 1, 0.2, 2, peaks) == 0
        # a pixel of score 0 beside the peak is a flip at any gap; the
        # peak it stands for is one where the gap is decided
        assert reference.decided_flips(score, peaks, 1, 0.2, 2,
                                       torch.tensor([[5, 0]])) == 1 + flips // 2


@pytest.mark.parametrize("side,flips", [([[3, 0], [8, 0]], 0),
                                        ([[8, 0], [14, 0]], 2)])
def test_decided_flips_follow_the_top_k_edge(side, flips):
    """Budget 2 on a 1 x 20 score map with two tied peaks side by side
    (x 2 and 3), then 0.5 at x 8 and 0.3 at x 14. The reference keeps
    both tied peaks. A side that parts the tie keeps one of them and the
    next peak (a slot freed at NMS moves its top-k edge a rank down): no
    flip. A side that drops the clear tie-free best is two: the peak
    lost and the pixel taken past the edge."""
    from recbench.reference import aliked as reference
    score = torch.zeros(1, 20)
    score[0, 2] = score[0, 3] = 0.9
    score[0, 8], score[0, 14] = 0.5, 0.3
    peaks, _ = reference.select(score, 2, 0.2, 2)
    assert peaks.tolist() == [[2, 0], [3, 0]]
    if flips:
        # the tie undone: x 2 the clear best, x 8 second
        score[0, 3] = 0.4
        peaks, _ = reference.select(score, 2, 0.2, 2)
        assert peaks.tolist() == [[2, 0], [8, 0]]
    assert reference.decided_flips(score, peaks, 2, 0.2, 2,
                                   torch.tensor(side)) == flips


def _sddh_without_sf(real):
    def forward(self, feat, xy, size=None):
        sf = self.sf
        self.sf = torch.nn.Identity()
        try:
            return real(self, feat, xy, size)
        finally:
            self.sf = sf
    return forward


def test_readers_read_a_recorded_trace():
    ranges = {"aliked.backbone": [2, 1.0, 60.0],
              "aliked.deform": [8, 1.0, 8.0],
              "aliked.head": [2, 1.0, 200.0],
              "aliked.select": [2, 1.0, 20.0],
              "aliked.sddh": [2, 1.0, 30.0]}
    ctx = {"trace": Trace(window_s=1.0, busy_s=0.9, ranges=ranges),
           "batches": 2, "deep": [OP, OP]}
    got = {n: harness.load_reader(n).read(ctx) for n in READERS}
    assert got["aliked.backbone_ms"] == pytest.approx(30.0)
    assert got["aliked.deform_ms"] == pytest.approx(4.0)
    assert got["aliked.head_ms"] == pytest.approx(100.0)
    assert got["aliked.select_ms"] == pytest.approx(10.0)
    assert got["aliked.sddh_ms"] == pytest.approx(15.0)
    assert got["deep_aliked.mfu_pct"] == pytest.approx(
        100 * 2 * aliked_work.least_s(OP))


@pytest.mark.parametrize("name", READERS)
def test_readers_none_without_the_programs_spans(name):
    ctx = {"trace": Trace(window_s=1.0, busy_s=0.0, ranges={}),
           "batches": 2, "deep": [OP]}
    assert harness.load_reader(name).read(ctx) is None


def test_work_follows_the_published_widths():
    """7.87 GMAC of the dense network a 768x1024 image, 0.5622 MMAC of
    SDDH a keypoint: 1.155 TFLOP of ALIKED a batch of 64 images, 17.2
    ms at the float32 peak."""
    assert aliked_work.aliked_dense_macs(768, 1024) == pytest.approx(
        7.872e9, abs=0.001e9)
    al, lg = aliked_work.batch_flops(OP)
    assert al == pytest.approx(1.1549e12, abs=0.0001e12)
    assert al / aliked_work.PEAK_F32_OPS * 1e3 == pytest.approx(17.24,
                                                                abs=0.01)


def test_the_reference_loads_nothing_of_the_program():
    path = ROOT / "recbench" / "reference" / "aliked.py"
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0])
    assert tops <= {"__future__", "contextlib", "math", "torch"}, tops
