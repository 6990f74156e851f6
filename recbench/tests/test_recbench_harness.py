"""The harness finds what it runs by name, each driver runs through the
program's plain paths at a tiny size, the result line has the contract's
keys, and a measurement without a card fails."""

import json
import shutil
import subprocess
import sys
import time

import pytest

from recbench import harness
from recbench.tests.conftest import DENSE, ROOT, load, shrink

CELLS = ["pairs.sift-vga-2048.b96", "pairs.sift-vga-2048.b8"]


def _copy_tree(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "recbench", tmp_path / "recbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    return tmp_path


def test_every_cell_resolves():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(CELLS) == {w["name"] for w in bench["workloads"]}
    for name in CELLS + [DENSE]:
        cell = load(name)
        assert cell.chips == 1
        assert harness.load_driver(cell.traffic["driver"])
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(harness.load_reader(m["name"]).read)


def test_added_files_are_found_by_name(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric are new
    files and new BENCHMARK.json entries, and nothing else."""
    root = _copy_tree(tmp_path)
    rb = root / "recbench"
    cfg = json.loads((rb / "configs" / "sift-vga-2048.json").read_text())
    cfg.update(name="sift-qvga-1024", height=240, width=320,
               max_features=1024)
    (rb / "configs" / "sift-qvga-1024.json").write_text(json.dumps(cfg))
    (rb / "traffic" / "closed-b4.json").write_text(json.dumps(
        {"driver": "pairs", "batch": 4, "pool_batches": 2,
         "trace_batches": 2}))
    (rb / "workloads" / "pairs.sift-qvga-1024.b4.json").write_text(
        json.dumps({"limits": {"answers_malformed": 0}}))
    (rb / "metrics" / "pair.batches.py").write_text(
        "def read(ctx):\n    return ctx['batches']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sift-qvga-1024", "source": "x",
                             "file": "recbench/configs/sift-qvga-1024.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "pairs.sift-qvga-1024.b4",
                               "config": "sift-qvga-1024",
                               "traffic": "closed-b4", "chips": 1,
                               "why": "x"})
    bench["end_to_end"][0]["workloads"].append("pairs.sift-qvga-1024.b4")
    bench["per_layer"].append({"name": "pair.batches", "unit": "1",
                               "better": "higher", "source": "program_counter",
                               "layer": "x", "moves": "pairs_per_s",
                               "workloads": ["pairs.sift-qvga-1024.b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("pairs.sift-qvga-1024.b4", root)
    assert cell.config["max_features"] == 1024
    assert cell.traffic["batch"] == 4
    assert cell.limits == {"answers_malformed": 0}
    assert [m["name"] for m in cell.per_layer] == ["pair.batches"]
    assert [m["name"] for m in cell.end_to_end] == ["pairs_per_s", "setup_s"]
    assert harness.load_reader("pair.batches", root).read({"batches": 7}) == 7
    with pytest.raises(SystemExit):
        harness.load_cell("pairs.sift-qvga-1024.b5", root)


def _check_line(result, cell, trace):
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert set(result) <= {"correct", "attempted", "failed", "metrics",
                           "device", "breakdown", "checks"}
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(result["metrics"]) <= want
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(result["checks"]) == set(cell.limits)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("name", CELLS + [DENSE])
def test_driver_runs_on_cpu(name, exact_neighbours):
    cell = shrink(load(name))
    result = harness.run_cell(cell, 2**31 + 5, 0.5, False, "cpu",
                              time.perf_counter())
    _check_line(result, cell, trace=False)
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("name", ["pairs.sift-vga-2048.b8", DENSE])
def test_traced_run_on_cpu(name, exact_neighbours):
    """The traced path reads the program's ranges from the profiler's raw
    events (host events only on the CPU: no device time, so the device
    metrics are absent, never 0 for a roofline)."""
    cell = shrink(load(name))
    result = harness.run_cell(cell, 7, 0.2, True, "cpu", time.perf_counter())
    _check_line(result, cell, trace=True)
    assert result["correct"] is True
    assert result["device"]["window_s"] > 0
    assert result["device"]["busy_s"] == 0
    assert not any(k.endswith("roofline_pct") for k in result["metrics"])
    assert len(result["breakdown"]["idle_gaps"]) <= 10


def test_trace_reader_counts_ranges():
    import torch
    from torch.profiler import record_function

    from recbench.trace.profile import profile

    def work():
        for _ in range(3):
            with record_function("pair_step.detect"):
                torch.ones(8).sum()

    tr = profile(torch, work, "cpu")
    assert tr.count("pair_step.detect") == 3
    assert tr.device_ms("pair_step.detect") == 0.0


def _run_cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "recbench/run.py", "--workload",
         "pairs.sift-vga-2048.b8", "--seed", "1", "--seconds", "1", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def _no_result(proc):
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    try:
        return "correct" not in json.loads(last)
    except ValueError:
        return True


def test_no_card_no_result():
    """Without a CUDA card the command fails and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run_cli(ROOT)
    assert proc.returncode != 0 and _no_result(proc)
    assert "CUDA" in proc.stderr


def test_benchmark_alone_fails(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    the command fails and prints no result."""
    _copy_tree(tmp_path)
    proc = _run_cli(tmp_path)
    assert proc.returncode != 0 and _no_result(proc)
