"""The benchmark's harness: finds a cell's files by name, runs its
driver, reads its metrics and prints the result.

Everything that belongs to one cell is data or a file of its own:
`BENCHMARK.json` names the cell's configuration and traffic mix and
lists its metrics; `configs/<config>.json` holds the configuration's
sizes; `traffic/<traffic>.json` names the driver (`drivers/<driver>.py`)
and holds the mix's parameters; `workloads/<cell>.json` holds the
limits of the numbers that decide `correct`; `metrics/<metric>.py` reads
one per-layer metric from what the driver's traced stretch recorded.
A later cell, configuration, traffic mix or metric is a new file and a
new entry, with no edit here. `parked/<cell>.json` holds the entries of
a cell whose files are here but which waits outside `BENCHMARK.json`
(PERF.md says why); only the benchmark's own tests run it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu3drec")


@dataclass
class Cell:
    name: str
    root: Path
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT,
              bench: Optional[Dict] = None) -> Cell:
    """The cell `name` of `root/BENCHMARK.json` (or of `bench`, a dict of
    the same form), with its files under `root/recbench`."""
    here = Path(root) / "recbench"
    if bench is None:
        bench = _read_json(Path(root) / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"recbench: no workload named {name!r} in "
                         "BENCHMARK.json")
    config = _read_json(here / "configs" / f"{entry['config']}.json")
    traffic = _read_json(here / "traffic" / f"{entry['traffic']}.json")
    limits = _read_json(here / "workloads" / f"{name}.json")["limits"]
    return Cell(name=name, root=Path(root), chips=int(entry["chips"]),
                config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def load_driver(name: str):
    return importlib.import_module(f"recbench.drivers.{name}")


def load_reader(metric: str, root: Path = ROOT):
    """The module `recbench/metrics/<metric>.py` under `root` (a metric's
    name may hold dots)."""
    path = Path(root) / "recbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "recbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def require_cards(torch, chips: int) -> None:
    """Fail, and print no result, without as many cards as the cell asks
    for: a measurement never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise SystemExit("recbench: no CUDA device; this benchmark measures "
                         "the card and does not fall back to the CPU")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"recbench: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} present")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (`tpu3drec_torch` is not `tpu3drec`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    """The card's power limit as `nvidia-smi` reads it (W), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_info(torch, device: str) -> Dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
            "power_limit_w": power_limit_w()}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float) -> Dict:
    """Set-up, the measured window, the traced stretch (with `trace`), and
    the comparison that decides `correct`; returns the result line."""
    import torch
    driver = load_driver(cell.traffic["driver"])
    state = driver.setup(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    win = driver.window(state, seconds)
    info = device_info(torch, device)
    metrics: Dict[str, Dict] = {}
    breakdown = None
    if not trace:
        values = dict(win["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = driver.trace(state, win)
        tr = ctx["trace"]
        for m in cell.per_layer:
            value = load_reader(m["name"], cell.root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
        breakdown = {"device_ops": [list(r) for r in tr.device_ops],
                     "idle_gaps": [list(r) for r in tr.idle_gaps]}
    driver.release(state)
    numbers = driver.check(state, win)
    # a number that is not finite fails, and reads null in the JSON line
    checks = {k: {"value": float(numbers[k]) if math.isfinite(numbers[k])
                  else None, "limit": float(cell.limits[k])}
              for k in cell.limits}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def report_checks(result: Dict) -> None:
    """Each number compared beside its limit, as the last lines on
    standard error."""
    for name, c in result["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        verdict = "ok" if ok else "FAILED"
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) "
              f"{verdict}", file=sys.stderr)
    sys.stderr.flush()
