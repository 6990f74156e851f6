"""Nothing the benchmark runs loads JAX, Flax or the JAX package, and the
plain reference loads nothing of the program. Top-level module names are
compared whole: `tpu3drec_torch` is not `tpu3drec`."""

import ast
import json
import subprocess
import sys

from recbench.harness import FORBIDDEN
from recbench.tests.conftest import ROOT

RB = ROOT / "recbench"


def _imported_tops(path):
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_import_nothing_forbidden():
    for path in RB.rglob("*.py"):
        assert not _imported_tops(path) & set(FORBIDDEN), path
    for path in (RB / "reference").rglob("*.py"):
        assert "tpu3drec_torch" not in _imported_tops(path), path


def _subprocess(code):
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


RUN_EVERY_CELL = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from recbench import harness
from recbench.tests.conftest import shrink
for name in {cells!r}:
    cell = shrink(harness.load_cell(name))
    for m in cell.per_layer:
        harness.load_reader(m["name"])
    harness.run_cell(cell, 3, 0.2, False, "cpu", time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_nothing_forbidden():
    """Every module a run of each cell loads, the program's included."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in bench["workloads"]]
    tops = set(_subprocess(RUN_EVERY_CELL.format(root=str(ROOT),
                                                 cells=cells)))
    assert "tpu3drec_torch" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import torch
import recbench.reference.pairs as p, recbench.reference.dense as d
from recbench.gen import photos, splats
g = torch.Generator().manual_seed(0)
a = photos.photos(2, 96, 128, g, "cpu")
p.pair_step(a, photos.warp(a, photos.similarity_warps(2, 96, 128, g)), 128, 16)
s = splats.render_splat_views(3, 100, 0, 1, 2.0, f=100.0, width=128,
                            height=96)
d.dense_depth_and_cloud(splats.sparse_input(s), s["images"], "cpu",
                        num_disparities=8, tsdf_resolution=16)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    tops = set(_subprocess(code))
    assert "tpu3drec_torch" not in tops
    assert not tops & set(FORBIDDEN)
