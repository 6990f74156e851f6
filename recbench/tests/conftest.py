"""Shared set-up of the benchmark's own tests: the repository root on the
path, the `card` marker, and the tiny CPU sizes that the drivers run at
here."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from recbench import harness  # noqa: E402

DENSE = "dense.folder-vga-24.from-sparse"


def bench_with_parked():
    """`BENCHMARK.json` with the entries of the parked cells
    (`recbench/parked/`) added."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for path in sorted((ROOT / "recbench" / "parked").glob("*.json")):
        for key, entries in json.loads(path.read_text()).items():
            bench[key] = bench[key] + entries
    return bench


def load(name):
    """A cell of `BENCHMARK.json` or a parked one."""
    return harness.load_cell(name, bench=bench_with_parked())


def exact_knn_indices(points, k, mask=None, device="cpu", **_):
    """`ops/pointcloud.py:voxel_knn_indices` with exact neighbours: each
    valid point's k nearest valid points, itself first, (idx (N, k),
    nbr_mask (N, k)); invalid slots point at the row itself."""
    import numpy as np
    import torch

    from recbench.reference import surface
    n = len(points)
    valid = (np.ones(n, bool) if mask is None
             else np.asarray(mask, bool))
    orig = np.nonzero(valid)[0]
    idx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k))
    nbr = np.zeros((n, k), bool)
    kk = min(k, len(orig))
    if kk:
        pts = torch.as_tensor(np.asarray(points, np.float32)[orig],
                              device=device)
        near = surface.knn_indices(pts, kk).cpu().numpy()
        idx[orig, :kk] = orig[near]
        nbr[orig, :kk] = True
    return idx, nbr


@pytest.fixture
def exact_neighbours(monkeypatch):
    """The program with exact nearest neighbours in place of its
    voxel-hash search (the normals past 16,384 points and the cloud's
    nearest-neighbour statistics): the program fault that parks the
    dense cell, put right here so that the rest of the cell is tested."""
    from tpu3drec_torch.ops import pointcloud as pc
    monkeypatch.setattr(pc, "voxel_knn_indices", exact_knn_indices)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present (decided here, when
    the test runs, never while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def shrink(cell):
    """The cell at a size the CPU runs in seconds, through the program's
    plain paths; every shape rule of the full size holds."""
    if cell.traffic["driver"] == "pairs":
        cell.config.update(height=120, width=160, max_features=256)
        cell.traffic.update(batch=2, pool_batches=2, trace_batches=2)
    else:
        cell.config.update(views=4, points=300, focal=136.0, height=120,
                           width=160)
        cell.config["dense"].update(num_disparities=16, tsdf_resolution=32)
    return cell


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
