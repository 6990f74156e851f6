"""Torch's intra-op threads for the port's tests under pytest-xdist.

Tier-1 runs six workers on the host's cores, and each worker's torch
starts one OpenMP thread per core, so the workers' spinning threads
contend: a port test that takes 1 s alone took 120 s in such a run, and
the port's test files took 689 s with 8 threads a worker against 186 s
with 2 (six workers on 8 cores). Each port test module imports
`torch_threads`, an autouse fixture that gives torch the worker's share
of the cores, at least two, while the module runs and restores the
setting after. In one process (no xdist) it changes nothing.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers < 2:
        yield
        return
    saved = torch.get_num_threads()
    torch.set_num_threads(max(2, (os.cpu_count() or 2) // workers))
    try:
        yield
    finally:
        torch.set_num_threads(saved)
