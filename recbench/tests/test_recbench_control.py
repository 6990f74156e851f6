"""The control of `correct` comes out not correct.

The control is the plain reference, one precision below the
configuration's, put in the program's place: TF32 operands in the scale
space's matmuls for the pair step (float32 with TF32 off), bfloat16
rectified images and volumes for the dense stage (float32). Each cell's
control has to fail at least one of the cell's limits, on every seed,
while the program (the plain paths here) passes all of them. On the CPU
this runs at a tiny size; on a card at the cells' own sizes. The parked
dense cell runs with exact neighbours in the program's place (see
`conftest.exact_neighbours`)."""

import pytest

from recbench import readings
from recbench.tests.conftest import DENSE, load, shrink

CELLS = ["pairs.sift-vga-2048.b96", DENSE, "pairs.sift-vga-2048.b8"]


def _fails(numbers, limits):
    return [k for k in limits if k in numbers and numbers[k] > limits[k]]


def _hold(cell, res):
    for prog in res["program"]:
        assert not _fails(prog, cell.limits), prog
    for ctrl in res["control"]:
        assert _fails(ctrl, cell.limits), ctrl


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_a_tiny_size(name, exact_neighbours):
    cell = shrink(load(name))
    _hold(cell, readings.readings(cell, [1, 2], 0.2, "cpu"))


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name, monkeypatch):
    if name == DENSE:
        from tpu3drec_torch.ops import pointcloud as pc

        from recbench.tests.conftest import exact_knn_indices
        monkeypatch.setattr(pc, "voxel_knn_indices",
                            lambda *a, **kw: exact_knn_indices(
                                *a, device=card, **kw))
    cell = load(name)
    _hold(cell, readings.readings(cell, [101, 102, 103], 2.0, card))
