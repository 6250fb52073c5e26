"""The lower-precision control that a cell's driver declares (``CONTROL``,
``perfbench/faults.py``) is among its runner's controls, and comes out not
correct on the card, at the cells' own sizes and one seed each (the readings
behind the limits use a dozen: ``perfbench/readings.py``)."""

import pytest
import torch

from perfbench import faults
from perfbench.core import bench, compare, spec
from perfbench.tests import tiny


def control_of(cell: spec.Cell) -> str:
    """The key of the cell's runner's ``controls()`` whose numbers must fail its limits."""
    return faults.control(cell.traffic["driver"], cell.base)


@pytest.mark.parametrize("name", tiny.CELLS)
def test_the_declared_control_is_among_the_runners_controls(name):
    runner = tiny.runner(name)
    runner.check()
    assert control_of(spec.Cell(spec.load_benchmark(), name)) in runner.controls()


@pytest.mark.card
@pytest.mark.parametrize("name", tiny.CELLS)
def test_the_control_fails_the_limits(card, name):
    cell = spec.Cell(spec.load_benchmark(), name)
    ctx = bench.Context(cell.config, cell.traffic, 2 ** 31 + 4242, card, bench.Spans(False))
    runner = cell.driver().Runner(ctx)
    runner.setup()
    for _ in range(cell.traffic.get("sample_from", -1) + 1):
        runner.unit()
    assert compare.passes(compare.judge(runner.check(), cell.limits))
    control = runner.controls()[control_of(cell)]
    assert not compare.passes(compare.judge(control, cell.limits)), control
    torch.cuda.synchronize()
