"""The lower-precision control comes out not correct on the card, at the cells'
own sizes and one seed each (the readings behind the limits use a dozen:
``perfbench/readings.py``)."""

import pytest
import torch

from perfbench.core import bench, compare, spec
from perfbench.tests import tiny

CONTROL = {"rnagan-dcgan256.cli-train-b8": "fp8", "betavae-gtex.resident-train-b128": "tf32",
           "rnagan-dcgan256.quality-train-b32": "fp8", "rnagan-dcgan256.synth-b128": "fp8"}


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
    control = runner.controls()[CONTROL[name]]
    assert not compare.passes(compare.judge(control, cell.limits)), control
    torch.cuda.synchronize()
