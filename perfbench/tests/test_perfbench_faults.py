"""A run whose timed path is broken underneath comes out not correct: for each
fault a cell can have (``perfbench/faults.py``), planted in the program and
driven through the rest of a run on the CPU at tiny widths (the look for a
card skipped)."""

import pytest

from perfbench import faults
from perfbench.core import spec
from perfbench.tests import tiny

CASES = [(cell, fault) for cell in tiny.CELLS
         for fault in faults.FAULTS[spec.Cell(spec.load_benchmark(), cell).traffic["driver"]]]


@pytest.mark.parametrize("cell, fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    with faults.plant(fault):
        result = tiny.run(cell)
    assert result["correct"] is False, result["checks"]
