"""Every cell runs end to end on the CPU at tiny widths through the plain paths,
and its result line has the contract's keys in order; without a card the
command gives no result."""

import json
import subprocess
import sys

import pytest

from perfbench.core import spec
from perfbench.tests import tiny


@pytest.mark.parametrize("name", tiny.CELLS)
def test_cell_runs_on_the_cpu_and_prints_the_line(name):
    result = tiny.run(name)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["attempted"] > 0 and result["failed"] == 0 and isinstance(result["correct"], bool)
    cell = spec.Cell(spec.load_benchmark(), name)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in result["metrics"].values():
        assert m["value"] > 0
    assert set(result["checks"]) == set(cell.limits)
    json.loads(json.dumps(result))


def test_without_a_card_the_command_gives_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    cmd = [sys.executable, str(spec.HERE / "run.py"), "--workload", tiny.CELLS[0], "--seed", str(2 ** 32 + 5),
           "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=spec.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_the_percentile_is_linear_between_order_statistics():
    from perfbench.core.bench import percentile

    assert percentile([1.0, 2.0, 3.0, 4.0, 5.0], 95.0) == pytest.approx(4.8)
    assert percentile([7.0], 95.0) == 7.0
