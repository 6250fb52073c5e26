"""``BENCHMARK.json`` keeps to the benchmark's contract, and every file it names resolves by name."""

import json
import re
from pathlib import Path

import pytest

from perfbench.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["paths"] == ["perfbench"]
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert (spec.ROOT / BENCH["command"][1]).is_file()


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (spec.ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and "\n" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_file_of_a_cell_resolves(name):
    cell = spec.Cell(BENCH, name)
    assert (spec.HERE / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert hasattr(cell.driver(), "Runner")
    assert cell.limits and all("limit" in v for v in cell.limits.values())
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported, (m["name"], m["moves"])
        assert callable(cell.metric_reader(m["name"]).read)


def test_no_other_file_names_a_cell_or_metric():
    """The harness holds no list of configurations, mixes, cells or metrics."""
    names = [w["traffic"] for w in BENCH["workloads"]] + [m["name"] for m in BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]]
    for path in list((spec.HERE / "core").glob("*.py")) + [spec.HERE / "run.py"]:
        text = Path(path).read_text()
        for n in names:
            assert n not in text, (path.name, n)
