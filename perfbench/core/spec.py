"""``BENCHMARK.json`` and the files it names, found by name (no list of them in code).

A cell ``<config>.<traffic>`` reads ``configs/<config>.json`` (the sizes),
``traffic/<traffic>.json`` (the mix's parameters, among them the name of
the ``drivers/<driver>.py`` that runs it) and ``limits/<cell>.json`` (the
comparison's limits). A per-layer metric ``<name>`` is read by
``metrics/<name>.py``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    """``base`` with ``over``'s keys, nested dicts merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_module(path: Path) -> ModuleType:
    """A Python file as a module (file names may hold dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location("perfbench_" + path.stem.replace(".", "_").replace("-", "_"),
                                                  path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, bench: Dict[str, Any], name: str, base: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        self.base = base
        self.config_entry = next(c for c in bench["configs"] if c["name"] == self.entry["config"])
        self.config = read_json(base.parent / self.config_entry["file"])
        self.traffic = read_json(base / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = read_json(base / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer: List[Dict[str, Any]] = [
            m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]

    def driver(self) -> ModuleType:
        return load_module(self.base / "drivers" / f"{self.traffic['driver']}.py")

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(self.base / "metrics" / f"{name}.py")
