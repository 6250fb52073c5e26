"""A configuration, a traffic mix, a per-layer metric and a driver with its
faults and its control are added as new files only."""

import json
import shutil

import torch

from perfbench import faults
from perfbench.core import bench, spec, trace
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_control import control_of

#: a new driver: synthesis under a new name, with a fault of its own and the fp8 control
NEW_DRIVER = '''"""Synthesis with one fault of its own: every served tile upside down."""

from perfbench.drivers import synthesize

FAULTS = ("synth_tiles_flipped",)
CONTROL = "fp8"


def _tiles_flipped():
    from rnagan_tpu_torch.eval.generate import Synthesizer

    made = Synthesizer.synthesize

    def broken(self, *a, **k):
        return made(self, *a, **k).flip(1)
    return [(Synthesizer, "synthesize", broken)]


PATCHES = {"synth_tiles_flipped": _tiles_flipped}


class Runner(synthesize.Runner):
    pass
'''


def files(root):
    return {p: p.stat().st_mtime_ns for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_mix_config_and_metric_are_found_without_a_code_edit(tmp_path):
    base = tmp_path / "perfbench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench_json = spec.load_benchmark()
    # a new configuration: the paper's generator at half the channels, as a file of its own
    cfg = json.loads((base / "configs" / "rnagan-dcgan256.json").read_text())
    cfg["name"] = "dummy-config"
    (base / "configs" / "dummy-config.json").write_text(json.dumps(cfg))
    # a new mix for an existing driver, and the new cell's limits
    mix = json.loads((base / "traffic" / "synth-b128.json").read_text())
    mix["sample_requests"] = 1
    (base / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (base / "limits" / "dummy-config.dummy-mix.json").write_text(json.dumps({"tile_gap": {"limit": 255.0}}))
    # a new per-layer metric: its reader alone
    (base / "metrics" / "dummy.requests_profiled.py").write_text("def read(r):\n    return float(r.profile.units)\n")
    bench_json["configs"].append({"name": "dummy-config", "source": "https://example.org", "reduced": [],
                                  "file": "perfbench/configs/dummy-config.json", "why": "a test"})
    bench_json["workloads"].append({"name": "dummy-config.dummy-mix", "config": "dummy-config",
                                    "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    for m in bench_json["end_to_end"]:
        if "synth_tiles_per_s" == m["name"] or "synth_request_p95_ms" == m["name"]:
            m["workloads"].append("dummy-config.dummy-mix")
    bench_json["per_layer"].append({"name": "dummy.requests_profiled", "unit": "requests", "better": "higher",
                                    "source": "device_trace", "layer": "device", "moves": "synth_tiles_per_s",
                                    "workloads": ["dummy-config.dummy-mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))

    cell = spec.Cell(spec.load_benchmark(tmp_path), "dummy-config.dummy-mix", base=base)
    assert [m["name"] for m in cell.per_layer if m["name"].startswith("dummy")] == ["dummy.requests_profiled"]
    profile = trace.Profile([("k", 0.0, 1.0)], [], 1.0, 3)
    readings = bench.Readings(bench.Window(1.0, 3, 3, []), {}, profile, {})
    assert cell.metric_reader("dummy.requests_profiled").read(readings) == 3.0
    result = tiny.run("dummy-config.dummy-mix", bench_root=tmp_path, base=base)
    assert set(result["metrics"]) == {"synth_tiles_per_s", "synth_request_p95_ms", "setup_s"}
    assert list(result["checks"]) == ["tile_gap"]
    assert torch.isfinite(torch.tensor(result["checks"]["tile_gap"]["value"]))


def test_a_new_driver_brings_its_faults_and_control_in_its_own_file(tmp_path):
    before = files(spec.HERE)
    base = tmp_path / "perfbench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench_json = spec.load_benchmark()
    (base / "drivers" / "synth_flipped.py").write_text(NEW_DRIVER)
    mix = json.loads((base / "traffic" / "synth-b128.json").read_text())
    (base / "traffic" / "synth-flipped.json").write_text(json.dumps({**mix, "driver": "synth_flipped"}))
    limits = base / "limits"
    shutil.copy(limits / "rnagan-dcgan256.synth-b128.json", limits / "rnagan-dcgan256.synth-flipped.json")
    bench_json["workloads"].append({"name": "rnagan-dcgan256.synth-flipped", "config": "rnagan-dcgan256",
                                    "traffic": "synth-flipped", "chips": 1, "why": "a test"})
    for m in bench_json["end_to_end"]:
        if m["name"] in ("synth_tiles_per_s", "synth_request_p95_ms"):
            m["workloads"].append("rnagan-dcgan256.synth-flipped")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))

    cell = spec.Cell(spec.load_benchmark(tmp_path), "rnagan-dcgan256.synth-flipped", base=base)
    assert faults.declared("synth_flipped", base) == ("synth_tiles_flipped",)
    assert "synth_tiles_flipped" in faults.defined(base) and "synth_tiles_flipped" not in faults.defined()
    assert control_of(cell) == "fp8"
    clean = tiny.run(cell.name, bench_root=tmp_path, base=base)
    assert clean["correct"] is True, clean["checks"]
    with faults.plant("synth_tiles_flipped", base):
        broken = tiny.run(cell.name, bench_root=tmp_path, base=base)
    assert broken["correct"] is False, broken["checks"]
    assert files(spec.HERE) == before
