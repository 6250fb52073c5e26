"""A configuration, a traffic mix and a per-layer metric are added as new files only."""

import json
import shutil

import torch

from perfbench.core import bench, spec, trace
from perfbench.tests import tiny


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
