"""The readers of the share of the DCGAN nets' convolutions issued on
channels-last operands (``metrics/*.conv_nhwc_share.py``): 100 times the
program's counter ``gan.convs_channels_last`` over ``gan.convs``, and no number
from a program that keeps neither counter."""

import pytest

from perfbench.core import bench, spec, trace

NAMES = ("gan_train.conv_nhwc_share", "quality_train.conv_nhwc_share")


def read(name):
    r = bench.Readings(bench.Window(1.0, 10, 80, []), {}, trace.Profile([], [], 1.0, 10, {}), {})
    return spec.load_module(spec.HERE / "metrics" / f"{name}.py").read(r)


@pytest.mark.parametrize("name", NAMES)
def test_the_share_is_the_channels_last_count_over_all(monkeypatch, name):
    from rnagan_tpu_torch.core import profiling

    monkeypatch.setattr(profiling, "counters", {"gan.convs": 84, "gan.convs_channels_last": 84})
    assert read(name) == pytest.approx(100.0)
    monkeypatch.setattr(profiling, "counters", {"gan.convs": 84, "gan.convs_channels_last": 21})
    assert read(name) == pytest.approx(25.0)


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_the_counters_gives_no_number(monkeypatch, name):
    from rnagan_tpu_torch.core import profiling

    monkeypatch.setattr(profiling, "counters", {"graph.h2d_bytes": 5})
    assert read(name) is None
    monkeypatch.setattr(profiling, "counters", {"gan.convs": 0})
    assert read(name) is None
    monkeypatch.delattr(profiling, "counters")
    assert read(name) is None


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_is_declared_for_its_training_cell(name):
    entry = next(m for m in spec.load_benchmark()["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_counter" and entry["unit"] == "%"
    assert entry["layer"] == "GAN model step: models/dcgan.py, losses/gan.py"
    cell = "rnagan-dcgan256.cli-train-b8" if name.startswith("gan_train") else "rnagan-dcgan256.quality-train-b32"
    assert entry["workloads"] == [cell]
