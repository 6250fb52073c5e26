"""The readers of the share of the GAN nets' convolutions issued on
channels-last operands (``metrics/*.conv_nhwc_share.py``): 100 times the
program's counter ``gan.convs_channels_last`` over ``gan.convs``, each declared
for its training cell, and no number from a program that keeps neither counter
(one whose ``biggan_pub`` convolves through ``Walk.conv`` counts none)."""

import pytest

from perfbench.core import bench, spec, trace

GAN_STEP = "GAN model step: models/dcgan.py, losses/gan.py"
BIGGAN_STEP = "BigGAN model step: models/biggan_pub.py, models/sagan.py, losses/gan.py"
#: each reader: its layer, its cell and the layers a step of that cell counts
NAMES = {"gan_train.conv_nhwc_share": (GAN_STEP, "rnagan-dcgan256.cli-train-b8", 84),
         "quality_train.conv_nhwc_share": (GAN_STEP, "rnagan-dcgan256.quality-train-b32", 84),
         "biggan_train.conv_nhwc_share": (BIGGAN_STEP, "rnagan-biggan256.cond-cli-train-b8", 412)}
#: counters of a program that keeps neither of the reader's (``None``: no counters at all)
WITHOUT = [{"graph.h2d_bytes": 5}, {"gan.sn_layers": 5, "gan.layers": 5}, {"gan.convs": 0}, None]


def read(name):
    r = bench.Readings(bench.Window(1.0, 10, 80, []), {}, trace.Profile([], [], 1.0, 10, {}), {})
    return spec.load_module(spec.HERE / "metrics" / f"{name}.py").read(r)


@pytest.mark.parametrize("name", NAMES)
def test_the_share_is_the_channels_last_count_over_all(monkeypatch, name):
    from rnagan_tpu_torch.core import profiling

    convs = NAMES[name][2]
    monkeypatch.setattr(profiling, "counters", {"gan.convs": convs, "gan.convs_channels_last": convs})
    assert read(name) == pytest.approx(100.0)
    monkeypatch.setattr(profiling, "counters", {"gan.convs": convs, "gan.convs_channels_last": convs // 4})
    assert read(name) == pytest.approx(25.0)


@pytest.mark.parametrize("counters", WITHOUT)
@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_the_counters_gives_no_number(monkeypatch, name, counters):
    from rnagan_tpu_torch.core import profiling

    if counters is None:
        monkeypatch.delattr(profiling, "counters")
    else:
        monkeypatch.setattr(profiling, "counters", counters)
    assert read(name) is None


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_is_declared_for_its_training_cell(name):
    entry = next(m for m in spec.load_benchmark()["per_layer"] if m["name"] == name)
    layer, cell, _ = NAMES[name]
    assert entry["source"] == "program_counter" and entry["unit"] == "%" and entry["better"] == "higher"
    assert entry["layer"] == layer
    moves = "quality_train_samples_per_s" if name.startswith("quality") else "gan_train_samples_per_s"
    assert entry["moves"] == moves
    assert entry["workloads"] == [cell]
