"""The reader of the share of the published BigGAN's convolutions issued on
channels-last operands (``metrics/biggan_train.conv_nhwc_share.py``): the
DCGAN readers' quantity, 100 times the program's counter
``gan.convs_channels_last`` over ``gan.convs``, declared for the BigGAN cell,
and no number from a program that keeps neither counter (one whose
``biggan_pub`` convolves through ``Walk.conv`` counts none)."""

import pytest

from perfbench.core import spec
from perfbench.tests.test_perfbench_conv_nhwc_share import read

NAME = "biggan_train.conv_nhwc_share"


def test_the_share_is_the_channels_last_count_over_all(monkeypatch):
    from rnagan_tpu_torch.core import profiling

    monkeypatch.setattr(profiling, "counters", {"gan.convs": 412, "gan.convs_channels_last": 412})
    assert read(NAME) == pytest.approx(100.0)
    monkeypatch.setattr(profiling, "counters", {"gan.convs": 412, "gan.convs_channels_last": 103})
    assert read(NAME) == pytest.approx(25.0)


@pytest.mark.parametrize("counters", [{"gan.sn_layers": 5, "gan.layers": 5}, {"gan.convs": 0}, None])
def test_a_program_without_the_counters_gives_no_number(monkeypatch, counters):
    from rnagan_tpu_torch.core import profiling

    if counters is None:
        monkeypatch.delattr(profiling, "counters")
    else:
        monkeypatch.setattr(profiling, "counters", counters)
    assert read(NAME) is None


def test_the_reader_is_declared_for_the_biggan_cell():
    entry = next(m for m in spec.load_benchmark()["per_layer"] if m["name"] == NAME)
    assert entry["source"] == "program_counter" and entry["unit"] == "%" and entry["better"] == "higher"
    assert entry["layer"] == "BigGAN model step: models/biggan_pub.py, models/sagan.py, losses/gan.py"
    assert entry["moves"] == "gan_train_samples_per_s"
    assert entry["workloads"] == ["rnagan-biggan256.cond-cli-train-b8"]
