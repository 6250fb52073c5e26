"""The readers of the share of train-mode BatchNorm calls on CUDA maps that
took the hand-written kernels (``metrics/*.bn_kernel_share.py``): 100 times
the program's counter ``bn.layers_kernel`` over ``bn.layers``, declared for
its one training cell, and no number from a program that keeps neither
counter (one whose BatchNorm is the PyTorch composite alone)."""

import pytest

from perfbench.core import spec
from perfbench.tests.test_perfbench_conv_nhwc_share import read

#: reader -> (its cell, its layer)
NAMES = {"gan_train.bn_kernel_share": ("rnagan-dcgan256.cli-train-b8",
                                       "GAN model step: models/dcgan.py, losses/gan.py"),
         "quality_train.bn_kernel_share": ("rnagan-dcgan256.quality-train-b32",
                                           "GAN model step: models/dcgan.py, losses/gan.py"),
         "biggan_train.bn_kernel_share": ("rnagan-biggan256.cond-cli-train-b8",
                                          "BigGAN model step: models/biggan_pub.py, models/sagan.py, losses/gan.py")}


@pytest.mark.parametrize("name", NAMES)
def test_the_share_is_the_kernel_count_over_all(monkeypatch, name):
    from rnagan_tpu_torch.core import profiling

    monkeypatch.setattr(profiling, "counters", {"bn.layers": 88, "bn.layers_kernel": 88})
    assert read(name) == pytest.approx(100.0)
    monkeypatch.setattr(profiling, "counters", {"bn.layers": 88, "bn.layers_kernel": 22, "gan.convs": 5})
    assert read(name) == pytest.approx(25.0)


@pytest.mark.parametrize("counters", [{"gan.convs": 84, "gan.convs_channels_last": 84}, {"bn.layers": 0}, None])
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
    cell, layer = NAMES[name]
    assert entry["source"] == "program_counter" and entry["unit"] == "%" and entry["better"] == "higher"
    assert entry["layer"] == layer
    assert entry["moves"] == ("quality_train_samples_per_s" if name.startswith("quality") else "gan_train_samples_per_s")
    assert entry["workloads"] == [cell]
