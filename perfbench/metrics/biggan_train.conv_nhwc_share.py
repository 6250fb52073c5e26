"""The share of the published BigGAN's convolutions issued on channels-last operands, % (the
program's counters ``gan.convs_channels_last`` over ``gan.convs``, over the whole run)."""

from perfbench.core.program import counter_ratio


def read(r):
    ratio = counter_ratio("gan.convs_channels_last", "gan.convs")
    return None if ratio is None else 100.0 * ratio
