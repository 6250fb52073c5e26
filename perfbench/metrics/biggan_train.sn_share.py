"""The share of the nets' weight-bearing layers that a training forward normalizes spectrally, %
(the program's counters ``gan.sn_layers`` over ``gan.layers``, over the whole run)."""

from perfbench.core.program import counter_ratio


def read(r):
    ratio = counter_ratio("gan.sn_layers", "gan.layers")
    return None if ratio is None else 100.0 * ratio
