"""The share of the DCGAN nets' train-mode BatchNorm calls in the cli cell on CUDA maps that took the hand-written
BatchNorm kernels, % (the program's counters ``bn.layers_kernel`` over ``bn.layers``, over the whole run)."""

from perfbench.core.program import counter_ratio


def read(r):
    ratio = counter_ratio("bn.layers_kernel", "bn.layers")
    return None if ratio is None else 100.0 * ratio
