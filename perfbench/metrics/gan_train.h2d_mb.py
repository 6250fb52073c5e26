"""MB a GAN step copied from host memory by ``StepGraph.load`` (the program's counters
``graph.h2d_bytes`` over ``graph.loaded_steps``, over the whole run)."""

from perfbench.core import program


def read(r):
    ratio = program.counter_ratio("graph.h2d_bytes", "graph.loaded_steps")
    return None if ratio is None else ratio / 1e6
