"""Host ms a step in ``CUDAGraph.replay``, a full launch queue included (span ``graph.replay``)."""

from perfbench.core import program


def read(r):
    return program.span_ms(r.profile, "graph.replay")
