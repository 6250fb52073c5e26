"""Host ms a GAN step in ``StepGraph.load``: pinning and the host-to-device copies (span ``graph.load``)."""

from perfbench.core import program


def read(r):
    return program.span_ms(r.profile, "graph.load")
