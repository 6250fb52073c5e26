"""Host ms a request inside ``Synthesizer.synthesize`` (span ``synth.request``): the program's own host time."""

from perfbench.core import program


def read(r):
    return program.span_ms(r.profile, "synth.request")
