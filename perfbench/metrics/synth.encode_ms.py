"""Device ms a request in the frozen encoder (stage ``synth_encode``)."""

from perfbench.core import program


def read(r):
    return program.stage_ms(r.profile, "synth_encode")
