"""Device ms a request in the BN-folded generator, bias adds and layout transposes included
(stage ``synth_generator``)."""

from perfbench.core import program


def read(r):
    return program.stage_ms(r.profile, "synth_generator")
