"""Device ms a step rendering its tiles inside the step's graph (stage ``render``)."""

from perfbench.core import program


def read(r):
    return program.stage_ms(r.profile, "render")
