"""Host ms a GAN step building its batch in ``PatchBatches.epoch`` (the program's span ``data.batch``)."""

from perfbench.core import program


def read(r):
    return program.span_ms(r.profile, "data.batch")
