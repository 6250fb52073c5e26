"""Of the longest idle gaps of the device, the share of their time that begins inside a span of the program, %."""

from perfbench.core import program


def read(r):
    return program.idle_named_share(r.profile)
