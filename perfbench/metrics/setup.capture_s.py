"""Seconds the run spent capturing step graphs, warm-up included (counter ``graph.capture_s``),
read after the window."""

from perfbench.core import program


def read(r):
    return program.counter("graph.capture_s")
