"""Device ms a GAN step in the gradient penalty (stage ``gan_gp``: interpolation, D and the input gradient)."""

from perfbench.core import program


def read(r):
    return program.stage_ms(r.profile, "gan_gp")
