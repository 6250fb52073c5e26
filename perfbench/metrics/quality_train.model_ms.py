"""Device ms a GAN step in G and D: the stages ``gan_g_forward``, ``gan_d_forward``, ``gan_gp``,
``gan_d_backward`` and ``gan_g_step``, between their marks."""

from perfbench.core import program

STAGES = ("gan_g_forward", "gan_d_forward", "gan_gp", "gan_d_backward", "gan_g_step")


def read(r):
    return program.stage_ms(r.profile, *STAGES)
