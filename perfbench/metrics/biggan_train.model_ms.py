"""Device ms a BigGAN step in G and D: the stages ``gan_g_forward``, ``gan_d_forward``, ``gan_gp``,
``gan_d_backward``, ``gan_g_step`` and the attention forwards inside them (``gan_attn``)."""

from perfbench.core.program import stage_ms

STAGES = ("gan_g_forward", "gan_d_forward", "gan_gp", "gan_d_backward", "gan_g_step", "gan_attn")


def read(r):
    return stage_ms(r.profile, *STAGES)
