"""Device ms a BigGAN step in the gradient penalty (stage ``gan_gp``: interpolation, D and the
input gradient; D's attention forward there is ``gan_attn``'s)."""

from perfbench.core.program import stage_ms


def read(r):
    return stage_ms(r.profile, "gan_gp")
