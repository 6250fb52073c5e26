"""Device ms a β-VAE step drawing its dropout mask and eps (stage ``vae_mask``)."""

from perfbench.core import program


def read(r):
    return program.stage_ms(r.profile, "vae_mask")
