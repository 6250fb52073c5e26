"""Device ms a β-VAE step in the model: the stages ``vae_forward`` and ``vae_backward``."""

from perfbench.core import program


def read(r):
    return program.stage_ms(r.profile, "vae_forward", "vae_backward")
