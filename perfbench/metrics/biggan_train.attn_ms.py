"""Device ms a BigGAN step in the attention forwards (stage ``gan_attn``: the spectral norms of
theta, phi, g and o, the 1x1 convolutions, the pooling, both products and the softmax)."""

from perfbench.core.program import stage_ms


def read(r):
    return stage_ms(r.profile, "gan_attn")
