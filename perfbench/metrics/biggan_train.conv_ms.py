"""Device ms a BigGAN step of the convolution kernels (cuDNN's fprop, dgrad and wgrad)."""

from perfbench.metrics import category_ms


def read(r):
    return category_ms(r, "convolution")
