"""Device ms a request of the generator's convolution kernels (cuDNN)."""

from perfbench.metrics import category_ms


def read(r):
    return category_ms(r, "convolution")
