"""Device ms a β-VAE step of the matrix-product kernels (cuBLAS GEMMs)."""

from perfbench.metrics import category_ms


def read(r):
    return category_ms(r, "gemm")
