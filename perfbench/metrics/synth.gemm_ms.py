"""Device ms a request of the frozen encoder's matrix products (cuBLAS GEMMs)."""

from perfbench.metrics import category_ms


def read(r):
    return category_ms(r, "gemm")
