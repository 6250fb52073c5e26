"""The benchmark of ``rnagan_tpu_torch`` on one NVIDIA H100 (``python3 perfbench/run.py``).

Nothing here imports JAX or the JAX package; ``reference/`` imports nothing of
the port either.
"""
