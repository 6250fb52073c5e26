"""Work counted from the configurations' shapes: operations by precision and bytes.

They count what the algorithm requires, whatever implements it, so they stay
the same when a later change replaces a kernel. Copied from the port's
``chip_smoke.py`` (``generator_flops``, ``vae_encode_flops``,
``vae_fwd_bwd_flops``, K3's 28 bytes a parameter) and extended to the GAN
step and the requests the cells run.
"""
