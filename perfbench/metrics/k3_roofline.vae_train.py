"""K3's share of its roofline in a β-VAE step, %."""

from perfbench.metrics import k3_roofline as read  # noqa: F401
