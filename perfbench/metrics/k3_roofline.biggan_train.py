"""K3's share of its roofline in a BigGAN step (G and D), %."""

from perfbench.metrics import k3_roofline as read  # noqa: F401
