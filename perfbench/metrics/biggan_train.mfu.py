"""The whole BigGAN step's share of the card's peak, %."""

from perfbench.metrics import mfu as read  # noqa: F401
