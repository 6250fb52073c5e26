"""The whole quality-run step's share of the card's peak, %: the GAN step's operations (the render's elementwise work is not counted)."""

from perfbench.metrics import mfu as read  # noqa: F401
