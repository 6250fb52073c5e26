"""The device's idle share of the profiled β-VAE steps, %."""

from perfbench.metrics import idle_share as read  # noqa: F401
