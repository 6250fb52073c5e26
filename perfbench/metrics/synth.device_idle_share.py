"""The device's idle share of the profiled synthesis requests, %."""

from perfbench.metrics import idle_share as read  # noqa: F401
