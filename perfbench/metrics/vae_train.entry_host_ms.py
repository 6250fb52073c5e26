"""Host ms a β-VAE step inside `VAETrainer.run_resident`, table loads and a full launch queue included."""

from perfbench.metrics import entry_host_ms as read  # noqa: F401
