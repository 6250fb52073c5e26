"""Host ms a quality-run step inside `GANTrainer.run_steps`: the chunk's table load and its replays enqueued."""

from perfbench.metrics import entry_host_ms as read  # noqa: F401
