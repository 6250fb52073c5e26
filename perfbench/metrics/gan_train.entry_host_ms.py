"""Host ms a GAN step inside `GANTrainer.train_step`, the pinned copy, the table load and the launch."""

from perfbench.metrics import entry_host_ms as read  # noqa: F401
