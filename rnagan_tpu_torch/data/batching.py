"""Epoch-batch index generation (copy of ``rnagan_tpu/data/batching.py``).

A deterministic per-epoch shuffle, sliced into batches; a short final batch
is wrap-padded with real rows up to ``min(batch_size, n)`` (then to a multiple
of ``pad_to``) and the duplicates are marked 0 in a validity mask. On one card
``pad_to`` is 1, but the tail is still padded to a full batch: BatchNorm sees
the duplicated rows, as in the JAX package.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def batch_indices(
    n: int,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    epoch: int = 0,
    pad_to: int = 1,
    drop_remainder: bool = False,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(indices, valid_mask)`` per batch over ``n`` items."""
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(order)
    for start in range(0, n, batch_size):
        idx = order[start : start + batch_size]
        if len(idx) < batch_size and drop_remainder:
            return
        mask = np.ones(len(idx), np.float32)
        target = -(-max(len(idx), min(batch_size, n)) // pad_to) * pad_to
        if len(idx) < target:
            pad = target - len(idx)
            idx = np.concatenate([idx, order[np.arange(pad) % n]])
            mask = np.concatenate([mask, np.zeros(pad, np.float32)])
        yield idx, mask
