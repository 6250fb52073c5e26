"""A frozen copy of the GAN data plane's arithmetic, so the reference builds its
own real batches from the corpus's raw uint8 tiles.

``epoch_order`` is the shuffle of an epoch's batches (``data/batching.py`` of
the port: ``RandomState(seed + epoch)`` shuffles ``arange(n)``, and batch i
takes the order's slice ``[i * batch, (i + 1) * batch)``); ``tiles_to_float``
maps uint8 NHWC to float32 in [-1, 1] (``data/tiles.py``). Like ``draws.py``
it stays as it is: a change to the port's data plane shows as a failed
comparison.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    order = np.arange(n)
    np.random.RandomState(seed + epoch).shuffle(order)
    return order


def tiles_to_float(tiles: torch.Tensor) -> torch.Tensor:
    """uint8 (N, H, W, C) in [0, 255] -> float32 in [-1, 1]."""
    return (tiles.to(torch.float32) / 255.0 - 0.5) / 0.5


def first_batches(images: np.ndarray, rna: np.ndarray, slide_idx: np.ndarray, batch: int, steps: int, seed: int,
                  device) -> List[Dict[str, torch.Tensor]]:
    """The first ``steps`` batches of epoch 0 (full batches): ``image`` float32
    NHWC and each tile's slide row of ``rna``, on ``device``."""
    order = epoch_order(len(images), seed, 0)
    out = []
    for i in range(steps):
        idx = order[i * batch:(i + 1) * batch]
        out.append({"image": tiles_to_float(torch.as_tensor(images[idx]).to(device)),
                    "rna_data": torch.as_tensor(rna[slide_idx[idx]], dtype=torch.float32).to(device)})
    return out
