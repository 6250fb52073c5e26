"""Tile batching on the host (port of ``rnagan_tpu/data/tiles.py``).

Epoch batches over in-memory tile arrays (wrap-padded as ``data/batching.py``
pads), the float conversion the reference does with torchvision transforms
(ConvertImageDtype + Normalize(0.5, 0.5) -> [-1, 1],
``histopathology_gan.py:106-109``), and a threaded prefetcher that overlaps
host decode with the card's step.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from rnagan_tpu_torch.data.batching import batch_indices


def tiles_to_float(images: np.ndarray) -> np.ndarray:
    """uint8 NHWC [0, 255] -> float32 [-1, 1]."""
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 255.0
    return (np.asarray(images, np.float32) - 0.5) / 0.5


class TileBatches:
    """Epoch batch iterator over tiles, with optional per-tile RNA rows and
    labels (the reference's PatchDataset / PatchRNADataset at the batch level)."""

    def __init__(self, images: np.ndarray, rna: Optional[np.ndarray] = None,
                 labels: Optional[np.ndarray] = None, *, batch_size: int = 8, shuffle: bool = True,
                 seed: int = 0, pad_to: int = 1, drop_remainder: bool = False):
        self.images, self.rna, self.labels = images, rna, labels
        self.batch_size, self.shuffle, self.seed = batch_size, shuffle, seed
        self.pad_to, self.drop_remainder = pad_to, drop_remainder

    def __len__(self):
        n = len(self.images)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        for idx, _ in batch_indices(len(self.images), self.batch_size, shuffle=self.shuffle,
                                    seed=self.seed, epoch=epoch, pad_to=self.pad_to,
                                    drop_remainder=self.drop_remainder):
            batch = {"image": tiles_to_float(self.images[idx])}
            if self.rna is not None:
                batch["rna_data"] = np.asarray(self.rna[idx], np.float32)
            if self.labels is not None:
                batch["labels"] = np.asarray(self.labels[idx], np.int32)
            yield batch


class Prefetcher:
    """Runs ``iterator`` on a worker thread, ``depth`` items ahead of the
    consumer (the reference leans on 4 DataLoader workers,
    ``histopathology_gan.py:164-168``). ``transfer``, when given, is applied
    to each item on the worker (e.g. a pinned copy to the card), so the copy
    of batch N+1 overlaps the step on batch N. An exception on the worker is
    raised at the consumer's next ``next()``. A consumer that stops early
    calls :meth:`close` before the iterator's sources go away."""

    def __init__(self, iterator: Iterator, depth: int = 2, transfer: Optional[Callable] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def run():
            try:
                for item in iterator:
                    if self._stop.is_set():
                        break
                    self._q.put(transfer(item) if transfer is not None else item)
            except BaseException as e:  # handed to the consumer, re-raised there
                self._err = e
            finally:
                self._q.put(self._sentinel)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stops the worker once the item it is on is made, drops what it
        holds and waits for it to end."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.01)
            except queue.Empty:
                pass
        self._thread.join()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._sentinel:
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
