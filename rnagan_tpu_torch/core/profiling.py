"""Step timing and device memory (port of ``rnagan_tpu/core/profiling.py``).

:class:`StepTimer` is wall-clock timing that waits for the card
(``torch.cuda.synchronize``) before it reads the clock, so a duration covers
the work it names; :func:`memory_usage` reads the CUDA caching allocator's
statistics.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Union

import torch


def memory_usage(device: Union[str, torch.device, None] = None) -> Dict[str, float]:
    """Allocator statistics of a CUDA device in GiB (all 0 without CUDA)."""
    if not torch.cuda.is_available():
        return {"bytes_in_use_gib": 0.0, "peak_bytes_in_use_gib": 0.0, "bytes_limit_gib": 0.0}
    device = torch.device(device or "cuda")
    gib = 1024**3
    return {
        "bytes_in_use_gib": torch.cuda.memory_allocated(device) / gib,
        "peak_bytes_in_use_gib": torch.cuda.max_memory_allocated(device) / gib,
        "bytes_limit_gib": torch.cuda.get_device_properties(device).total_memory / gib,
    }


class StepTimer:
    """Rolling window of step durations; reports mean/p50/p90 and steps/s."""

    def __init__(self, window: int = 100):
        self.window = window
        self._durs: List[float] = []
        self._t: Optional[float] = None

    def start(self) -> None:
        self._t = time.perf_counter()

    def stop(self, *sync_tensors: torch.Tensor) -> float:
        """End the step once the card has finished the work of ``sync_tensors``
        (any tensor on a CUDA device synchronizes that device)."""
        for dev in {t.device for t in sync_tensors if t.is_cuda}:
            torch.cuda.synchronize(dev)
        dur = time.perf_counter() - self._t
        self._durs.append(dur)
        if len(self._durs) > self.window:
            self._durs.pop(0)
        return dur

    def stats(self) -> Dict[str, float]:
        if not self._durs:
            return {}
        ds = sorted(self._durs)
        n = len(ds)
        mean = sum(ds) / n
        return {
            "step_ms_mean": mean * 1e3,
            "step_ms_p50": ds[n // 2] * 1e3,
            "step_ms_p90": ds[min(n - 1, int(0.9 * n))] * 1e3,
            "steps_per_sec": 1.0 / mean if mean > 0 else 0.0,
        }
