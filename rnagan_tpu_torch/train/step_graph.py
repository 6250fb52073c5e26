"""A training step as a captured CUDA graph: the port's ``jax.jit(...,
donate_argnums=(0,))`` (``rnagan_tpu/train/gan_trainer.py:148``,
``rnagan_tpu/train/vae_trainer.py:92-93``) and the quality tool's scanned
epoch (``tools/quality_run.py:143-175``).

:class:`StepGraph` captures a step function once per *variant* (the GAN
step's variants are whether its G stage runs, the β-VAE's whether RAdam
rectifies) into a ``torch.cuda.CUDAGraph`` and replays it. What changes from step to step lives in static device
buffers that every variant reads:

* **tables**: one row per step, ``capacity`` rows (the batch or the ids it is
  rendered from, given draws, the step's seeds and the optimizer's bias
  corrections and rate).
  :meth:`StepGraph.load` fills rows ``[0, k)`` for the next ``k`` steps with
  one copy each (from pinned memory when the host holds them) and sets the
  step counter to 0;
* **the step counter**: an int64 scalar on the device. Each replay reads row
  ``counter`` of every table and adds 1, so ``k`` replays enqueued back to
  back read ``k`` rows with no host work between them (a table per chunk
  indexed by a device counter: the host never rewrites a row that a replay
  still has to read).

The function updates the training state in place: the kernels write the
parameters and moments, and it ``copy_``'s new statistics into the state's
own tensors, so the graph reads and writes the same memory on every replay
(what "donated" means here). A graph is valid only while those tensors stay
where they are: the caller keys its graphs on their ``data_ptr``s, and a new
state means a new capture.

Capture: the function runs once on a side stream first (cuBLAS and cuDNN
initialize, choose algorithms and allocate there, outside the capture),
from a snapshot of the state tensors and the counter that is copied back
afterwards, so the warm-up does not advance the trajectory. Then it is
captured (nothing runs), and the first replay runs the step it was captured
for. The kernels' launch counters count each replay: the launches a capture
records are added on every replay, and those of the warm-up and the capture
are taken back.

A capture that fails raises; nothing falls back to eager execution. On a
machine without CUDA :class:`StepGraph` raises: the eager step is the
caller's choice, never a silent fallback.

What it records (``core/profiling.py``): the spans ``graph.load``,
``graph.replay`` (each ``CUDAGraph.replay``: a full launch queue shows as
its time) and ``graph.capture`` (warm-up included), and the counters
``graph.h2d_bytes`` (every byte ``load`` copies from the host),
``graph.loaded_steps`` (the rows it loads) and ``graph.capture_s``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Hashable, List, Sequence, Tuple

import torch

from rnagan_tpu_torch.core import profiling
from rnagan_tpu_torch.core.checkpoint import AsyncSaver
from rnagan_tpu_torch.kernels import fused_adam, infusion

#: (wrapper, attribute) of every kernel launch counter a training step moves
COUNTERS: Tuple[Tuple[object, str], ...] = ((infusion.infused_noise, "launches"),
                                            (fused_adam.fused_adam, "launches"))


def _counts() -> List[int]:
    return [getattr(fn, attr) for fn, attr in COUNTERS]


def _set_counts(values: Sequence[int]) -> None:
    for (fn, attr), v in zip(COUNTERS, values):
        setattr(fn, attr, v)


def host_bytes(tables: Dict[str, torch.Tensor], steps: int) -> int:
    """The bytes that loading rows ``[0, steps)`` of ``tables`` copies from host memory."""
    return sum(t[:steps].nbytes for t in tables.values() if t.device.type == "cpu")


class StepGraph:
    """``fn(variant, rows) -> tensor`` (or a tuple of tensors) captured once per variant.

    ``rows`` maps each table's name to its row at the device counter.
    ``tables`` gives each table's row shape and dtype (a tensor whose first
    dimension is the step); ``state`` lists every tensor ``fn`` writes in
    place, snapshotted around the warm-up."""

    def __init__(self, fn: Callable[[Hashable, Dict[str, torch.Tensor]], Any],
                 tables: Dict[str, torch.Tensor], capacity: int, state: Sequence[torch.Tensor], device):
        device = torch.device(device)
        if device.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(f"step_graph captures CUDA graphs: no CUDA device for {device}")
        if capacity < 1:
            raise ValueError(f"capacity must be at least 1; got {capacity}")
        self.fn, self.capacity, self.device = fn, int(capacity), device
        self.state = list(state)
        self.tables = {name: torch.empty((self.capacity, *t.shape[1:]), dtype=t.dtype, device=device)
                       for name, t in tables.items()}
        self.counter = torch.zeros((), dtype=torch.int64, device=device)
        #: variant -> (graph, its output, the launch counters' deltas a replay adds)
        self.graphs: Dict[Hashable, Tuple[torch.cuda.CUDAGraph, Any, List[int]]] = {}
        #: device memory the captures reserved (their pools), bytes
        self.pool_bytes = 0

    def load(self, tables: Dict[str, torch.Tensor], steps: int) -> None:
        """Rows ``[0, steps)`` of every table for the next ``steps`` replays,
        and the counter to 0, enqueued on the current stream."""
        if not 1 <= steps <= self.capacity:
            raise ValueError(f"{steps} steps do not fit the graph's {self.capacity} rows")
        if set(tables) != set(self.tables):
            raise ValueError(f"tables {sorted(tables)} are not the graph's {sorted(self.tables)}")
        with profiling.span("graph.load"):
            for name, t in tables.items():
                if t.device.type == "cpu":
                    t = t.pin_memory()
                self.tables[name][:steps].copy_(t[:steps], non_blocking=True)
            self.counter.zero_()
        profiling.count("graph.h2d_bytes", host_bytes(tables, steps))
        profiling.count("graph.loaded_steps", steps)

    def replay(self, variant: Hashable) -> Any:
        """One step of ``variant`` (captured at its first replay). The output
        is the graph's static tensor (or tuple): the next replay overwrites it."""
        if variant not in self.graphs:
            self._capture(variant)
        graph, out, deltas = self.graphs[variant]
        with profiling.span("graph.replay"):
            graph.replay()
        _set_counts([c + d for c, d in zip(_counts(), deltas)])
        return out

    def _rows(self) -> Dict[str, torch.Tensor]:
        if self.capacity == 1:
            return {name: t[0] for name, t in self.tables.items()}
        at = self.counter.reshape(1)
        return {name: t.index_select(0, at)[0] for name, t in self.tables.items()}

    def _run(self, variant) -> Any:
        out = self.fn(variant, self._rows())
        self.counter.add_(1)
        return out

    def _capture(self, variant) -> None:
        t0 = time.perf_counter()
        with profiling.span("graph.capture"):
            self._capture_variant(variant)
        profiling.count("graph.capture_s", time.perf_counter() - t0)

    def _capture_variant(self, variant) -> None:
        AsyncSaver.wait_all()  # a worker's device copy would invalidate the capture
        before = _counts()
        live = [*self.state, self.counter]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            snapshot = [t.detach().clone() for t in live]
            self._run(variant)
            with torch.no_grad():
                for t, s in zip(live, snapshot):
                    t.copy_(s)
        torch.cuda.current_stream(self.device).wait_stream(side)
        del snapshot
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # as the capture's own entry does: the pool is what it reserves after
        reserved = torch.cuda.memory_reserved(self.device)
        try:
            with torch.cuda.graph(graph):
                start = _counts()
                out = self._run(variant)
                deltas = [b - a for a, b in zip(start, _counts())]
        except Exception as e:
            _set_counts(before)
            raise RuntimeError(f"step_graph: capturing variant {variant!r} failed: {e}") from e
        _set_counts(before)
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        self.graphs[variant] = (graph, out, deltas)
