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
where they are: :class:`StepGraphs`, the cache every trainer holds, keys
its graphs on their ``data_ptr``s, and a new state means a new capture.

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
from rnagan_tpu_torch.kernels import batchnorm, fused_adam, infusion

#: the step graphs a trainer keeps (a graph pins its state and its memory
#: pool), and twice as many ``prepare`` functions
MAX_GRAPHS = 4
#: bytes of the tables one chunk of host-fed steps fills (13 batches of
#: 128 x 19,198 float32 β-VAE rows, 9.8 MB each)
CHUNK_BYTES = 128 << 20
#: (wrapper, attribute) of every kernel launch counter a training step moves
COUNTERS: Tuple[Tuple[object, str], ...] = ((infusion.infused_noise, "launches"),
                                            (fused_adam.fused_adam, "launches"),
                                            (batchnorm.batch_norm_act, "launches"))


def _counts() -> List[int]:
    return [getattr(fn, attr) for fn, attr in COUNTERS]


def _set_counts(values: Sequence[int]) -> None:
    for (fn, attr), v in zip(COUNTERS, values):
        setattr(fn, attr, v)


def chunk_steps(steps: int, step_bytes: int) -> int:
    """Steps a chunk of tables holds: as many as ``CHUNK_BYTES`` takes, at least one."""
    return max(1, min(steps, CHUNK_BYTES // max(step_bytes, 1)))


def vector(metrics: Dict[str, torch.Tensor], keys: Sequence[str]) -> torch.Tensor:
    """A step's 0-dim metrics as one float32 vector, in ``keys`` order."""
    return torch.stack([metrics[k].detach().float().reshape(()) for k in keys])


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

    def run(self, tables: Dict[str, torch.Tensor], variants: Sequence[Hashable], out: torch.Tensor) -> None:
        """Rows ``[0, len(variants))`` of ``tables``, then one replay of each
        variant in turn, step i's output (a vector) copied into ``out[i]``."""
        self.load(tables, len(variants))
        for i, variant in enumerate(variants):
            out[i].copy_(self.replay(variant))

    def run_stacked(self, tables: Dict[str, torch.Tensor], steps: int) -> Tuple[torch.Tensor, ...]:
        """Rows ``[0, steps)`` of ``tables``, then ``steps`` replays of the
        variant None: each tensor of the output tuple stacked over the steps."""
        self.load(tables, steps)
        stacked = None
        for i in range(steps):
            res = self.replay(None)
            if stacked is None:
                stacked = tuple(torch.empty((steps, *r.shape), dtype=r.dtype, device=self.device) for r in res)
            for s, r in zip(stacked, res):
                s[i].copy_(r)
        return stacked

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


def _kept(cache: Dict[Hashable, Any], key: Hashable, build: Callable[[], Any], keep: int) -> Any:
    """``cache[key]``, built at its first use; the ``keep`` most recently used stay."""
    value = cache.pop(key, None)
    if value is None:
        value = build()
        while len(cache) >= keep:
            cache.pop(next(iter(cache)))
    cache[key] = value
    return value


class StepGraphs:
    """A trainer's captured steps: where they run (:meth:`captures`), its last
    ``MAX_GRAPHS`` graphs and ``2 * MAX_GRAPHS`` ``prepare`` functions.

    A graph's key: its kind (``"train"``/``"eval"``); the ids of the modules
    and optimizers its body closes over, with each one's ``cfg`` (a replaced
    ``cfg``, BigGAN's ``remat``, is another program); the live tensors'
    ``data_ptr``s (a deep copy of the state never invalidates a graph);
    ``id(prepare)``; the tables' row shapes and dtypes; the capacity; the
    cuDNN/TF32 flags. The body holds the state and ``prepare``, so the ids
    stay theirs while the graph lives."""

    def __init__(self, device, mesh):
        self.device, self.mesh = torch.device(device), mesh
        self._graphs: Dict[Hashable, StepGraph] = {}
        self._prepares: Dict[Hashable, Callable] = {}

    def captures(self) -> bool:
        """Whether the steps run as captured CUDA graphs: on a CUDA device with one rank."""
        return self.device.type == "cuda" and self.mesh.world == 1

    def graph(self, kind: str, owners: Sequence[object], live: Sequence[torch.Tensor],
              tables: Dict[str, torch.Tensor], prepare: Callable, capacity: int,
              body: Callable[[], Callable[[Hashable, Dict[str, torch.Tensor]], Any]]) -> StepGraph:
        """The graph of this key, built around ``body()`` at its first use.
        ``live`` lists what a train step writes in place (snapshotted around
        the warm-up); an eval graph writes nothing and snapshots nothing."""
        flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
                 torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        key = (kind, tuple((id(o), getattr(o, "cfg", None)) for o in owners), tuple(t.data_ptr() for t in live),
               id(prepare), tuple((k, tuple(t.shape[1:]), t.dtype) for k, t in sorted(tables.items())), capacity,
               flags)
        return _kept(self._graphs, key, lambda: StepGraph(body(), tables, capacity,
                                                          live if kind == "train" else [], self.device), MAX_GRAPHS)

    def prepared(self, key: Hashable, build: Callable[[], Callable]) -> Callable:
        """The ``prepare`` kept under ``key``, so its graphs are found again."""
        return _kept(self._prepares, key, build, 2 * MAX_GRAPHS)

    def graphs(self) -> List[Tuple[str, StepGraph]]:
        """The kept graphs with their kinds, the least recently used first."""
        return [(key[0], graph) for key, graph in self._graphs.items()]

    def pool_bytes(self) -> int:
        """Device memory the kept graphs' captures reserved, bytes."""
        return sum(graph.pool_bytes for graph in self._graphs.values())

    def release(self) -> None:
        """Drop every graph (its memory pool, state and data) and ``prepare``."""
        self._graphs.clear()
        self._prepares.clear()
