"""The ResNet trainers' steps as captured CUDA graphs: the port of the JAX
trainers' one donated, jitted program a step (``jax.jit(...,
donate_argnums=(0,))``: ``rnagan_tpu/train/ml_experiment.py:109-110``,
``ssl_trainer.py:157``, ``fusion_trainer.py:85-86``) and of
``fit_resident``'s scanned epoch (``ml_experiment.py:231-313``).

:class:`GraphSteps` is what the tile classifier, SimCLR and fusion trainers
share. On a CUDA device with one rank (:meth:`GraphSteps.captures`) a train
step replays a ``train/step_graph.py::StepGraph`` that reads, from one table
row a step, the step's inputs (a batch, or row indices into a set held on
the card), its given draws, its seeds (``core/rng.py::SeedStream.table`` of
the trainer's stream) and AdamW's bias corrections
(``optim/adam.py::Adam.plan``), which K3 reads as ``corr``; an eval step
replays a graph that has no state to snapshot. :meth:`GraphSteps.run_steps`
and :meth:`GraphSteps.run_eval` enqueue a chunk of steps with no host
synchronization; the state's step and AdamW's count advance by the chunk
once it is enqueued. Elsewhere (the CPU, a mesh of several ranks) the same
step function runs op by op, with host-int seeds and host-float
corrections, which draw and round alike.

A graph holds the live state and the data its ``prepare`` reads. Graphs are
keyed on the state tensors' ``data_ptr``s: a deep copy of the state (the
best one ``fit`` keeps) never invalidates them, and a state handed back in
means a new capture. :meth:`GraphSteps.release` drops them with their
memory pools. A failed capture raises; nothing falls back to eager steps.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from rnagan_tpu_torch.parallel import collectives
from rnagan_tpu_torch.train.step_graph import StepGraph

#: bytes of the batch tables one chunk of host-fed steps fills
CHUNK_BYTES = 128 << 20
#: the step graphs (and twice as many ``prepare`` functions) a trainer keeps
MAX_GRAPHS = 4

Prepare = Callable[[Dict[str, torch.Tensor]], Tuple[torch.Tensor, ...]]


def chunk_steps(steps: int, step_bytes: int) -> int:
    """Steps a chunk of tables holds: as many as ``CHUNK_BYTES`` takes, at least one."""
    return max(1, min(steps, CHUNK_BYTES // max(step_bytes, 1)))


class GraphSteps:
    """A trainer whose state is ``(step, model, opt)`` with ``opt`` an
    ``AdamW`` and whose steps run as captured graphs where it
    :meth:`captures`. The trainer sets ``mesh``, ``device`` and ``seeds``,
    calls :meth:`_init_graphs`, and defines ``_step(state, inputs, given,
    seeds, corr)`` (one train step in place, its metrics a dict of 0-dim
    tensors) and ``_eval(state, inputs)`` (a tuple of tensors), where
    ``inputs`` is what a ``prepare(rows)`` returns."""

    #: the trainer's seed stream and the seeds a step takes from it
    stream: str
    stages: int
    #: the table that holds a step's given draws, and the train metrics' names
    draw_table: str
    metric_keys: Tuple[str, ...]

    def _init_graphs(self) -> None:
        self._graphs: Dict[Any, StepGraph] = {}
        self._prepares: Dict[Any, Prepare] = {}

    def captures(self) -> bool:
        """Whether the steps run as captured CUDA graphs: on a CUDA device with one rank."""
        return self.device.type == "cuda" and self.mesh.world == 1

    def release(self) -> None:
        """Drop every graph (their memory pools, and the states and data they hold)."""
        self._graphs.clear()
        self._prepares.clear()

    def _step_seeds(self, step: int) -> List[int]:
        return [self.seeds.seed(self.stream, step, j) for j in range(self.stages)]

    @staticmethod
    def _state_tensors(state) -> List[torch.Tensor]:
        """Every tensor a train step reads and writes in place."""
        return [*state.model.parameters(), *state.model.buffers(), *state.opt.mu, *state.opt.nu]

    def _vector(self, metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.stack([metrics[k].detach().float().reshape(()) for k in self.metric_keys])

    def _prepared(self, key, build: Callable[[], Prepare]) -> Prepare:
        """The ``prepare`` kept under ``key`` (built at its first use), so the
        graphs built for it are found again."""
        fn = self._prepares.pop(key, None)
        if fn is None:
            fn = build()
            while len(self._prepares) >= 2 * MAX_GRAPHS:
                self._prepares.pop(next(iter(self._prepares)))
        self._prepares[key] = fn
        return fn

    def _graph(self, kind: str, state, tables: Dict[str, torch.Tensor], prepare: Prepare,
               capacity: int) -> StepGraph:
        """The state's ``kind`` (``"train"`` or ``"eval"``) graph for these
        tables, ``prepare``, capacity and cuDNN/TF32 flags (built at the first
        use; the last ``MAX_GRAPHS`` are kept)."""
        live = self._state_tensors(state)
        flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
                 torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        key = (kind, id(state.model), id(state.opt), tuple(t.data_ptr() for t in live), id(prepare),
               tuple((k, tuple(t.shape[1:]), t.dtype) for k, t in sorted(tables.items())), capacity, flags)
        graph = self._graphs.pop(key, None)
        if graph is None:
            # the body holds state and prepare: the ids in the key stay theirs while the graph lives
            graph = StepGraph(self._body(kind, state, prepare), tables, capacity, live if kind == "train" else [],
                              self.device)
            while len(self._graphs) >= MAX_GRAPHS:
                self._graphs.pop(next(iter(self._graphs)))
        self._graphs[key] = graph
        return graph

    def _body(self, kind: str, state, prepare: Prepare) -> Callable:
        """What a graph captures: ``body(variant, rows)`` runs one train step
        (seeds and AdamW's corrections from the rows) and returns its metrics
        vector, or one eval step and returns its tuple."""
        def train(_variant, rows):
            with collectives.active(self.mesh):
                return self._vector(self._step(state, prepare(rows), rows.get(self.draw_table), rows["seeds"],
                                               rows["opt"]))

        def evaluate(_variant, rows):
            with collectives.active(self.mesh):
                return self._eval(state, prepare(rows))
        return train if kind == "train" else evaluate

    def run_steps(self, state, tables: Dict[str, torch.Tensor], prepare: Prepare, steps: int,
                  capacity: Optional[int] = None) -> torch.Tensor:
        """``steps`` train steps, step i on row i of every table (what
        ``prepare`` builds the step's inputs from, and the given draws'
        table). Returns the steps' metrics, a (steps, len(metric_keys))
        device tensor. Where :meth:`captures`, replays of the state's graph
        for these tables, ``prepare`` and ``capacity`` rows (default
        ``steps``), enqueued with no synchronization; else op by op."""
        out = torch.empty((steps, len(self.metric_keys)), device=self.device)
        if not self.captures():
            for i in range(steps):
                rows = {k: t[i] for k, t in tables.items()}
                with collectives.active(self.mesh):
                    metrics = self._step(state, prepare(rows), rows.get(self.draw_table),
                                         self._step_seeds(state.step), None)
                out[i].copy_(self._vector(metrics))
                state.step += 1
            return out
        after = (state.step + steps, state.opt.count + steps)
        full = {**tables, "seeds": self.seeds.table(self.stream, state.step, steps, self.stages),
                "opt": state.opt.plan(steps)}
        graph = self._graph("train", state, full, prepare, capacity or steps)
        graph.load(full, steps)
        for i in range(steps):
            out[i].copy_(graph.replay(None))
        state.step, state.opt.count = after
        return out

    def run_eval(self, state, tables: Dict[str, torch.Tensor], prepare: Prepare, steps: int,
                 capacity: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
        """``steps`` eval steps, step i on row i of every table: each output
        of ``_eval`` stacked over the steps, on the device. Replays of the
        state's eval graph where :meth:`captures`, else op by op."""
        if not self.captures():
            outs = []
            for i in range(steps):
                with collectives.active(self.mesh):
                    outs.append(self._eval(state, prepare({k: t[i] for k, t in tables.items()})))
            return tuple(torch.stack(o) for o in zip(*outs))
        graph = self._graph("eval", state, tables, prepare, capacity or steps)
        graph.load(tables, steps)
        stacked = None
        for i in range(steps):
            res = graph.replay(None)
            if stacked is None:
                stacked = tuple(torch.empty((steps, *r.shape), dtype=r.dtype, device=self.device) for r in res)
            for s, r in zip(stacked, res):
                s[i].copy_(r)
        return stacked
