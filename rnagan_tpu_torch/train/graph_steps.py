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

A graph holds the live state and the data its ``prepare`` reads; the
trainer's ``step_graphs.release()`` drops them with their memory pools. A
failed capture raises; nothing falls back to eager steps.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from rnagan_tpu_torch.parallel import collectives
from rnagan_tpu_torch.train.step_graph import StepGraphs, vector

Prepare = Callable[[Dict[str, torch.Tensor]], Tuple[torch.Tensor, ...]]


class GraphSteps:
    """A trainer whose state is ``(step, model, opt)`` with ``opt`` an
    ``AdamW`` and whose steps run as captured graphs where it
    :meth:`captures`. The trainer sets ``mesh``, ``device``, ``seeds`` and
    ``step_graphs`` (a ``StepGraphs``), and defines ``_step(state, inputs, given,
    seeds, corr)`` (one train step in place, its metrics a dict of 0-dim
    tensors) and ``_eval(state, inputs)`` (a tuple of tensors), where
    ``inputs`` is what a ``prepare(rows)`` returns."""

    #: the trainer's seed stream and the seeds a step takes from it
    stream: str
    stages: int
    #: the table that holds a step's given draws, and the train metrics' names
    draw_table: str
    metric_keys: Tuple[str, ...]

    def captures(self) -> bool:
        """Whether the steps run as captured CUDA graphs (``StepGraphs.captures``)."""
        return self.step_graphs.captures()

    def _step_seeds(self, step: int) -> List[int]:
        return [self.seeds.seed(self.stream, step, j) for j in range(self.stages)]

    @staticmethod
    def _state_tensors(state) -> List[torch.Tensor]:
        """Every tensor a train step reads and writes in place."""
        return [*state.model.parameters(), *state.model.buffers(), *state.opt.mu, *state.opt.nu]

    def _body(self, kind: str, state, prepare: Prepare) -> Callable:
        """What a graph captures: ``body(variant, rows)`` runs one train step
        (seeds and AdamW's corrections from the rows: device tensors in a
        graph, host ints and None op by op) and returns its metrics vector,
        or one eval step and returns its tuple."""
        def train(_variant, rows):
            with collectives.active(self.mesh):
                return vector(self._step(state, prepare(rows), rows.get(self.draw_table), rows["seeds"],
                                         rows["opt"]), self.metric_keys)

        def evaluate(_variant, rows):
            with collectives.active(self.mesh):
                return self._eval(state, prepare(rows))
        return train if kind == "train" else evaluate

    def run_steps(self, state, tables: Dict[str, torch.Tensor], prepare: Prepare, steps: int,
                  capacity: Optional[int] = None) -> torch.Tensor:
        """``steps`` train steps, step i on row i of every table (what
        ``prepare`` builds the step's inputs from, and the given draws'
        table). Returns the steps' metrics, a (steps, len(metric_keys))
        device tensor. Where :meth:`captures`, replays of the ``step_graphs``
        graph of ``capacity`` rows (default ``steps``); else op by op."""
        out = torch.empty((steps, len(self.metric_keys)), device=self.device)
        if not self.captures():
            body = self._body("train", state, prepare)
            for i in range(steps):
                out[i].copy_(body(None, {**{k: t[i] for k, t in tables.items()},
                                         "seeds": self._step_seeds(state.step), "opt": None}))
                state.step += 1
            return out
        after = (state.step + steps, state.opt.count + steps)
        full = {**tables, "seeds": self.seeds.table(self.stream, state.step, steps, self.stages),
                "opt": state.opt.plan(steps)}
        graph = self.step_graphs.graph("train", (state.model, state.opt), self._state_tensors(state), full, prepare,
                                       capacity or steps, lambda: self._body("train", state, prepare))
        graph.run(full, [None] * steps, out)
        state.step, state.opt.count = after
        return out

    def run_eval(self, state, tables: Dict[str, torch.Tensor], prepare: Prepare, steps: int,
                 capacity: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
        """``steps`` eval steps, step i on row i of every table: each output
        of ``_eval`` stacked over the steps, on the device. Replays of the
        state's eval graph where :meth:`captures`, else op by op."""
        if not self.captures():
            body = self._body("eval", state, prepare)
            outs = [body(None, {k: t[i] for k, t in tables.items()}) for i in range(steps)]
            return tuple(torch.stack(o) for o in zip(*outs))
        graph = self.step_graphs.graph("eval", (state.model, state.opt), self._state_tensors(state), tables, prepare,
                                       capacity or steps, lambda: self._body("eval", state, prepare))
        return graph.run_stacked(tables, steps)
