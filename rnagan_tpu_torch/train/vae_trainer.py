"""β-VAE trainer (port of ``rnagan_tpu/train/vae_trainer.py``).

One :meth:`VAETrainer.train_step` is the JAX package's ``_train_step_impl``
on one card: the input dropout (mask given or drawn), encode,
reparametrize (``eps`` given or drawn), decode, the masked β-VAE loss,
``autograd`` and one optimizer step. With Adam (the default) that step is one
launch of the K3 kernel over all 26 parameter tensors; the rate comes from
the warmup+cosine schedule at the count before the step
(``optim/scheduled.py``). BatchNorm's running statistics update in place, with
flax's semantics (``models/betavae.py``).

The eval step runs the model in eval mode and still reparametrizes (the
reference does, ``betaVAE.py:109-115``). An epoch's losses are the mean of
its per-batch means, summed in float64 in step order as the JAX loop sums
them; they stay on the card until the epoch ends. A short final batch is
wrap-padded to a full one and masked (``data/batching.py``).

Random draws come from ``core/rng.py`` seeds, never from PyTorch's global
generator: a train step's seeds ``("train", step, stage)`` key its dropout
mask (stage 0, four uniforms a Philox counter), its ``eps`` (stage 1) and,
in :meth:`VAETrainer.run_resident`, its rows (stage 2); an eval batch's
``eps`` is keyed by ``("eval", epoch, batch)`` in ``fit`` and ``("test", 0,
batch)`` in ``evaluate``. They are the port's own streams, not
``jax.random``'s.

One program a step (the JAX trainer's ``jax.jit(_train_step_impl,
donate_argnums=(0,))`` and ``jax.jit(_eval_step_impl)``, ``:92-93``): on a
CUDA device with one rank (:meth:`VAETrainer.captures`), ``train_step`` and
``eval_step`` replay CUDA graphs (``train/step_graph.py``), and ``fit``,
``evaluate`` and ``run_resident`` enqueue their steps in chunks with no host
synchronization inside a chunk. What changes from step to step is read from
device tables: the batch (or its row indices into a matrix on the card), the
mask, given draws, the step's seeds and the optimizer's row ``(c1, c2, lr,
r)`` (``ScheduledOptimizer.plan``; K3 reads ``(c1, c2, lr)`` there, RAdam's
rectified-or-not is a variant of the graph). The graph writes where it
reads: K3 the parameters and moments, BatchNorm ``copy_`` into the module's
buffers. :meth:`VAETrainer.train_step_eager` and
:meth:`VAETrainer.eval_step_eager` are the plain versions, with host-int
seeds and host-float rates: they run on the CPU and under a mesh of several
ranks, and draw the same bits. A failed capture raises; nothing falls back.

Under a mesh (``VAEConfig.mesh``, ``parallel/mesh.py``) the step runs on a
(data x model) grid, as the JAX trainer's does (``:87-119``):

* data axis: ``train_step`` takes this rank's rows of the global batch
  (``fit`` pads the global batch to a multiple of the data-axis size and
  slices it); the dropout mask and ``eps`` are drawn for the global batch and
  sliced; the masked losses are shares over the global count and the
  gradients are summed over the data group;
* model axis: ``shard_dense_params`` splits every Linear (and BatchNorm1d)
  whose width divides the model-axis size column-wise
  (``models/betavae.py``); the optimizer (K3 for Adam, or SGD/RAdam) steps
  this rank's shards; checkpoints gather the shards, so a grid's ``.pt`` is
  the file a one-card run writes. ``state_from_jax``/``state_to_jax`` need a
  model axis of 1.

The losses and history are the global ones on every rank; rank 0 writes.

Unlike the JAX step, which is pure, ``train_step`` updates the state in place
and returns it; ``fit`` therefore keeps a deep copy of the best state, as the
JAX loop does for its donated buffers (``:235-237``), and the live state
keeps its storage (and its graphs). ``fit`` writes the best and last models
as reference-layout ``.pt`` state_dicts with the scaler beside them
(``core/checkpoint.py``): the best one is what ``GANConfig(vae_checkpoint=...)``
takes.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from rnagan_tpu_torch.core import profiling, rng
from rnagan_tpu_torch.core.checkpoint import BestKeeper, on_writer
from rnagan_tpu_torch.core.config import VAEConfig
from rnagan_tpu_torch.core.metrics import MetricsLogger, epoch_means
from rnagan_tpu_torch.core.rng import SeedStream
from rnagan_tpu_torch.data.batching import batch_indices
from rnagan_tpu_torch.data.rna import Scaler
from rnagan_tpu_torch.losses.vae import masked_beta_vae_loss
from rnagan_tpu_torch.models.betavae import BetaVAE, draw_eps, draw_keep
from rnagan_tpu_torch.optim.scheduled import ScheduledOptimizer, make_optimizer
from rnagan_tpu_torch.parallel import collectives
from rnagan_tpu_torch.parallel.mesh import (Mesh, full_state_dict, local_rows, make_mesh, module_tensors,
                                            replicated, shard_dense_params)
from rnagan_tpu_torch.train.step_graph import StepGraphs, chunk_steps, vector

Losses = Dict[str, torch.Tensor]
Prepare = Callable[[Dict[str, Any]], Tuple[torch.Tensor, torch.Tensor]]

#: a step's losses, in the order of the rows :meth:`VAETrainer.run_steps` returns
LOSS_KEYS = ("total_loss", "reconstruction_loss", "kl_loss")
#: a train step's seeds: the dropout mask, eps, and the rows of a resident-matrix step
_STAGES = {"keep": 0, "eps": 1, "rows": 2}
#: a step's given draws, as ``draws`` keys and table names
DRAW_KEYS = ("keep", "eps")


def given_rows(rows: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``(batch, mask)`` of a step whose tables hold them
    (:meth:`VAETrainer.run_steps`' ``prepare`` for given batches)."""
    return rows["batch"], rows["mask"]


def _draws_of(rows: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: rows[k] for k in DRAW_KEYS if k in rows}


def _draw_tensors(draws: Optional[Dict[str, Any]]) -> Dict[str, torch.Tensor]:
    """Given draws as tensors: ``keep`` bool, ``eps`` float32."""
    return {k: torch.as_tensor(v, dtype=torch.bool if k == "keep" else torch.float32)
            for k, v in (draws or {}).items()}


@dataclass
class VAETrainState:
    """``model`` holds the parameters and the BatchNorm running statistics
    (``batch_stats``), ``opt`` the optimizer state."""

    step: int
    model: BetaVAE
    opt: ScheduledOptimizer


class VAETrainer:
    """β-VAE training on one card, or over the (data x model) ``mesh``
    (default ``make_mesh(cfg.mesh, device)``: one card outside a process
    group). ``device="cuda"``, the default, raises without CUDA; the tests
    pass ``"cpu"``."""

    def __init__(self, cfg: VAEConfig, *, device="cuda", logger: Optional[MetricsLogger] = None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh(cfg.mesh, device)
        self.device = self.mesh.device
        self.logger = logger or MetricsLogger()
        self.seeds = SeedStream(cfg.seed)
        self.step_graphs = StepGraphs(self.device, self.mesh)

    # ------------------------------------------------------------------ state
    def init_state(self) -> VAETrainState:
        """Every rank draws the whole model from the run seed, keeps its
        shards (model axis) and takes the first data rank's numbers."""
        model = BetaVAE(self.cfg.model, seed=self.seeds.seed("init"), device=self.device)
        if self.mesh.model > 1:
            shard_dense_params(model, self.mesh)
        replicated(module_tensors(model), self.mesh)
        return VAETrainState(step=0, model=model, opt=make_optimizer(self.cfg, model.parameters()))

    def full_state_dict(self, state: VAETrainState) -> Dict[str, torch.Tensor]:
        """The model's state_dict with its shards gathered (every rank calls it):
        what a one-card run of the same configuration holds."""
        return full_state_dict(state.model, self.mesh)

    def state_from_jax(self, tree) -> VAETrainState:
        """A JAX ``VAETrainState`` in flax's state-dict form
        (``serialization.to_state_dict``), on this trainer's device (a model
        axis of 1)."""
        from rnagan_tpu_torch import convert

        if self.mesh.model > 1:
            raise ValueError("state_from_jax needs a model axis of 1")

        moved = convert.vae_train_state_from_jax(self.cfg, tree)
        state = self.init_state()
        state.model.load_state_dict(moved["model"])
        state.opt.load_state_dict(moved["optimizer"])
        state.step = moved["step"]
        return state

    def state_to_jax(self, state: VAETrainState) -> Dict[str, Any]:
        """The inverse of :meth:`state_from_jax` (numpy leaves; a model axis of 1)."""
        from rnagan_tpu_torch import convert

        if self.mesh.model > 1:
            raise ValueError("state_to_jax needs a model axis of 1")

        return convert.vae_train_state_to_jax(self.cfg, state.step, state.model.state_dict(),
                                              state.opt.state_dict())

    # ------------------------------------------------------------------ steps
    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype).to(self.device)

    def captures(self) -> bool:
        """Whether the steps run as captured CUDA graphs (``StepGraphs.captures``)."""
        return self.step_graphs.captures()

    def _step_seeds(self, step: int) -> List[int]:
        return [self.seeds.seed("train", step, i) for i in range(len(_STAGES))]

    def _draws(self, draws: Dict[str, torch.Tensor], keep_seed, eps_seed, n: int, rows: slice):
        """This rank's dropout mask (None without dropout, or with ``keep_seed``
        None: eval) and ``eps``: given for the global batch of ``n`` rows, or
        drawn for it from the seeds; both sliced to ``rows``."""
        m = self.cfg.model
        keep = draws.get("keep")
        if keep is None and keep_seed is not None and m.dropout_rate != 0.0:
            keep = draw_keep(keep_seed, (n, m.rna_features), m.dropout_rate, self.device)
        eps = draws.get("eps")
        if eps is None:
            eps = draw_eps(eps_seed, (n, m.z_dim), self.device)
        keep = None if keep is None else keep.to(self.device, torch.bool)[rows]
        return keep, eps.to(self.device, torch.float32)[rows]

    def _step(self, state: VAETrainState, x, m, draws, seeds, row, variant) -> Losses:
        """The step's device work: ``x``/``m`` this rank's rows, ``draws`` the
        global batch's given ``keep``/``eps``, ``seeds`` the step's (host ints
        or an int64 device row), ``row``/``variant`` the optimizer's (None:
        computed on the host). The state is updated in place; ``state.step``
        does not advance. Each stage begins with its device mark
        (``core/profiling.py``); ``vae_stats`` holds the losses' reduction."""
        mesh, dev = self.mesh, self.device
        n = len(x) * mesh.data
        profiling.mark("vae_mask", dev)
        keep, eps = self._draws(draws, seeds[_STAGES["keep"]], seeds[_STAGES["eps"]], n, local_rows(n, mesh))
        profiling.mark("vae_forward", dev)
        model = state.model.train()
        out, z_mean, z_logvar = model(x, keep=keep, eps=eps)
        losses = masked_beta_vae_loss(x, out, z_mean, z_logvar, m, self.cfg.model.beta, True, mesh.data_group)
        profiling.mark("vae_backward", dev)
        params = list(model.parameters())
        grads = collectives.all_reduce_grads(torch.autograd.grad(losses["total_loss"], params), mesh.data_group)
        profiling.mark("vae_adam", dev)
        state.opt.step(params, grads, row=row, variant=variant)
        profiling.mark("vae_stats", dev)
        losses = collectives.reduce_metrics({k: v.detach() for k, v in losses.items()}, mesh.data_group)
        profiling.mark("end", dev)
        return losses

    @torch.no_grad()
    def _eval(self, state: VAETrainState, x, m, draws, seed) -> Tuple[Losses, torch.Tensor]:
        mesh = self.mesh
        n = len(x) * mesh.data
        _, eps = self._draws(draws, None, seed, n, local_rows(n, mesh))
        out, z_mean, z_logvar = state.model.eval()(x, eps=eps)
        losses = masked_beta_vae_loss(x, out, z_mean, z_logvar, m, self.cfg.model.beta, False, mesh.data_group)
        return collectives.reduce_metrics(losses, mesh.data_group), out

    def train_step(self, state: VAETrainState, batch, mask,
                   draws: Optional[Dict[str, Any]] = None) -> Tuple[VAETrainState, Losses]:
        """One step on ``batch`` (N, F) normalized expression with ``mask``
        (N,) marking the valid rows: under a mesh, this rank's rows of the
        global batch. ``draws`` optionally gives the global batch's ``keep``
        (the dropout mask, bool) and ``eps`` (standard normals, (rows, z)).
        Returns ``(state, losses)``, the state updated in place; the losses
        (``total_loss``, ``reconstruction_loss``, ``kl_loss``, of the global
        batch) are 0-dim tensors. Where :meth:`captures`, a replay of the
        step's graph (:meth:`run_steps`); else :meth:`train_step_eager`."""
        if not self.captures():
            return self.train_step_eager(state, batch, mask, draws)
        tables = {"batch": torch.as_tensor(batch, dtype=torch.float32), "mask": torch.as_tensor(mask, dtype=torch.float32),
                  **_draw_tensors(draws)}
        vec = self.run_steps(state, {k: t[None] for k, t in tables.items()}, given_rows, 1)[0]
        return state, dict(zip(LOSS_KEYS, vec.unbind(0)))

    def train_step_eager(self, state: VAETrainState, batch, mask,
                         draws: Optional[Dict[str, Any]] = None) -> Tuple[VAETrainState, Losses]:
        """:meth:`train_step` op by op from the host (host-int seeds, the rate
        a host float): its plain version, and the step of the CPU and of a
        mesh of several ranks."""
        with collectives.active(self.mesh):
            losses = self._step(state, self._tensor(batch), self._tensor(mask), _draw_tensors(draws),
                                self._step_seeds(state.step), None, None)
        state.step += 1
        return state, losses

    def eval_step(self, state: VAETrainState, batch, mask, seed=None, eps=None) -> Tuple[Losses, torch.Tensor]:
        """Eval-mode losses of the global batch (the validation total is the
        reconstruction) and this rank's reconstructions; ``eps`` (the global
        batch's) given or drawn from ``seed`` (an int or a one-element int64
        tensor). Where :meth:`captures`, a replay of the eval graph."""
        if seed is None and eps is None:
            raise ValueError("eval_step draws eps from a seed, or takes it given")
        if not self.captures():
            return self.eval_step_eager(state, batch, mask, seed, eps)
        tables = {"batch": torch.as_tensor(batch, dtype=torch.float32)[None],
                  "mask": torch.as_tensor(mask, dtype=torch.float32)[None],
                  "seeds": torch.as_tensor(0 if seed is None else seed, dtype=torch.int64).reshape(1, 1)}
        if eps is not None:
            tables["eps"] = torch.as_tensor(eps, dtype=torch.float32)[None]
        losses, outs = self.run_eval(state, tables, given_rows, 1)
        return dict(zip(LOSS_KEYS, losses[0].unbind(0))), outs[0]

    def eval_step_eager(self, state: VAETrainState, batch, mask, seed=None,
                        eps=None) -> Tuple[Losses, torch.Tensor]:
        """:meth:`eval_step` op by op from the host."""
        with collectives.active(self.mesh):
            return self._eval(state, self._tensor(batch), self._tensor(mask),
                              _draw_tensors(None if eps is None else {"eps": eps}), seed)

    # ------------------------------------------------------- captured steps
    def _state_tensors(self, state: VAETrainState) -> List[torch.Tensor]:
        """Every tensor a train step reads and writes in place."""
        return [*state.model.parameters(), *state.model.buffers(), *state.opt.rule.mu, *state.opt.rule.nu]

    def _body(self, kind: str, state: VAETrainState, prepare: Prepare) -> Callable:
        """What a graph captures: ``body(variant, rows)`` runs one train step
        (the optimizer's row and seeds as device tensors, ``variant`` RAdam's;
        op by op host-int seeds and None) and returns its losses vector, or
        one eval step and returns ``(losses vector, reconstructions)``."""
        def train(variant, rows):
            profiling.mark("vae_rows", self.device)
            x, m = prepare(rows)
            with collectives.active(self.mesh):
                losses = self._step(state, x, m, _draws_of(rows), rows["seeds"], rows["opt"], variant)
            return vector(losses, LOSS_KEYS)

        def evaluate(_variant, rows):
            x, m = prepare(rows)
            with collectives.active(self.mesh):
                losses, out = self._eval(state, x, m, _draws_of(rows), rows["seeds"][0])
            return vector(losses, LOSS_KEYS), out
        return train if kind == "train" else evaluate

    def _plan(self, state: VAETrainState, steps: int):
        """The host's part of ``steps`` steps from ``state``: the seeds table
        (steps, 3), the optimizer's rows (steps, 4) and variants, and (step,
        count, rule count) after them."""
        opt = state.opt
        rows, variants = opt.plan(steps)
        seeds = self.seeds.table("train", state.step, steps, len(_STAGES))
        rule_steps = 0 if opt.name == "sgd" else steps  # optax.sgd keeps no count
        return seeds, rows, variants, (state.step + steps, opt.count + steps, opt.rule.count + rule_steps)

    def run_steps(self, state: VAETrainState, tables: Dict[str, torch.Tensor], prepare: Prepare, steps: int,
                  capacity: Optional[int] = None) -> torch.Tensor:
        """``steps`` train steps; step i takes row i of every table (the
        batch, or what ``prepare`` builds it from; ``keep``/``eps`` rows are
        given draws). ``prepare(rows)`` returns the step's ``(batch, mask)``,
        this rank's rows, with device ops only; ``rows`` also holds the
        step's seeds (``rows["seeds"][2]`` keys a step's own row draw).
        Returns every step's losses, a (steps, 3) device tensor
        (``LOSS_KEYS`` order).

        Where :meth:`captures`, the steps replay the ``step_graphs`` graph of
        ``capacity`` rows (default ``steps``), a variant per RAdam choice: the
        host fills the tables (the seeds and the optimizer's rows too) once
        and enqueues the replays with no synchronization. Otherwise each step
        runs op by op. A step's ``prepare`` is its device stage ``vae_rows``."""
        out = torch.empty((steps, len(LOSS_KEYS)), device=self.device)
        if not self.captures():
            body = self._body("train", state, prepare)
            for i in range(steps):
                out[i].copy_(body(None, {**{k: t[i] for k, t in tables.items()},
                                         "seeds": self._step_seeds(state.step), "opt": None}))
                state.step += 1
            return out
        with profiling.span("vae.plan"):
            seeds, opt_rows, variants, after = self._plan(state, steps)
        full = {**tables, "seeds": seeds, "opt": opt_rows}
        graph = self.step_graphs.graph("train", (state.model, state.opt), self._state_tensors(state), full, prepare,
                                       capacity or steps, lambda: self._body("train", state, prepare))
        graph.run(full, variants, out)
        state.step, state.opt.count, state.opt.rule.count = after
        return out

    def run_eval(self, state: VAETrainState, tables: Dict[str, torch.Tensor], prepare: Prepare, steps: int,
                 capacity: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``steps`` eval steps, step i on row i of every table; ``tables``
        holds ``"seeds"``, an int64 (steps, 1) of each step's eps seed.
        Returns the losses (steps, 3) and this rank's reconstructions (steps,
        rows, F) on the device: a captured graph's replays where
        :meth:`captures`, else op by op."""
        if not self.captures():
            body = self._body("eval", state, prepare)
            outs = [body(None, {**{k: t[i] for k, t in tables.items()}, "seeds": [int(tables["seeds"][i][0])]})
                    for i in range(steps)]
            return tuple(torch.stack(o) for o in zip(*outs))
        graph = self.step_graphs.graph("eval", (state.model, state.opt), self._state_tensors(state), tables, prepare,
                                       capacity or steps, lambda: self._body("eval", state, prepare))
        return graph.run_stacked(tables, steps)

    # -------------------------------------------------------- data on the card
    def _prepare(self, kind: str, data: Optional[torch.Tensor], rows: int, given: bool = False) -> Prepare:
        """A ``prepare`` (one per matrix and kind, kept so the graphs built
        for it are found again): ``"host"`` takes this rank's rows of the
        ``batch`` and ``mask`` a table holds (``data`` None); over ``data``, a
        matrix on this trainer's device, ``"idx"`` gathers the rows a table
        gives (this rank's, with ``mask``), ``"draw"`` gathers ``rows`` rows
        drawn with replacement from the step's ``rows`` seed (or given as
        ``idx`` rows), the mask all ones, and ``"whole"`` returns the matrix
        itself."""
        key = (kind, rows, given) if data is None else (kind, data.data_ptr(), tuple(data.shape), data.dtype,
                                                        rows, given)

        def build() -> Prepare:
            mesh, dev = self.mesh, self.device
            ones = torch.ones(rows, device=dev)

            def fn(step_rows):
                if kind == "host":
                    local = local_rows(rows, mesh)
                    return step_rows["batch"].to(dev)[local], step_rows["mask"].to(dev)[local]
                if kind == "whole":
                    return data, ones
                if kind == "idx":
                    local = local_rows(rows, mesh)
                    return data.index_select(0, step_rows["idx"].to(dev)[local]), step_rows["mask"].to(dev)[local]
                idx = step_rows["idx"].to(dev) if given else rng.randint(step_rows["seeds"][_STAGES["rows"]],
                                                                         len(data), (rows,), dev)
                return data.index_select(0, idx), ones
            return fn
        return self.step_graphs.prepared(key, build)

    def run_resident(self, state: VAETrainState, data: torch.Tensor, steps: int, batch: int, *,
                     rows=None, draws: Optional[Dict[str, Any]] = None,
                     capacity: Optional[int] = None) -> torch.Tensor:
        """``steps`` train steps on ``data``, a (rows, F) matrix on this
        trainer's device: each step takes ``batch`` rows drawn uniformly with
        replacement from its own seed (or given: ``rows``, int (steps,
        batch)), the mask all ones; ``draws`` optionally gives every step's
        ``keep`` (steps, batch, F) and ``eps`` (steps, batch, z). Returns the
        steps' mean total loss, a device scalar. The JAX tools' scanned
        pre-train body (``tools/quality_run.py:106-110``), run in chunks of
        ``capacity`` steps (default all of them) where :meth:`captures`."""
        if self.mesh.world > 1:
            raise ValueError("run_resident trains on one rank")
        if data.device != self.device:
            raise ValueError(f"run_resident's matrix must be on {self.device}, not {data.device}")
        tables = _draw_tensors(draws)
        if rows is not None:
            tables["idx"] = torch.as_tensor(rows, dtype=torch.int64).reshape(steps, batch)
        prepare = self._prepare("draw", data, batch, given=rows is not None)
        cap = min(capacity or steps, steps)
        losses = [self.run_steps(state, {k: t[s:s + cap] for k, t in tables.items()}, prepare,
                                 min(cap, steps - s), capacity=cap)
                  for s in range(0, steps, cap)]
        return torch.cat(losses)[:, 0].mean()

    def val_recons(self, state: VAETrainState, data: torch.Tensor, seed) -> torch.Tensor:
        """``mean((out - data)^2)`` over the whole of ``data`` (a matrix on
        this trainer's device) of the eval-mode forward, reparametrized with
        ``eps`` from ``seed``: the JAX quality tool's validation score
        (``tools/quality_run.py:113-116``), a device scalar."""
        tables = {"seeds": torch.tensor([[int(seed)]], dtype=torch.int64)}
        _, outs = self.run_eval(state, tables, self._prepare("whole", data, len(data)), 1)
        return torch.mean(torch.square(outs[0].float() - data))

    # ------------------------------------------------------------------ loops
    def _pass(self, state: VAETrainState, data, *, train: bool, name: str, epoch: int = 0):
        """One pass over ``data`` (host array or tensor) in the config's
        batches (shuffled when ``train``, the last wrap-padded, padded to the
        data-axis size), in chunks of at most ``CHUNK_BYTES`` of tables:
        train steps, or eval steps with eps seeds ``(name, epoch, batch)``.
        Returns the per-step losses (steps, 3), and for eval this rank's
        reconstructions (steps, rows, F) and the global masks."""
        batches = list(batch_indices(len(data), self.cfg.batch_size, shuffle=train, seed=self.cfg.seed,
                                     epoch=epoch, pad_to=self.mesh.data))
        if not batches:
            return torch.zeros((0, len(LOSS_KEYS))), None, np.zeros((0, 0), np.float32)
        idx = np.stack([i for i, _ in batches])
        masks = np.stack([m for _, m in batches])
        steps, rows = idx.shape
        resident = isinstance(data, torch.Tensor) and data.device == self.device
        if resident:
            prepare = self._prepare("idx", data, rows)
            row_bytes = rows * 12
        else:
            host = torch.as_tensor(data.cpu() if isinstance(data, torch.Tensor) else np.asarray(data),
                                   dtype=torch.float32)
            prepare = self._prepare("host", None, rows)
            row_bytes = rows * (host.shape[1] * 4 + 4)
        cap = chunk_steps(steps, row_bytes)
        losses, outs = [], []
        for s in range(0, steps, cap):
            k = min(cap, steps - s)
            tables = {"mask": torch.as_tensor(masks[s:s + k])}
            if resident:
                tables["idx"] = torch.as_tensor(idx[s:s + k], dtype=torch.int64)
            else:
                tables["batch"] = host[torch.as_tensor(idx[s:s + k])]
            if train:
                losses.append(self.run_steps(state, tables, prepare, k, capacity=cap))
                continue
            tables["seeds"] = torch.tensor([[self.seeds.seed(name, epoch, c)] for c in range(s, s + k)],
                                           dtype=torch.int64)
            lo, out = self.run_eval(state, tables, prepare, k, capacity=cap)
            losses.append(lo)
            outs.append(out)
        return torch.cat(losses), (torch.cat(outs) if outs else None), masks

    def _run_epoch(self, state: VAETrainState, data, *, train: bool, epoch: int):
        """An epoch of train steps, or the validation pass: ``(state, means)``."""
        losses = self._pass(state, data, train=train, name="train" if train else "eval", epoch=epoch)[0]
        return state, epoch_means(losses, LOSS_KEYS)[0]

    def fit(self, train_data: np.ndarray, val_data: np.ndarray, *, save_dir: Optional[str] = None,
            scaler: Optional[Scaler] = None,
            state: Optional[VAETrainState] = None) -> Tuple[VAETrainState, Dict[str, Any]]:
        """Train/val epoch loop with best-on-val checkpointing (reference
        ``betaVAE.py:165-284``). ``train_data`` and ``val_data`` are (rows,
        genes) float32 arrays, or tensors (on the card, the tables hold row
        indices into them). Returns the best state (a copy) and
        ``{"best_epoch", "best_loss", "history"}``."""
        state = state if state is not None else self.init_state()
        mesh = self.mesh
        keeper = BestKeeper(save_dir) if save_dir and mesh.writer else None
        history: Dict[str, List[Dict[str, float]]] = {"train": [], "val": []}
        best_loss, best_epoch, best_state = float("inf"), -1, None
        for epoch in range(self.cfg.num_epochs):
            state, train_losses = self._run_epoch(state, train_data, train=True, epoch=epoch)
            _, val_losses = self._run_epoch(state, val_data, train=False, epoch=epoch)
            val_losses = collectives.broadcast_scalars(val_losses, mesh)  # one decision on every rank
            history["train"].append(train_losses)
            history["val"].append(val_losses)
            self.logger.scalars("train", train_losses, epoch)
            self.logger.scalars("val", val_losses, epoch)
            self.logger.console(
                f"epoch {epoch}: train total {train_losses['total_loss']:.4f} "
                f"recons {train_losses['reconstruction_loss']:.4f} kl {train_losses['kl_loss']:.4f} | "
                f"val total {val_losses['total_loss']:.4f}")
            if val_losses["total_loss"] < best_loss:
                best_loss, best_epoch = val_losses["total_loss"], epoch
                best_state = copy.deepcopy(state)  # the next epoch updates `state` in place
                if save_dir:
                    full = self.full_state_dict(state)
                    on_writer(mesh, lambda: keeper.update(epoch, best_loss, full, scaler, {"config": "betavae"}))
        if save_dir:
            full = self.full_state_dict(state)
            on_writer(mesh, lambda: keeper.save_last(full, scaler))
        if best_state is None:
            best_state = state  # every validation loss NaN: the final state
        results = {"best_epoch": best_epoch, "best_loss": {"total_loss": best_loss}, "history": history}
        return best_state, results

    def evaluate(self, data: np.ndarray, state: VAETrainState) -> Tuple[Dict[str, float], np.ndarray]:
        """Test-set mean losses and the valid rows' reconstructions (reference
        ``betaVAE.py:286-331``), the whole set's on every rank."""
        losses, outs, masks = self._pass(state, data, train=False, name="test")
        if outs is None:
            return {}, np.zeros((0,))
        outs = collectives.gather(outs, self.mesh.data_group, dim=1)
        return epoch_means(losses, LOSS_KEYS)[0], outs.cpu().numpy()[masks > 0]
