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
reference does, ``betaVAE.py:109-115``), with a generator of its own per
batch. An epoch's losses are the mean of its per-batch means, as in the JAX
loop; they stay on the card until the epoch ends. A short final batch is
wrap-padded to a full one and masked (``data/batching.py``).

Random draws come from ``core/rng.py`` seeds (``"train"`` per step,
``"eval"`` per epoch and batch, ``"test"`` per batch), never from PyTorch's
global generator; they are the port's own streams, not ``jax.random``'s.

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
JAX loop does for its donated buffers (``:235-237``). ``fit`` writes the best
and last models as reference-layout ``.pt`` state_dicts with the scaler
beside them (``core/checkpoint.py``): the best one is what
``GANConfig(vae_checkpoint=...)`` takes.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from rnagan_tpu_torch.core.checkpoint import BestKeeper, on_writer
from rnagan_tpu_torch.core.config import VAEConfig
from rnagan_tpu_torch.core.metrics import MetricsLogger, epoch_means
from rnagan_tpu_torch.core.profiling import StepTimer
from rnagan_tpu_torch.core.rng import SeedStream
from rnagan_tpu_torch.data.rna import Scaler, batch_iterator
from rnagan_tpu_torch.losses.vae import masked_beta_vae_loss
from rnagan_tpu_torch.models.betavae import BetaVAE
from rnagan_tpu_torch.optim.scheduled import ScheduledOptimizer, make_optimizer
from rnagan_tpu_torch.parallel import collectives
from rnagan_tpu_torch.parallel.mesh import (Mesh, full_state_dict, local_rows, make_mesh, module_tensors,
                                            replicated, shard_batch, shard_dense_params)

Losses = Dict[str, torch.Tensor]


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

    def _global_draws(self, n: int, generator: torch.Generator, train: bool) -> Dict[str, torch.Tensor]:
        """The dropout mask (train) and ``eps`` of the global batch of ``n``
        rows, drawn as the model draws them from ``generator`` (mask first)."""
        m = self.cfg.model
        draws = {}
        if train and m.dropout_rate != 0.0:
            draws["keep"] = torch.rand((n, m.rna_features), generator=generator,
                                       device=self.device) < 1.0 - m.dropout_rate
        draws["eps"] = torch.randn((n, m.z_dim), generator=generator, device=self.device)
        return draws

    def _local(self, value, rows: slice, dtype=torch.float32) -> Optional[torch.Tensor]:
        return None if value is None else self._tensor(value, dtype)[rows]

    def train_step(self, state: VAETrainState, batch, mask,
                   draws: Optional[Dict[str, Any]] = None) -> Tuple[VAETrainState, Losses]:
        """One step on ``batch`` (N, F) normalized expression with ``mask``
        (N,) marking the valid rows: under a mesh, this rank's rows of the
        global batch. ``draws`` optionally gives the global batch's ``keep``
        (the dropout mask, bool) and ``eps`` (standard normals, (rows, z)).
        Returns ``(state, losses)``, the state updated in place; the losses
        (``total_loss``, ``reconstruction_loss``, ``kl_loss``, of the global
        batch) are 0-dim tensors."""
        with collectives.active(self.mesh):
            return self._train_step(state, batch, mask, draws or {})

    def _train_step(self, state, batch, mask, draws):
        mesh = self.mesh
        x, m = self._tensor(batch), self._tensor(mask)
        rows = local_rows(len(x) * mesh.data, mesh)
        gen = None
        if "keep" not in draws or "eps" not in draws:
            gen = self.seeds.generator("train", state.step, device=self.device)
            if mesh.data > 1:  # the global batch's draws, sliced below
                draws = {**self._global_draws(len(x) * mesh.data, gen, True), **draws}
        keep, eps = self._local(draws.get("keep"), rows, torch.bool), self._local(draws.get("eps"), rows)
        model = state.model.train()
        out, z_mean, z_logvar = model(x, gen, keep=keep, eps=eps)
        losses = masked_beta_vae_loss(x, out, z_mean, z_logvar, m, self.cfg.model.beta, True,
                                      mesh.data_group)
        params = list(model.parameters())
        grads = torch.autograd.grad(losses["total_loss"], params)
        state.opt.step(params, collectives.all_reduce_grads(grads, mesh.data_group))
        state.step += 1
        return state, collectives.reduce_metrics({k: v.detach() for k, v in losses.items()},
                                                 mesh.data_group)

    @torch.no_grad()
    def eval_step(self, state: VAETrainState, batch, mask, generator: Optional[torch.Generator] = None,
                  eps=None) -> Tuple[Losses, torch.Tensor]:
        """Eval-mode losses of the global batch (the validation total is the
        reconstruction) and this rank's reconstructions; ``eps`` (the global
        batch's) given or drawn from ``generator``."""
        mesh = self.mesh
        x, m = self._tensor(batch), self._tensor(mask)
        if eps is None and mesh.data > 1:
            eps = self._global_draws(len(x) * mesh.data, generator, False)["eps"]
        if eps is not None:
            eps = self._local(eps, local_rows(len(x) * mesh.data, mesh))
        model = state.model.eval()
        with collectives.active(mesh):
            out, z_mean, z_logvar = model(x, generator, eps=eps)
        losses = masked_beta_vae_loss(x, out, z_mean, z_logvar, m, self.cfg.model.beta, False,
                                      mesh.data_group)
        return collectives.reduce_metrics(losses, mesh.data_group), out

    # ------------------------------------------------------------------ loops
    def _batches(self, data, **kw):
        """This rank's rows of each global batch, padded to the data-axis size."""
        for batch, mask in batch_iterator(data, self.cfg.batch_size, pad_to=self.mesh.data, **kw):
            yield shard_batch(batch, self.mesh), shard_batch(mask, self.mesh), mask

    def _run_epoch(self, state: VAETrainState, data: np.ndarray, *, train: bool, epoch: int):
        per_batch: List[Losses] = []
        for count, (batch, mask, _) in enumerate(self._batches(data, shuffle=train, seed=self.cfg.seed,
                                                               epoch=epoch)):
            if train:
                state, losses = self.train_step(state, batch, mask)
            else:
                gen = self.seeds.generator("eval", epoch, count, device=self.device)
                losses, _ = self.eval_step(state, batch, mask, gen)
            per_batch.append(losses)
        return state, epoch_means(per_batch)

    def fit(self, train_data: np.ndarray, val_data: np.ndarray, *, save_dir: Optional[str] = None,
            scaler: Optional[Scaler] = None,
            state: Optional[VAETrainState] = None) -> Tuple[VAETrainState, Dict[str, Any]]:
        """Train/val epoch loop with best-on-val checkpointing (reference
        ``betaVAE.py:165-284``). ``train_data`` and ``val_data`` are (rows,
        genes) float32 arrays, or tensors (one on the card spares each batch
        its copy from the host). Returns the best state (a copy) and
        ``{"best_epoch", "best_loss", "history", "timing"}``."""
        state = state if state is not None else self.init_state()
        mesh = self.mesh
        keeper = BestKeeper(save_dir) if save_dir and mesh.writer else None
        timer = StepTimer()
        history: Dict[str, List[Dict[str, float]]] = {"train": [], "val": []}
        best_loss, best_epoch, best_state = float("inf"), -1, None
        for epoch in range(self.cfg.num_epochs):
            timer.start()
            state, train_losses = self._run_epoch(state, train_data, train=True, epoch=epoch)
            timer.stop(*state.model.z_mu.parameters())
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
        results = {"best_epoch": best_epoch, "best_loss": {"total_loss": best_loss},
                   "history": history, "timing": timer.stats()}
        return best_state, results

    def evaluate(self, data: np.ndarray, state: VAETrainState) -> Tuple[Dict[str, float], np.ndarray]:
        """Test-set mean losses and the valid rows' reconstructions (reference
        ``betaVAE.py:286-331``), the whole set's on every rank."""
        per_batch: List[Losses] = []
        preds = []
        for count, (batch, mask, global_mask) in enumerate(self._batches(data)):
            gen = self.seeds.generator("test", count, device=self.device)
            losses, out = self.eval_step(state, batch, mask, gen)
            per_batch.append(losses)
            out = collectives.gather(out, self.mesh.data_group, dim=0)
            preds.append(out.cpu().numpy()[global_mask > 0])
        return epoch_means(per_batch), (np.concatenate(preds, axis=0) if preds else np.zeros((0,)))
