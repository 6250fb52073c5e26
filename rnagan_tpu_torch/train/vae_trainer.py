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

from rnagan_tpu_torch.core.checkpoint import BestKeeper
from rnagan_tpu_torch.core.config import VAEConfig
from rnagan_tpu_torch.core.device import resolve_device
from rnagan_tpu_torch.core.metrics import MetricsLogger, epoch_means
from rnagan_tpu_torch.core.profiling import StepTimer
from rnagan_tpu_torch.core.rng import SeedStream
from rnagan_tpu_torch.data.rna import Scaler, batch_iterator
from rnagan_tpu_torch.losses.vae import masked_beta_vae_loss
from rnagan_tpu_torch.models.betavae import BetaVAE
from rnagan_tpu_torch.optim.scheduled import ScheduledOptimizer, make_optimizer

Losses = Dict[str, torch.Tensor]


@dataclass
class VAETrainState:
    """``model`` holds the parameters and the BatchNorm running statistics
    (``batch_stats``), ``opt`` the optimizer state."""

    step: int
    model: BetaVAE
    opt: ScheduledOptimizer


class VAETrainer:
    """β-VAE training on one card (``device="cuda"``, the default, raises
    without CUDA; the tests pass ``"cpu"``)."""

    def __init__(self, cfg: VAEConfig, *, device="cuda", logger: Optional[MetricsLogger] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.logger = logger or MetricsLogger()
        self.seeds = SeedStream(cfg.seed)

    # ------------------------------------------------------------------ state
    def init_state(self) -> VAETrainState:
        model = BetaVAE(self.cfg.model, seed=self.seeds.seed("init"), device=self.device)
        return VAETrainState(step=0, model=model, opt=make_optimizer(self.cfg, model.parameters()))

    def state_from_jax(self, tree) -> VAETrainState:
        """A JAX ``VAETrainState`` in flax's state-dict form
        (``serialization.to_state_dict``), on this trainer's device."""
        from rnagan_tpu_torch import convert

        moved = convert.vae_train_state_from_jax(self.cfg, tree)
        state = self.init_state()
        state.model.load_state_dict(moved["model"])
        state.opt.load_state_dict(moved["optimizer"])
        state.step = moved["step"]
        return state

    def state_to_jax(self, state: VAETrainState) -> Dict[str, Any]:
        """The inverse of :meth:`state_from_jax` (numpy leaves)."""
        from rnagan_tpu_torch import convert

        return convert.vae_train_state_to_jax(self.cfg, state.step, state.model.state_dict(),
                                              state.opt.state_dict())

    # ------------------------------------------------------------------ steps
    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype).to(self.device)

    def train_step(self, state: VAETrainState, batch, mask,
                   draws: Optional[Dict[str, Any]] = None) -> Tuple[VAETrainState, Losses]:
        """One step on ``batch`` (N, F) normalized expression with ``mask``
        (N,) marking the valid rows. ``draws`` optionally gives ``keep`` (the
        dropout mask, bool (N, F)) and ``eps`` ((N, z) standard normals).
        Returns ``(state, losses)``, the state updated in place; the losses
        (``total_loss``, ``reconstruction_loss``, ``kl_loss``) are 0-dim tensors."""
        draws = draws or {}
        x, m = self._tensor(batch), self._tensor(mask)
        keep = draws.get("keep")
        keep = None if keep is None else self._tensor(keep, torch.bool)
        eps = draws.get("eps")
        eps = None if eps is None else self._tensor(eps)
        gen = None
        if keep is None or eps is None:
            gen = self.seeds.generator("train", state.step, device=self.device)
        model = state.model.train()
        out, z_mean, z_logvar = model(x, gen, keep=keep, eps=eps)
        losses = masked_beta_vae_loss(x, out, z_mean, z_logvar, m, self.cfg.model.beta, True)
        params = list(model.parameters())
        grads = torch.autograd.grad(losses["total_loss"], params)
        state.opt.step(params, grads)
        state.step += 1
        return state, {k: v.detach() for k, v in losses.items()}

    @torch.no_grad()
    def eval_step(self, state: VAETrainState, batch, mask, generator: Optional[torch.Generator] = None,
                  eps=None) -> Tuple[Losses, torch.Tensor]:
        """Eval-mode losses (the validation total is the reconstruction) and
        the reconstructions; ``eps`` given or drawn from ``generator``."""
        x, m = self._tensor(batch), self._tensor(mask)
        model = state.model.eval()
        out, z_mean, z_logvar = model(x, generator, eps=None if eps is None else self._tensor(eps))
        return masked_beta_vae_loss(x, out, z_mean, z_logvar, m, self.cfg.model.beta, False), out

    # ------------------------------------------------------------------ loops
    def _run_epoch(self, state: VAETrainState, data: np.ndarray, *, train: bool, epoch: int):
        per_batch: List[Losses] = []
        for count, (batch, mask) in enumerate(batch_iterator(data, self.cfg.batch_size, shuffle=train,
                                                             seed=self.cfg.seed, epoch=epoch)):
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
        keeper = BestKeeper(save_dir) if save_dir else None
        timer = StepTimer()
        history: Dict[str, List[Dict[str, float]]] = {"train": [], "val": []}
        best_loss, best_epoch, best_state = float("inf"), -1, None
        for epoch in range(self.cfg.num_epochs):
            timer.start()
            state, train_losses = self._run_epoch(state, train_data, train=True, epoch=epoch)
            timer.stop(*state.model.z_mu.parameters())
            _, val_losses = self._run_epoch(state, val_data, train=False, epoch=epoch)
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
                if keeper:
                    keeper.update(epoch, best_loss, state.model.state_dict(), scaler, {"config": "betavae"})
        if keeper:
            keeper.save_last(state.model.state_dict(), scaler)
        if best_state is None:
            best_state = state  # every validation loss NaN: the final state
        results = {"best_epoch": best_epoch, "best_loss": {"total_loss": best_loss},
                   "history": history, "timing": timer.stats()}
        return best_state, results

    def evaluate(self, data: np.ndarray, state: VAETrainState) -> Tuple[Dict[str, float], np.ndarray]:
        """Test-set mean losses and the valid rows' reconstructions (reference
        ``betaVAE.py:286-331``)."""
        per_batch: List[Losses] = []
        preds = []
        for count, (batch, mask) in enumerate(batch_iterator(data, self.cfg.batch_size)):
            gen = self.seeds.generator("test", count, device=self.device)
            losses, out = self.eval_step(state, batch, mask, gen)
            per_batch.append(losses)
            preds.append(out.cpu().numpy()[mask > 0])
        return epoch_means(per_batch), (np.concatenate(preds, axis=0) if preds else np.zeros((0,)))
