"""The β-VAE trainer's optimizer (port of ``make_optimizer``,
``rnagan_tpu/train/vae_trainer.py:61-74``).

The JAX trainer builds ``optax.chain(add_decayed_weights(wd), rule(schedule))``
(the decay only when ``weight_decay > 0``), ``rule`` one of ``adam``, ``sgd``
and ``radam``. :class:`ScheduledOptimizer` is that chain:

* the step's rate is ``schedule(count)`` at the count *before* the update
  (optax's ``scale_by_schedule``): step 0 runs at the warmup's ``lr = 0``,
  which moves Adam's moments and not the parameters;
* ``weight_decay`` adds ``wd * p`` to every gradient, BatchNorm scales and
  biases included, in plain ops ahead of the rule;
* :class:`~rnagan_tpu_torch.optim.adam.Adam` applies optax's Adam through
  the K3 kernel, one launch over every tensor; :class:`SGD` and
  :class:`RAdam` are plain PyTorch ops with optax's arithmetic (optax's
  rectification, not ``torch.optim.RAdam``'s). Neither is a TPU kernel.

Each rule's update lands as ``p + (-lr) * u``, which is optax's
``apply_updates`` of ``scale_by_learning_rate``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from rnagan_tpu_torch.core.config import VAEConfig
from rnagan_tpu_torch.optim.adam import Adam, bias_corrections
from rnagan_tpu_torch.train.schedules import gradual_warmup_cosine

_F = np.float32


class SGD:
    """``optax.sgd`` without momentum: no state."""

    def __init__(self, params: Sequence[torch.Tensor]):
        self.count = 0
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], lr: float) -> None:
        with torch.no_grad():
            for p, g in zip(params, grads, strict=True):
                p.add_(g * -float(lr))


class RAdam:
    """``optax.radam`` (``scale_by_radam``, threshold 5): Adam's moments; the
    update is ``r * mu_hat / (sqrt(nu_hat) + eps)`` while the variance is
    tractable (``ro >= threshold``) and ``mu_hat`` before. ``ro`` and ``r``
    are scalars computed on the host in float32, as optax computes them; the
    per-element work divides by device tensors, so it rounds alike on the
    CPU and the card."""

    def __init__(self, params: Sequence[torch.Tensor], *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, threshold: float = 5.0):
        self.b1, self.b2, self.eps, self.threshold = b1, b2, eps, threshold
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.count = 0

    def rectification(self, t: int) -> Optional[np.float32]:
        """``r`` at step ``t``, or None while ``ro`` is below the threshold."""
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        b2t = _F(self.b2) ** _F(t)
        ro = _F(ro_inf) - _F(2 * t) * b2t / (_F(1.0) - b2t)
        if not ro >= _F(self.threshold):
            return None
        num = (ro - _F(4.0)) * (ro - _F(2.0)) * _F(ro_inf)
        den = _F((ro_inf - 4.0) * (ro_inf - 2.0)) * ro
        return _F(np.sqrt(num / den))

    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], lr: float) -> None:
        t = self.count + 1
        c1, c2 = bias_corrections(t, self.b1, self.b2)
        r = self.rectification(t)
        with torch.no_grad():
            dev = params[0].device
            c1, c2 = torch.full((), c1, device=dev), torch.full((), c2, device=dev)
            for p, g, mu, nu in zip(params, grads, self.mu, self.nu, strict=True):
                mu.copy_(g * (1.0 - self.b1) + mu * self.b1)
                nu.copy_((g * g) * (1.0 - self.b2) + nu * self.b2)
                mu_hat = mu / c1
                upd = mu_hat if r is None else (mu_hat * float(r)) / (torch.sqrt(nu / c2) + self.eps)
                p.add_(upd * -float(lr))
        self.count = t


class ScheduledOptimizer:
    """``rule`` (named ``name``) at the rates of ``schedule``, with
    ``weight_decay * p`` added to each gradient when it is non-zero;
    ``count`` is optax's ``ScaleByScheduleState.count``."""

    def __init__(self, name: str, rule, schedule, weight_decay: float = 0.0):
        self.name, self.rule, self.schedule, self.weight_decay = name, rule, schedule, weight_decay
        self.count = 0

    def lr(self) -> float:
        """This step's rate."""
        return float(self.schedule(self.count))

    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> None:
        lr = self.lr()
        if self.weight_decay:
            with torch.no_grad():
                grads = [g + p.detach() * self.weight_decay for p, g in zip(params, grads, strict=True)]
        self.rule.step(params, grads, lr=lr)
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        """``{"count", "rule_count", "mu", "nu"}`` (copies; the moments empty
        for sgd): the form ``convert.vae_optimizer_state_*`` moves."""
        return {"count": self.count, "rule_count": self.rule.count,
                "mu": [m.detach().clone() for m in self.rule.mu],
                "nu": [v.detach().clone() for v in self.rule.nu]}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.count, self.rule.count = int(sd["count"]), int(sd["rule_count"])
        for dst, src in zip([*self.rule.mu, *self.rule.nu], [*sd["mu"], *sd["nu"]], strict=True):
            dst.copy_(torch.as_tensor(src).reshape(dst.shape))


def make_optimizer(cfg: VAEConfig, params: Sequence[torch.Tensor]) -> ScheduledOptimizer:
    """Adam / SGD / RAdam (reference ``betaVAE_training.py:157-162``; any
    other name is Adam, as in the JAX package) with the warmup+cosine
    schedule stepped per batch."""
    params = list(params)
    name = cfg.optimizer.lower()
    if name == "sgd":
        rule = SGD(params)
    elif name == "radam":
        rule = RAdam(params)
    else:
        name, rule = "adam", Adam(params, lr=cfg.lr, b1=0.9, b2=0.999, eps=1e-8)
    schedule = gradual_warmup_cosine(cfg.lr, cfg.warmup_steps, cfg.cosine_steps)
    return ScheduledOptimizer(name, rule, schedule, cfg.weight_decay)
