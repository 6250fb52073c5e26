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

A step captured in a CUDA graph (``train/vae_trainer.py``) cannot ask the
host for its rate. :meth:`ScheduledOptimizer.plan` computes, on the host and
with the same functions as the eager step, one float32 row a step,
``(c1, c2, lr, r)``: the bias corrections, the schedule's rate and RAdam's
rectification (0 where it does not rectify), and RAdam's choice a step,
rectified or not, which is a variant of the graph. ``step(..., row=...)``
reads the row from device memory: Adam hands ``(c1, c2, lr)`` to K3, SGD and
RAdam multiply by 0-dim tensors of the row. A float32 product by a 0-dim
tensor rounds as the product by the same float32 number, so both forms of a
step give the same bits.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

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

    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], lr: Optional[float] = None,
             row: Optional[torch.Tensor] = None, rectified: Optional[bool] = None) -> None:
        """``p - lr * g``; the rate ``lr``, or ``row[2]`` in device memory."""
        with torch.no_grad():
            neg_lr = -float(lr) if row is None else -row[2]
            for p, g in zip(params, grads, strict=True):
                p.add_(g * neg_lr)


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

    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], lr: Optional[float] = None,
             row: Optional[torch.Tensor] = None, rectified: Optional[bool] = None) -> None:
        """One step at ``lr``, its corrections and ``r`` computed here; or
        from ``row`` = ``(c1, c2, lr, r)`` in device memory, ``rectified``
        saying whether this step uses ``r`` (:meth:`ScheduledOptimizer.plan`)."""
        t = self.count + 1
        with torch.no_grad():
            if row is None:
                c1, c2 = bias_corrections(t, self.b1, self.b2)
                r = self.rectification(t)
                dev = params[0].device
                c1, c2 = torch.full((), c1, device=dev), torch.full((), c2, device=dev)
                r = None if r is None else float(r)
                neg_lr = -float(lr)
            else:
                if rectified is None:
                    raise ValueError("a RAdam step from a row needs rectified=True or False")
                c1, c2, r, neg_lr = row[0], row[1], row[3] if rectified else None, -row[2]
            for p, g, mu, nu in zip(params, grads, self.mu, self.nu, strict=True):
                mu.copy_(g * (1.0 - self.b1) + mu * self.b1)
                nu.copy_((g * g) * (1.0 - self.b2) + nu * self.b2)
                mu_hat = mu / c1
                upd = mu_hat if r is None else (mu_hat * r) / (torch.sqrt(nu / c2) + self.eps)
                p.add_(upd * neg_lr)
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

    def plan(self, k: int) -> Tuple[torch.Tensor, List[Optional[bool]]]:
        """The next ``k`` steps' rows, a float32 (k, 4) CPU tensor of
        ``(c1, c2, lr, r)`` (the bias corrections at the rule's count, the
        schedule's rate at this count, RAdam's ``r`` or 0), and each step's
        variant: RAdam's rectified-or-not, None for Adam and SGD. The host
        computes them as :meth:`step` does without a row; nothing advances."""
        rows, variants = [], []
        for i in range(k):
            t = self.rule.count + 1 + i
            c1, c2 = bias_corrections(t, self.rule.b1, self.rule.b2) if self.name != "sgd" else (1.0, 1.0)
            r = self.rule.rectification(t) if self.name == "radam" else None
            rows.append([c1, c2, float(self.schedule(self.count + i)), 0.0 if r is None else float(r)])
            variants.append(r is not None if self.name == "radam" else None)
        return torch.tensor(rows, dtype=torch.float32).reshape(k, 4), variants

    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             row: Optional[torch.Tensor] = None, variant: Optional[bool] = None) -> None:
        """One step at the schedule's rate for this count, or from ``row``,
        this step's row of :meth:`plan` in device memory, and its ``variant``."""
        if self.weight_decay:
            with torch.no_grad():
                grads = [g + p.detach() * self.weight_decay for p, g in zip(params, grads, strict=True)]
        if row is None:
            self.rule.step(params, grads, lr=self.lr())
        elif self.name == "adam":
            self.rule.step(params, grads, corr=row[:3])
        else:
            self.rule.step(params, grads, row=row, rectified=variant)
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
