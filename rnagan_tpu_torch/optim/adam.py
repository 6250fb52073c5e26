"""Adam for one model through the K3 kernel (the port of the ``optax.adam``
that the JAX trainer builds, ``rnagan_tpu/train/gan_trainer.py:146-147``).

:class:`Adam` holds the optimizer state of one model: ``mu`` and ``nu``, one
tensor per parameter in the model's ``parameters()`` order, and the integer
step ``count``. :meth:`Adam.step` takes ``t = count + 1``, computes the bias
corrections ``1 - b1^t`` and ``1 - b2^t`` on the host in float32 (as
``ops/fused_adam.py:87-89`` does), launches K3 once over every tensor and
advances the count. A step captured in a CUDA graph passes ``corr``, the same
two float32 values in device memory, read by the kernel on every replay
(``train/step_graph.py``; :meth:`Adam.plan` gives a run of steps' rows), or
three: the β-VAE's scheduled rate after them (``optim/scheduled.py``). With ``mu_dtype=torch.bfloat16``, ``mu`` is stored in
bfloat16 and the kernel computes in float32 from the stored value (optax's
``mu_dtype``); ``nu`` stays float32.

:class:`AdamW` is ``optax.adamw`` (the ResNet trainers' optimizer,
``rnagan_tpu/train/ml_experiment.py:105``): the same step with
``weight_decay * p`` added to Adam's update inside the kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from rnagan_tpu_torch.kernels.fused_adam import fused_adam


def bias_corrections(t: int, b1: float, b2: float) -> Tuple[float, float]:
    """``(1 - b1^t, 1 - b2^t)`` in float32, returned as Python floats."""
    t32 = np.float32(t)
    one = np.float32(1.0)
    return float(one - np.float32(b1) ** t32), float(one - np.float32(b2) ** t32)


class Adam:
    """Adam state for one model's parameter list (``optax.adam`` math)."""

    #: decoupled weight decay (:class:`AdamW`); Adam has none
    weight_decay = 0.0

    def __init__(self, params: Sequence[torch.Tensor], *, lr: float, b1: float, b2: float,
                 eps: float = 1e-8, mu_dtype: Optional[torch.dtype] = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu_dtype = mu_dtype or torch.float32
        self.mu = [torch.zeros_like(p, dtype=self.mu_dtype) for p in params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.count = 0

    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             lr: Optional[float] = None, corr: Optional[torch.Tensor] = None) -> None:
        """One update of ``params`` in place (one K3 launch on the card), at
        ``lr`` when given (a schedule's rate for this step) or at ``self.lr``.
        ``corr`` (float32 on the device) gives this step's bias corrections,
        ``bias_corrections(count + 1)``, from device memory: (2,), or (3,)
        with the step's rate after them (``lr`` then None); without it they
        are computed here. A gradient whose strides differ from its
        contiguous parameter's (the CPU's convolution backward may return one
        in channels-last order) is made contiguous first, so element i of
        each buffer is one weight."""
        c1 = c2 = None
        if corr is None:
            c1, c2 = bias_corrections(self.count + 1, self.b1, self.b2)
        rate = None if corr is not None and corr.shape[0] == 3 else (self.lr if lr is None else float(lr))
        with torch.no_grad():
            fused_adam([p.detach() for p in params], [g.contiguous() for g in grads],
                       self.mu, self.nu, c1=c1, c2=c2, lr=rate,
                       b1=self.b1, b2=self.b2, eps=self.eps, wd=self.weight_decay, corr=corr)
        self.count += 1

    def plan(self, steps: int) -> torch.Tensor:
        """The next ``steps`` steps' bias corrections, a float32 (steps, 2)
        CPU tensor whose row i is ``bias_corrections(count + 1 + i)``: the
        ``corr`` rows that a run of captured steps reads from a device table
        (the rate stays ``lr``). Nothing advances."""
        return torch.tensor([bias_corrections(self.count + 1 + i, self.b1, self.b2) for i in range(steps)],
                            dtype=torch.float32).reshape(steps, 2)

    def state_dict(self, device="cpu") -> Dict[str, Any]:
        """``torch.optim.Adam.state_dict()`` layout (torchgan ``.model`` bundles;
        :class:`AdamW`'s is ``torch.optim.AdamW``'s, the same keys); the
        moments copied to ``device`` (the CPU by default), ``exp_avg`` float32
        whatever ``mu_dtype`` is."""
        state = {i: {"step": torch.tensor(float(self.count)),
                     "exp_avg": mu.detach().to(device, torch.float32, copy=True),
                     "exp_avg_sq": nu.detach().to(device, copy=True)}
                 for i, (mu, nu) in enumerate(zip(self.mu, self.nu))}
        group = {"lr": self.lr, "betas": (self.b1, self.b2), "eps": self.eps,
                 "weight_decay": self.weight_decay,
                 "amsgrad": False, "maximize": False, "foreach": None, "capturable": False,
                 "differentiable": False, "fused": None, "params": list(range(len(self.mu)))}
        return {"state": state, "param_groups": [group]}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Moments and count from a ``torch.optim.Adam`` state_dict; a parameter
        without an entry (torch fills its state lazily) keeps zero moments."""
        self.count = 0
        for i, (mu, nu) in enumerate(zip(self.mu, self.nu)):
            entry = sd["state"].get(i)
            if entry is None:
                mu.zero_()
                nu.zero_()
                continue
            mu.copy_(torch.as_tensor(entry["exp_avg"]).reshape(mu.shape))
            nu.copy_(torch.as_tensor(entry["exp_avg_sq"]).reshape(nu.shape))
            self.count = int(float(entry["step"]))


class AdamW(Adam):
    """``optax.adamw(lr, b1, b2, eps, weight_decay=...)``: Adam whose update
    takes ``weight_decay * p`` before the rate scales it (optax's
    ``add_decayed_weights``, every parameter decayed), one K3 launch a step.
    Its ``state_dict`` has ``torch.optim.AdamW``'s layout; torch's AdamW
    decays as ``p * (1 - lr * wd)`` first, which rounds otherwise."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, weight_decay: float = 1e-4,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: Optional[torch.dtype] = None):
        super().__init__(params, lr=lr, b1=b1, b2=b2, eps=eps, mu_dtype=mu_dtype)
        self.weight_decay = float(weight_decay)
