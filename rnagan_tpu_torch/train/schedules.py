"""Learning-rate schedules (port of ``rnagan_tpu/train/schedules.py``).

The reference steps ``GradualWarmupScheduler(multiplier=1,
total_epoch=1000)`` around ``CosineAnnealingLR(T_max=500)`` once per batch
(``betaVAE_training.py:164-166``): lr ramps linearly from 0 to the base over
the warmup, then follows the periodic cosine closed form. A schedule here is a
``step -> lr`` function evaluated on the host in float32 with the JAX
package's operations and order, so the rate handed to the optimizer is the
float32 number the JAX schedule computes (to an ulp of ``cos``).
"""

from __future__ import annotations

import numpy as np

_F = np.float32


def gradual_warmup_cosine(base_lr: float, warmup_steps: int = 1000, cosine_steps: int = 500,
                          multiplier: float = 1.0, eta_min: float = 0.0):
    peak = base_lr * multiplier

    def schedule(step: int) -> np.float32:
        s = _F(step)
        if multiplier == 1.0:
            warm = _F(base_lr) * s / _F(max(1, warmup_steps))
        else:
            warm = _F(base_lr) * (_F(multiplier - 1.0) * s / _F(max(1, warmup_steps)) + _F(1.0))
        if s < _F(warmup_steps):
            return _F(warm)
        t = s - _F(warmup_steps)
        cos = _F(eta_min) + _F(peak - eta_min) * _F(0.5) * (_F(1.0) + np.cos(_F(np.pi) * t / _F(cosine_steps)))
        return _F(cos)

    return schedule


def constant(lr: float):
    def schedule(step: int) -> np.float32:
        return _F(lr)

    return schedule
