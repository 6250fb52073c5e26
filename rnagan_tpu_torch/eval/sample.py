"""Synthetic gene-expression sampling (port of ``rnagan_tpu/eval/sample.py``,
reference ``src/betaVAE_sample.py``).

Standard-normal latents from a given ``torch.Generator``, optionally offset
along an interpolation direction (``betaVAE_sample.py:119-125``), decoded in
eval mode and taken back to expression space with the checkpointed scaler's
``inverse_transform`` (``betaVAE_sample.py:127-135``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rnagan_tpu_torch.data.rna import Scaler
from rnagan_tpu_torch.models.betavae import BetaVAE


@torch.no_grad()
def sample_expression(model: BetaVAE, scaler: Scaler, num_samples: int,
                      generator: Optional[torch.Generator] = None,
                      interpolation: Optional[np.ndarray] = None, alpha: float = 1.0,
                      z: Optional[torch.Tensor] = None) -> np.ndarray:
    """(num_samples, rna_features) expression values, float32: latents ``z``
    (given, or drawn from ``generator`` on the model's device), plus ``alpha *
    interpolation`` when given, decoded and inverse-transformed."""
    device = next(model.parameters()).device
    if z is None:
        if generator is None:
            raise ValueError("sample_expression needs latents z or a torch.Generator to draw them")
        z = torch.randn((num_samples, model.cfg.z_dim), generator=generator, device=device)
    interp = None if interpolation is None else torch.as_tensor(interpolation, dtype=torch.float32).to(device)
    decoded = model.eval().sample(torch.as_tensor(z, dtype=torch.float32).to(device), interp, alpha)
    return scaler.inverse_transform(decoded.cpu().numpy())
