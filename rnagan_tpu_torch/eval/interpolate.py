"""Latent-space interpolation analysis (port of ``rnagan_tpu/eval/interpolate.py``,
reference ``src/betaVAE_interpolation.py``).

Class-centroid latent means and their difference vectors (tissue against
tissue, ``betaVAE_interpolation.py:116-154``, or any labelling), and latents
decoded after a shift along those directions, the model in eval mode.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from rnagan_tpu_torch.models.betavae import BetaVAE


@torch.no_grad()
def encode_means(model: BetaVAE, data: np.ndarray, batch_size: int = 256) -> np.ndarray:
    """z_mean of every row (eval mode), encoded ``batch_size`` rows at a time."""
    model.eval()
    device = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(data, np.float32))
    outs = [model.encode(x[s:s + batch_size].to(device))[0].cpu() for s in range(0, len(x), batch_size)]
    return torch.cat(outs).numpy()


def class_difference_vectors(z_mu: np.ndarray, labels: np.ndarray) -> Dict[Tuple[int, int], np.ndarray]:
    """Centroid differences for every ordered class pair
    (reference ``betaVAE_interpolation.py:140-154``)."""
    classes = np.unique(labels)
    centroids = {int(c): z_mu[labels == c].mean(axis=0) for c in classes}
    return {(int(a), int(b)): centroids[int(a)] - centroids[int(b)]
            for a in classes for b in classes if a != b}


@torch.no_grad()
def decode_shifted(model: BetaVAE, z: np.ndarray, direction: np.ndarray, alpha: float = 1.0) -> np.ndarray:
    """Decode ``z + alpha * direction`` in float32 (reference ``betaVAE.py:131-139``)."""
    device = next(model.parameters()).device
    shifted = (torch.as_tensor(np.asarray(z, np.float32))
               + alpha * torch.as_tensor(np.asarray(direction, np.float32))).to(device)
    return model.eval().decode(shifted).cpu().numpy()


def interpolation_report(model: BetaVAE, data: np.ndarray, labels: np.ndarray, alpha: float = 1.0):
    """``{z_mu, labels, difference_vectors, recons}``: the reference pickles
    this analysis (``betaVAE_interpolation.py:214-232``)."""
    z_mu = encode_means(model, data)
    diffs = class_difference_vectors(z_mu, labels)
    recons = {pair: decode_shifted(model, z_mu[labels == pair[1]], d, alpha) for pair, d in diffs.items()}
    return {"z_mu": z_mu, "labels": labels, "difference_vectors": diffs, "recons": recons}
