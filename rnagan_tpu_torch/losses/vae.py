"""beta-VAE ELBO loss (port of ``rnagan_tpu/losses/vae.py`` and the masked form
of ``rnagan_tpu/train/vae_trainer.py:47-58``).

* reconstruction = mean squared error over every element;
* KL = batch mean of ``-0.5 * sum(1 + logvar - mu^2 - exp(logvar), axis=1)``;
* training total = recons + beta * KL; the validation total is the
  reconstruction alone (reference ``betaVAE.py:151-155``).

The masked form takes the per-row MSE and KL and averages them over the rows
whose mask is 1 (the wrap-padded duplicates of a short final batch count 0).
Every value is a 0-dim float32 tensor. With a data ``group`` (the batch
split over its ranks) the count is the global one and each value is this
rank's share: the shares sum over the group to the global loss.
"""

from __future__ import annotations

from typing import Dict

import torch

from rnagan_tpu_torch.parallel import collectives


def _kl_rows(z_mean: torch.Tensor, z_logvar: torch.Tensor) -> torch.Tensor:
    return -0.5 * torch.sum(1.0 + z_logvar - torch.square(z_mean) - torch.exp(z_logvar), dim=1)


def beta_vae_loss(x: torch.Tensor, x_recons: torch.Tensor, z_mean: torch.Tensor,
                  z_logvar: torch.Tensor, beta: float, training: bool = True) -> Dict[str, torch.Tensor]:
    x, x_recons = x.float(), x_recons.float()
    recons = torch.mean(torch.square(x_recons - x))
    kl = torch.mean(_kl_rows(z_mean, z_logvar))
    total = recons + beta * kl if training else recons
    return {"total_loss": total, "reconstruction_loss": recons, "kl_loss": kl}


def masked_beta_vae_loss(x: torch.Tensor, x_recons: torch.Tensor, z_mean: torch.Tensor,
                         z_logvar: torch.Tensor, mask: torch.Tensor, beta: float,
                         training: bool = True, group=None) -> Dict[str, torch.Tensor]:
    """:func:`beta_vae_loss` over the rows where ``mask`` (N,) is 1 (with
    ``group``: this rank's share of it over the group's rows)."""
    mask = mask.float()
    denom = collectives.global_count(mask, group)
    per_row_mse = torch.mean(torch.square(x_recons.float() - x.float()), dim=1)
    recons = torch.sum(per_row_mse * mask) / denom
    kl = torch.sum(_kl_rows(z_mean, z_logvar) * mask) / denom
    total = recons + beta * kl if training else recons
    return {"total_loss": total, "reconstruction_loss": recons, "kl_loss": kl}
