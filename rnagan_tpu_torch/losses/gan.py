"""GAN losses (port of ``rnagan_tpu/losses/gan.py``): Wasserstein with the
gradient penalty, minimax (non-saturating), least squares, and weight
clipping. Pure functions of the critic's (N,) scores, except
:func:`gradient_penalty`, which differentiates the critic, and
:func:`clip_params`, which clamps in place.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
import torch.nn.functional as F

from rnagan_tpu_torch.parallel import collectives


def wasserstein_generator_loss(dgz: torch.Tensor) -> torch.Tensor:
    """-mean f(G(z)) (reference ``wgan_loss.py:24-25``)."""
    return -dgz.mean()


def wasserstein_discriminator_loss(dx: torch.Tensor, dgz: torch.Tensor) -> torch.Tensor:
    """mean(f(G(z)) - f(x)) (reference ``wgan_loss.py:28-29``)."""
    return (dgz - dx).mean()


def gradient_penalty(critic: Callable[[torch.Tensor], torch.Tensor], interpolate: torch.Tensor, *,
                     per_sample: bool = True, group=None) -> torch.Tensor:
    """WGAN-GP penalty ``(||grad critic(x_hat)|| - 1)^2``.

    ``per_sample=True``: the norm of each interpolate's gradient, then the
    mean (Gulrajani et al.). ``per_sample=False``: one global norm over the
    whole batch's gradient (the reference's quirk, ``wgan_loss.py:43``).
    The gradient is taken with ``create_graph=True``, so the penalty's own
    backward is the double backward through the critic.

    With a data ``group`` (the batch split over its ranks, equal shares) it
    returns this rank's share of the global-batch penalty: the mean of its
    rows' per-sample terms, or the global norm's penalty (``sqrt`` of the
    all-reduced squared sums), over the group size. The
    critic's BatchNorm reduces over the group, so ``grad`` of this rank's
    score sum is the gradient of the global sum at its rows."""
    x = interpolate.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(critic(x).sum(), x, create_graph=True)
    grads = grads.float()
    size = collectives.group_size(group)
    if per_sample:
        norms = torch.sqrt((grads * grads).sum(dim=tuple(range(1, grads.ndim))) + 1e-12)
        return ((norms - 1.0) ** 2).mean() / size
    norm = torch.sqrt(collectives.all_reduce_sum((grads * grads).sum().reshape(1), group)[0] + 1e-12)
    return (norm - 1.0) ** 2 / size


def minimax_generator_loss(dgz: torch.Tensor, nonsaturating: bool = True) -> torch.Tensor:
    """Non-saturating by default (torchgan MinimaxGeneratorLoss default)."""
    if nonsaturating:
        return F.softplus(-dgz).mean()
    return -F.softplus(dgz).mean()


def minimax_discriminator_loss(dx: torch.Tensor, dgz: torch.Tensor) -> torch.Tensor:
    return F.softplus(-dx).mean() + F.softplus(dgz).mean()


def least_squares_generator_loss(dgz: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    return 0.5 * ((dgz - c) ** 2).mean()


def least_squares_discriminator_loss(dx: torch.Tensor, dgz: torch.Tensor, a: float = 0.0,
                                     b: float = 1.0) -> torch.Tensor:
    return 0.5 * (((dx - b) ** 2).mean() + ((dgz - a) ** 2).mean())


@torch.no_grad()
def clip_params(params: Iterable[torch.Tensor], lo: float, hi: float) -> None:
    """Weight clipping for vanilla WGAN, in place (reference
    ``histopathology_gan.py:270``, applied in ``wgan_loss.py:213-215``)."""
    for p in params:
        p.clamp_(lo, hi)


DISCRIMINATOR_LOSSES = {"wgan": wasserstein_discriminator_loss,
                        "wganvae": wasserstein_discriminator_loss,
                        "minimax": minimax_discriminator_loss,
                        "lsgan": least_squares_discriminator_loss}
GENERATOR_LOSSES = {"wgan": wasserstein_generator_loss, "wganvae": wasserstein_generator_loss,
                    "minimax": minimax_generator_loss, "lsgan": least_squares_generator_loss}
