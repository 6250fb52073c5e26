"""RNA infusion, the "RNA-GAN" mechanism (port of ``rnagan_tpu/losses/rna_infusion.py``).

The generator's noise prior is infused with the frozen beta-VAE encoding of
the patient's gene expression (reference ``wgan_loss.py:97-106``)::

    z      = betavae.encode(gene).z_mean          (VAE in eval mode)
    noise  = U(-0.3, 0.3) + z
    noise  = (noise - mean(noise, axis=0)) / std(noise, axis=0, ddof=1)

Both noise functions take either a ``seed`` (Philox uniforms drawn inside the
CUDA kernel, or by its plain version on the CPU) or the uniforms ``u``
themselves, so tests can feed both packages identical draws. Both run through
``kernels.infusion.infused_noise``.

Under a mesh the training step standardizes over the global batch, as pjit
makes ``jnp.mean`` in the JAX package: :func:`infused_noise` takes the data
group and this rank's first row in the global batch (K1's group mode).
Serving stays on one device, as ``make_serving_fn`` does in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rnagan_tpu_torch.kernels.infusion import infused_noise as _infusion_kernel
from rnagan_tpu_torch.kernels.infusion import standardize_batch  # noqa: F401 (public here)
from rnagan_tpu_torch.models.betavae import BetaVAE


def encode_z_mean(vae: BetaVAE, gene: torch.Tensor) -> torch.Tensor:
    """Frozen-VAE latent mean for a batch of (normalized) expression vectors;
    ``vae`` is in eval mode."""
    return vae.encode(gene)[0]


def infused_noise(z_mean: torch.Tensor, n: Optional[int] = None, *, seed: Optional[int] = None,
                  u: Optional[torch.Tensor] = None, noise_range: float = 0.3, group=None,
                  row0: int = 0) -> torch.Tensor:
    """``standardize_batch(U(-r, r) + z_mean)``; ``z_mean`` (n, D) or (1, D)
    broadcast over ``n`` rows (default: ``z_mean``'s rows). With ``group``
    the rows are ``[row0, row0 + n)`` of a batch split over the group's
    ranks, standardized over the whole of it."""
    n = z_mean.shape[0] if n is None else n
    return _infusion_kernel(z_mean, n, seed=seed, u=u, noise_range=noise_range, group=group, row0=row0)


def infused_noise_population(z_mean: torch.Tensor, pop_mean: torch.Tensor, pop_std: torch.Tensor,
                             num_samples: int, *, seed: Optional[int] = None,
                             u: Optional[torch.Tensor] = None,
                             noise_range: float = 0.3) -> torch.Tensor:
    """Conditioning-preserving infusion: standardize with training-population
    statistics of z_mean instead of the batch's, so one patient's z survives::

        noise = (U + z - E_pop[z]) / sqrt(Var_pop[z] + Var[U])
    """
    return _infusion_kernel(z_mean, num_samples, seed=seed, u=u, noise_range=noise_range,
                            pop_mean=pop_mean, pop_std=pop_std)


@torch.inference_mode()
def z_population_stats(vae: BetaVAE, rna_matrix,
                       batch_size: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and ddof=1 std of z_mean over a (normalized) training expression
    matrix, encoded in chunks of ``batch_size`` on the VAE's device. ``vae``
    is in eval mode."""
    device = next(vae.parameters()).device
    x = torch.as_tensor(rna_matrix, dtype=torch.float32)
    z = torch.cat([encode_z_mean(vae, x[s:s + batch_size].to(device))
                   for s in range(0, len(x), batch_size)])
    return z.mean(dim=0), z.std(dim=0, correction=1)
