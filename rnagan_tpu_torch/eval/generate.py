"""Tile synthesis (port of ``rnagan_tpu/eval/generate.py`` and ``GANTrainer.sample``).

:class:`Synthesizer` serves RNA-GAN tiles: frozen beta-VAE encode -> infused
noise (CUDA kernel ``kernels/infusion``) -> BN-folded generator (with
``quantized_head``, its head through the int8 CUDA kernel
``kernels/quant_matmul``) -> tanh->uint8 NHWC (CUDA kernel
``kernels/quantize``). It is the counterpart of ``GANTrainer._sample_impl``
followed by ``make_serving_fn``, for every arch that serves (``condgan``
takes labels).

:func:`generate_images`, :func:`generate_patient_grid` and
:func:`compare_real_vs_synthetic` are the JAX module's protocol around a
trainer's ``sample`` (``rnagan_tpu/eval/generate.py:42-91``): [0, 1] tiles,
the patient grid, the real / RNA-GAN / GAN comparison. A ``seed`` (the
port's Philox and generator seeds) takes the place of a ``jax.random`` key.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from rnagan_tpu_torch.core import profiling
from rnagan_tpu_torch.core.config import GANConfig
from rnagan_tpu_torch.core.device import resolve_device
from rnagan_tpu_torch.eval.serving import make_serving_fn
from rnagan_tpu_torch.losses.rna_infusion import (encode_z_mean, infused_noise,
                                                  infused_noise_population)
from rnagan_tpu_torch.models.betavae import BetaVAE
from rnagan_tpu_torch.utils.images import save_image_grid


def unnormalize(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1] (mean/std 0.5 inverse, reference ``gan_utils.py:236-240``)."""
    return torch.clamp(torch.as_tensor(images, dtype=torch.float32) * 0.5 + 0.5, 0.0, 1.0)


def to_unit_range(images: torch.Tensor) -> torch.Tensor:
    """Tiles to [0, 1] floats by dtype: uint8 -> /255; float with negatives ->
    un-normalize from [-1, 1]; other floats are already in [0, 1]."""
    t = torch.as_tensor(images)
    if t.dtype == torch.uint8:
        return t.float() / 255.0
    t = t.float()
    return unnormalize(t) if bool(t.min() < 0) else t


def generate_images(trainer, state, num_images: int, seed: int, gene=None,
                    condition_mode: str = "reference") -> torch.Tensor:
    """``num_images`` tiles in [0, 1] NHWC on the trainer's device. With
    ``gene`` (a patient's normalized expression row, (F,) or (1, F)) the noise
    is the RNA-infused prior through K1. ``condition_mode="reference"``
    standardizes over the batch, which cancels one patient's broadcast z, as
    the reference does; ``"population"`` standardizes with the training
    population's z statistics (``trainer.z_pop``, from ``set_z_population``
    or a checkpoint that bundles it) and keeps the patient's signal."""
    z_pop = None
    if gene is not None:
        gene = torch.atleast_2d(torch.as_tensor(gene, dtype=torch.float32))
        if condition_mode == "population":
            if trainer.z_pop is None:
                raise ValueError(
                    "condition_mode='population' needs trainer.z_pop: call "
                    "trainer.set_z_population(rna_matrix) or load a checkpoint that bundles it")
            z_pop = trainer.z_pop
    return unnormalize(trainer.sample(state, num_images, gene=gene, z_pop=z_pop, seed=seed))


def generate_patient_grid(trainer, state, gene, seed: int, save_path: str,
                          sample_size: int = 64) -> torch.Tensor:
    """The ``--random_patient`` path: a patient's tiles, saved as a grid of 8
    columns (reference ``generate_tissue_images.py:100-105``)."""
    imgs = generate_images(trainer, state, sample_size, seed, gene=gene)
    save_image_grid(imgs * 2.0 - 1.0, save_path, nrow=8)
    return imgs


def compare_real_vs_synthetic(rna_trainer, rna_state, gan_trainer, gan_state, real_tiles, gene,
                              seed: int, save_dir: str, sample_size: int = 64,
                              prefix: str = "patient"):
    """Real tiles against RNA-GAN tiles of the patient's ``gene`` and
    unconditional GAN tiles (``generate_tissue_images.py:106-127``): three
    grids in ``save_dir``; returns the three [0, 1] sets. The two generations
    take seeds ``seed`` and ``seed + 1``."""
    os.makedirs(save_dir, exist_ok=True)
    rna_imgs = generate_images(rna_trainer, rna_state, sample_size, seed, gene=gene)
    gan_imgs = generate_images(gan_trainer, gan_state, sample_size, seed + 1)
    real = to_unit_range(real_tiles)
    for name, imgs in (("real", real), ("rnagan", rna_imgs), ("gan", gan_imgs)):
        save_image_grid(imgs * 2 - 1, os.path.join(save_dir, f"{prefix}_{name}.png"), nrow=8)
    return real, rna_imgs, gan_imgs


class Synthesizer:
    """Frozen beta-VAE + serving generator on one device.

    ``vae_state_dict`` and ``g_state_dict`` are torch state_dicts in the
    reference layouts (``convert.py`` makes them from JAX weights or loads
    them from ``.pt`` / ``.model`` files). ``quantized_head`` and
    ``quantized_full`` go to ``make_serving_fn``."""

    def __init__(self, cfg: GANConfig, vae_state_dict: Dict[str, torch.Tensor],
                 g_state_dict: Dict[str, torch.Tensor], *, uint8_output: bool = True,
                 quantized_head: bool = False, quantized_full: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.vae = BetaVAE(cfg.vae, device=self.device)
        self.vae.load_state_dict(vae_state_dict)
        self.vae.eval().requires_grad_(False)
        self.serve = make_serving_fn(cfg.model, g_state_dict, uint8_output=uint8_output,
                                     quantized_head=quantized_head, quantized_full=quantized_full,
                                     device=self.device)

    @torch.inference_mode()
    def synthesize(self, gene, n: Optional[int] = None, *, seed: Optional[int] = None,
                   u: Optional[torch.Tensor] = None,
                   z_pop: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Tiles (n, H, W, C) for ``gene`` (B, F) normalized expression rows;
        a (1, F) row is one patient broadcast over ``n`` samples (default B).

        Exactly one of ``seed`` (uniforms drawn in the kernel) and ``u``
        ((n, encoding_dims) uniforms in [-noise_range, noise_range]). Without
        ``z_pop`` the noise is standardized over the batch, as the reference
        does; with ``z_pop = (mean, std)`` of z over the training population
        (``z_population_stats``) it keeps the patient signal. ``labels`` (n,)
        int classes are required by ``condgan`` and refused by the others.
        The host's work is the span ``synth.request``, the rows' copy to the
        device ``synth.ingress`` inside it (``core/profiling.py``)."""
        if (labels is None) == (self.cfg.model.arch == "condgan"):
            raise ValueError("labels go with arch='condgan', and only with it")
        with profiling.span("synth.request"):
            with profiling.span("synth.ingress"):
                gene = torch.as_tensor(gene, dtype=torch.float32).to(self.device)
                if u is not None:
                    u = torch.as_tensor(u, dtype=torch.float32).to(self.device).contiguous()
            if gene.ndim != 2:
                raise ValueError(f"gene must be (B, F); got {tuple(gene.shape)}")
            n = gene.shape[0] if n is None else n
            profiling.mark("synth_encode", self.device)
            z = encode_z_mean(self.vae, gene)
            profiling.mark("synth_noise", self.device)
            r = self.cfg.noise_range
            if z_pop is None:
                noise = infused_noise(z, n, seed=seed, u=u, noise_range=r)
            else:
                pop_mean, pop_std = (torch.as_tensor(t, dtype=torch.float32).to(self.device).contiguous()
                                     for t in z_pop)
                noise = infused_noise_population(z, pop_mean, pop_std, n, seed=seed, u=u, noise_range=r)
            if labels is not None:
                return self.serve(noise, torch.as_tensor(labels).to(self.device))
            return self.serve(noise)
