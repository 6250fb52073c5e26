"""beta-VAE over RNA-seq expression vectors (port of ``rnagan_tpu/models/betavae.py``).

Module tree and state_dict keys are the reference torch model's
(``betaVAE.py:63-94``), the layout ``params_to_torch_state_dict`` writes:

* ``encoder.encoder.0`` Dropout, then ``encoder.encoder.{i+1}`` =
  (Linear ``.0``, BatchNorm1d ``.1``, LeakyReLU) per encoder width;
* ``z_mu`` and ``z_logvar`` heads;
* ``decoder.{i}`` = (Linear, BatchNorm1d, LeakyReLU) per decoder width, then
  ``decoder.{n}`` = (Linear, Tanh).

So reference ``.pt`` checkpoints load unchanged. LeakyReLU slope 0.01.

Train mode has the JAX model's semantics (flax ``nn.BatchNorm(momentum=0.9,
use_fast_variance=True)`` and ``nn.Dropout``):

* BatchNorm normalizes with the biased batch statistics, reduced in float32
  (``models/batchnorm.py``), and writes the new running statistics
  (``0.9 * old + 0.1 * batch``, the variance the biased one) into the
  ``BatchNorm1d`` buffers in place;
* dropout is :func:`dropout`: ``where(keep, x / keep_prob, 0)``, its mask
  given outright, or drawn from a seed's Philox stream (:func:`draw_keep`,
  what the trainer's steps use) or from a ``torch.Generator``.

The reparametrization's ``eps`` is given, or drawn from a seed
(:func:`draw_eps`) or a generator. A seed is a host int or a one-element
integer tensor on the device (``core/rng.py``): a step captured in a CUDA
graph reads it from a table, and draws the bits the eager step draws.

Eval mode normalizes with the running statistics (``F.batch_norm``). The
forward reparametrizes in both modes, as the reference does.

Parameters stay float32; ``cfg.compute_dtype="bfloat16"`` runs the layers in
bfloat16 on cast copies of the weights and returns float32 latents, as the
JAX model does.

Tensor parallelism (``parallel/mesh.py::shard_dense_params`` on a mesh with a
model axis): a split ``Linear`` holds this rank's block of output features
and its ``BatchNorm1d`` the same block (statistics over the data group
only). Megatron's column-parallel layer: the layer's input passes an
identity whose backward sums the gradient over the model group (each rank
differentiates only through its own columns), and its outputs, after the
BatchNorm and activation, are gathered over the model group with a
slice-backward gather, so every later op sees the whole activation (the
heads' ``z_mean``/``z_logvar``, the 19,198-wide output). An unsplit layer
runs as before.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rnagan_tpu_torch.core import rng
from rnagan_tpu_torch.core.config import VAEModelConfig
from rnagan_tpu_torch.core.device import compute_dtype
from rnagan_tpu_torch.models.batchnorm import batch_norm
from rnagan_tpu_torch.parallel import collectives


def draw_keep(seed, shape, rate: float, device) -> torch.Tensor:
    """The dropout mask ``U[0, 1) < 1 - rate`` (bool, ``shape``), its
    uniforms four a Philox counter from ``seed`` (``core/rng.py::uniform4``)."""
    return rng.uniform4(seed, shape, device) < 1.0 - rate


def draw_eps(seed, shape, device) -> torch.Tensor:
    """The reparametrization's standard normals (float32, ``shape``) from ``seed``."""
    return rng.normal(seed, shape, device)


def dropout(x: torch.Tensor, rate: float, keep: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None, seed=None) -> torch.Tensor:
    """flax ``nn.Dropout``'s arithmetic: ``where(keep, x / keep_prob, 0)``
    with ``keep_prob = 1 - rate`` in ``x``'s dtype, divided as a tensor on
    ``x``'s device (so the division is IEEE on the card too; ``torch.full``
    fills it there, where ``torch.tensor`` would copy it from the host and
    wait for the stream). ``keep`` (bool, ``x``'s shape) is the mask; without
    it, ``keep = U[0, 1) < keep_prob`` from ``seed`` (:func:`draw_keep`) or
    from ``generator``."""
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    if keep is None:
        if seed is not None:
            keep = draw_keep(seed, x.shape, rate, x.device)
        elif generator is not None:
            keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
        else:
            raise ValueError("dropout needs a keep mask, a seed or a torch.Generator to draw one")
    scale = torch.full((), keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep.to(x.device, torch.bool), x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """The encoder's input dropout (no parameters: ``encoder.encoder.0``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, seed=None) -> torch.Tensor:
        return dropout(x, self.rate, keep, generator, seed) if self.training else x


def _block(fan_in: int, width: int, slope: float, device) -> nn.Sequential:
    return nn.Sequential(nn.Linear(fan_in, width, device=device),
                         nn.BatchNorm1d(width, eps=1e-5, momentum=0.1, device=device),
                         nn.LeakyReLU(slope))


def _split_group(lin: nn.Linear):
    """The model group of a split layer (``shard_dense_params``), else None."""
    if getattr(lin, "model_split", None) is None:
        return None
    group = collectives.model_group()
    if group is None:
        raise ValueError("a model-split BetaVAE runs under its mesh (parallel.collectives.active)")
    return group


def _linear(lin: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``lin`` in ``dt``; a split layer's input sums its gradient over the group."""
    group = _split_group(lin)
    if group is not None:
        x = collectives.sum_gradients(x, group)
    return F.linear(x, lin.weight.to(dt), lin.bias.to(dt))


def _whole(lin: nn.Linear, y: torch.Tensor) -> torch.Tensor:
    """A split layer's outputs gathered over the model group (the whole width)."""
    group = _split_group(lin)
    return y if group is None else collectives.gather(y, group, dim=-1)


def _apply_block(block: nn.Sequential, x: torch.Tensor, dt: torch.dtype, slope: float) -> torch.Tensor:
    lin, bn = block[0], block[1]
    x = _linear(lin, x, dt)
    if bn.training:
        x, mean, var = batch_norm(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, train=True)
        with torch.no_grad():
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
    else:
        x = F.batch_norm(x, bn.running_mean.to(dt), bn.running_var.to(dt), bn.weight.to(dt),
                         bn.bias.to(dt), False, bn.momentum, bn.eps)
    return _whole(lin, F.leaky_relu(x, slope))


class RNAEncoder(nn.Module):
    def __init__(self, cfg: VAEModelConfig, device=None):
        super().__init__()
        layers = [Dropout(cfg.dropout_rate)]
        fan_in = cfg.rna_features
        for width in cfg.encoder_dims:
            layers.append(_block(fan_in, width, cfg.leaky_slope, device))
            fan_in = width
        self.encoder = nn.Sequential(*layers)
        self.slope = cfg.leaky_slope

    def forward(self, x: torch.Tensor, dt: torch.dtype = torch.float32,
                keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, seed=None) -> torch.Tensor:
        x = self.encoder[0](x.to(dt), keep, generator, seed)
        for block in self.encoder[1:]:
            x = _apply_block(block, x, dt, self.slope)
        return x


class BetaVAE(nn.Module):
    """beta-VAE (reference ``betaVAE.py:63-143``). Weights are drawn from
    ``seed`` with torch's default Linear init."""

    def __init__(self, cfg: VAEModelConfig, *, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = RNAEncoder(cfg, device)
        z_in = cfg.encoder_dims[-1]
        self.z_mu = nn.Linear(z_in, cfg.z_dim, device=device)
        self.z_logvar = nn.Linear(z_in, cfg.z_dim, device=device)
        blocks = []
        fan_in = cfg.z_dim
        for width in cfg.decoder_dims:
            blocks.append(_block(fan_in, width, cfg.leaky_slope, device))
            fan_in = width
        blocks.append(nn.Sequential(nn.Linear(fan_in, cfg.rna_features, device=device), nn.Tanh()))
        self.decoder = nn.Sequential(*blocks)
        self._init_weights(seed)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        # torch's Linear default (kaiming_uniform a=sqrt(5)): U(+-1/sqrt(fan_in))
        gen = None
        for m in self.modules():
            if isinstance(m, nn.Linear):
                if gen is None:
                    gen = torch.Generator(device=m.weight.device).manual_seed(seed)
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=gen)
                m.bias.uniform_(-bound, bound, generator=gen)

    @property
    def _dt(self) -> torch.dtype:
        return compute_dtype(self.cfg.compute_dtype)

    def encode(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None, seed=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns ``(z_mean, z_logvar, x_encoded)`` (reference ``betaVAE.py:102-107``).
        In train mode the input dropout takes ``keep`` or draws it from
        ``seed`` or ``generator``."""
        dt = self._dt
        x_encoded = self.encoder(x, dt, keep, generator, seed)
        z_mean = _whole(self.z_mu, _linear(self.z_mu, x_encoded, dt)).float()
        z_logvar = _whole(self.z_logvar, _linear(self.z_logvar, x_encoded, dt)).float()
        return z_mean, z_logvar, x_encoded

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        dt = self._dt
        x = z.to(dt)
        for block in self.decoder[:-1]:
            x = _apply_block(block, x, dt, self.cfg.leaky_slope)
        out = self.decoder[-1][0]
        return _whole(out, torch.tanh(_linear(out, x, dt))).float()

    @staticmethod
    def reparametrize(z_mean: torch.Tensor, z_logvar: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``z_mean + eps * exp(0.5 * z_logvar)``, ``eps`` given or drawn
        standard normal from ``generator``."""
        std = torch.exp(0.5 * z_logvar)
        if eps is None:
            eps = torch.randn(std.shape, generator=generator, device=std.device, dtype=std.dtype)
        return z_mean + eps.to(std.device, std.dtype) * std

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                keep: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None, seeds=None):
        """``(x_recons, z_mean, z_logvar)``. The reference reparametrizes in
        eval mode too (``betaVAE.py:109-115``). What is not given is drawn:
        with ``seeds`` = (mask seed, eps seed), each from its own seed
        (:func:`draw_keep`, :func:`draw_eps`); else from ``generator``, the
        dropout mask (train mode) first, then ``eps``."""
        mask_seed, eps_seed = seeds if seeds is not None else (None, None)
        z_mean, z_logvar, _ = self.encode(x, keep, generator, mask_seed)
        if eps is None and eps_seed is not None:
            eps = draw_eps(eps_seed, z_mean.shape, z_mean.device)
        z = self.reparametrize(z_mean, z_logvar, generator, eps)
        return self.decode(z), z_mean, z_logvar

    def sample(self, z: torch.Tensor, interpolation: Optional[torch.Tensor] = None,
               alpha: float = 1.0) -> torch.Tensor:
        """Decode latents, optionally offset along an interpolation direction
        (reference ``betaVAE.py:117-140``); call in eval mode."""
        if interpolation is not None:
            z = z + alpha * interpolation
        return self.decode(z)
