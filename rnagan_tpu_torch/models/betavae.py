"""beta-VAE over RNA-seq expression vectors (port of ``rnagan_tpu/models/betavae.py``).

Module tree and state_dict keys are the reference torch model's
(``betaVAE.py:63-94``), the layout ``params_to_torch_state_dict`` writes:

* ``encoder.encoder.0`` Dropout, then ``encoder.encoder.{i+1}`` =
  (Linear ``.0``, BatchNorm1d ``.1``, LeakyReLU) per encoder width;
* ``z_mu`` and ``z_logvar`` heads;
* ``decoder.{i}`` = (Linear, BatchNorm1d, LeakyReLU) per decoder width, then
  ``decoder.{n}`` = (Linear, Tanh).

So reference ``.pt`` checkpoints load unchanged. BatchNorm eps is 1e-5 and
torch momentum 0.1 (flax momentum 0.9); LeakyReLU slope 0.01.

Parameters stay float32; ``cfg.compute_dtype="bfloat16"`` runs the layers in
bfloat16 on cast copies of the weights and returns float32 latents, as the
JAX model does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rnagan_tpu_torch.core.config import VAEModelConfig
from rnagan_tpu_torch.core.device import compute_dtype


def _block(fan_in: int, width: int, slope: float, device) -> nn.Sequential:
    return nn.Sequential(nn.Linear(fan_in, width, device=device),
                         nn.BatchNorm1d(width, eps=1e-5, momentum=0.1, device=device),
                         nn.LeakyReLU(slope))


def _apply_block(block: nn.Sequential, x: torch.Tensor, dt: torch.dtype, slope: float) -> torch.Tensor:
    lin, bn = block[0], block[1]
    x = F.linear(x, lin.weight.to(dt), lin.bias.to(dt))
    if bn.training and dt != torch.float32:
        raise NotImplementedError("bfloat16 BatchNorm training waits for VAE training (ROADMAP A9)")
    # .to() of a float32 buffer at float32 is the buffer itself, so training
    # mode updates the running statistics in place
    x = F.batch_norm(x, bn.running_mean.to(dt), bn.running_var.to(dt), bn.weight.to(dt),
                     bn.bias.to(dt), bn.training, bn.momentum, bn.eps)
    return F.leaky_relu(x, slope)


class RNAEncoder(nn.Module):
    def __init__(self, cfg: VAEModelConfig, device=None):
        super().__init__()
        layers = [nn.Dropout(cfg.dropout_rate)]
        fan_in = cfg.rna_features
        for width in cfg.encoder_dims:
            layers.append(_block(fan_in, width, cfg.leaky_slope, device))
            fan_in = width
        self.encoder = nn.Sequential(*layers)
        self.slope = cfg.leaky_slope

    def forward(self, x: torch.Tensor, dt: torch.dtype = torch.float32) -> torch.Tensor:
        x = self.encoder[0](x.to(dt))
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

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns ``(z_mean, z_logvar, x_encoded)`` (reference ``betaVAE.py:102-107``)."""
        dt = self._dt
        x_encoded = self.encoder(x, dt)
        z_mean = F.linear(x_encoded, self.z_mu.weight.to(dt), self.z_mu.bias.to(dt)).float()
        z_logvar = F.linear(x_encoded, self.z_logvar.weight.to(dt), self.z_logvar.bias.to(dt)).float()
        return z_mean, z_logvar, x_encoded

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        dt = self._dt
        x = z.to(dt)
        for block in self.decoder[:-1]:
            x = _apply_block(block, x, dt, self.cfg.leaky_slope)
        out = self.decoder[-1][0]
        return torch.tanh(F.linear(x, out.weight.to(dt), out.bias.to(dt))).float()

    @staticmethod
    def reparametrize(z_mean: torch.Tensor, z_logvar: torch.Tensor,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        std = torch.exp(0.5 * z_logvar)
        eps = torch.randn(std.shape, generator=generator, device=std.device, dtype=std.dtype)
        return z_mean + eps * std

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """The reference reparametrizes in eval mode too (``betaVAE.py:109-115``)."""
        z_mean, z_logvar, _ = self.encode(x)
        z = self.reparametrize(z_mean, z_logvar, generator)
        return self.decode(z), z_mean, z_logvar

    def sample(self, z: torch.Tensor, interpolation: Optional[torch.Tensor] = None,
               alpha: float = 1.0) -> torch.Tensor:
        """Decode latents, optionally offset along an interpolation direction
        (reference ``betaVAE.py:117-140``); call in eval mode."""
        if interpolation is not None:
            z = z + alpha * interpolation
        return self.decode(z)
