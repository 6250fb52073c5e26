"""DCGAN generator (port of ``DCGANGenerator`` in ``rnagan_tpu/models/dcgan.py``).

torchgan's ``nn.Sequential`` layout, so ``model.<block>.0|1`` keys match the
``.model`` bundles the JAX package exports (``models/dcgan_torch.py``):

* block 0: ``ConvTranspose2d(z, d, 4, 1, 0)`` on the 1x1 noise map, BN, LeakyReLU;
* blocks 1..r: ``ConvTranspose2d(c, c/2, 4, 2, 1)``, BN, LeakyReLU;
* block r+1: ``ConvTranspose2d(step, out_channels, 4, 2, 1)`` with a bias.

``r = out_size.bit_length() - 4`` (5 at 256x256: channels 2048 -> 1024 ->
... -> 64 -> 3). Without BatchNorm (``cfg.batchnorm=False``, the BN-folded
serving form) every conv carries a bias. A stride-2 ``ConvTranspose2d`` with
padding 1 equals flax's ``padding="SAME"`` once the kernel is flipped in
transit (``convert.py``). Layout is NCHW; the serving path turns the output
into the JAX package's NHWC at its egress (``eval/serving.py``).

Parameters stay float32; ``cfg.compute_dtype`` names the compute type (cast
copies of the weights, float32 output), as ``dcgan_lax_apply`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rnagan_tpu_torch.core.config import GANModelConfig
from rnagan_tpu_torch.core.device import compute_dtype

#: architectures of ``make_generator`` that later slices port, by ROADMAP item
_LATER = {"dcgan_up": "A4", "condgan": "A4", "sagan": "A13", "biggan": "A13"}


def num_repeats(size: int) -> int:
    if size < 16 or (size & (size - 1)) != 0:
        raise ValueError("image size must be >= 16 and a power of 2")
    return size.bit_length() - 4


def _require_dcgan(cfg: GANModelConfig) -> None:
    if cfg.arch in _LATER:
        raise NotImplementedError(
            f"arch={cfg.arch!r} is not ported yet (ROADMAP {_LATER[cfg.arch]}); only 'dcgan' is")
    if cfg.arch != "dcgan":
        raise ValueError(f"unknown gan arch: {cfg.arch}")


class DCGANGenerator(nn.Module):
    """z (N, encoding_dims) -> images (N, out_channels, out_size, out_size).

    Weights are drawn from ``seed``: convs N(0, 0.02), BN scale N(1, 0.02),
    biases zero (``models/dcgan.py:45-49``). ``final_tanh=False`` returns the
    pre-tanh map, for the fused uint8 egress."""

    def __init__(self, cfg: GANModelConfig, *, final_tanh: bool = True, seed: int = 0, device=None):
        super().__init__()
        _require_dcgan(cfg)
        self.cfg = cfg
        self.final_tanh = final_tanh
        r = num_repeats(cfg.out_size)
        d = cfg.step_channels * 2**r
        blocks = [self._block(cfg.encoding_dims, d, 1, 0, device)]
        for _ in range(r):
            blocks.append(self._block(d, d // 2, 2, 1, device))
            d //= 2
        blocks.append(nn.Sequential(
            nn.ConvTranspose2d(d, cfg.out_channels, 4, 2, 1, bias=True, device=device)))
        self.model = nn.Sequential(*blocks)
        self._init_weights(seed)

    def _block(self, cin: int, cout: int, stride: int, pad: int, device) -> nn.Sequential:
        bn = self.cfg.batchnorm
        layers = [nn.ConvTranspose2d(cin, cout, 4, stride, pad, bias=not bn, device=device)]
        if bn:
            layers.append(nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1, device=device))
        layers.append(nn.LeakyReLU(self.cfg.leaky_slope))
        return nn.Sequential(*layers)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        gen = None
        for m in self.modules():
            if isinstance(m, (nn.ConvTranspose2d, nn.BatchNorm2d)):
                if gen is None:
                    gen = torch.Generator(device=m.weight.device).manual_seed(seed)
                m.weight.normal_(1.0 if isinstance(m, nn.BatchNorm2d) else 0.0, 0.02, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.cfg.compute_dtype)
        x = z.to(dt)[:, :, None, None]
        last = len(self.model) - 1
        for i, block in enumerate(self.model):
            conv = block[0]
            bias = None if conv.bias is None else conv.bias.to(dt)
            x = F.conv_transpose2d(x, conv.weight.to(dt), bias, conv.stride, conv.padding)
            if i == last:
                break
            if self.cfg.batchnorm:
                bn = block[1]
                if bn.training and dt != torch.float32:
                    raise NotImplementedError(
                        "bfloat16 BatchNorm training waits for GAN training (ROADMAP A8)")
                # float32 .to() returns the buffers themselves: training mode
                # updates the running statistics in place
                x = F.batch_norm(x, bn.running_mean.to(dt), bn.running_var.to(dt),
                                 bn.weight.to(dt), bn.bias.to(dt), bn.training, bn.momentum, bn.eps)
            x = F.leaky_relu(x, self.cfg.leaky_slope)
        x = x.float()
        return torch.tanh(x) if self.final_tanh else x
