"""Serving path for tile synthesis (port of ``rnagan_tpu/eval/serving.py``).

At inference the generator's BatchNorms use fixed running statistics, so each
(ConvTranspose -> BN) pair folds into one ConvTranspose with a rescaled
kernel and a bias::

    y = scale * (conv(x) - mean) / sqrt(var + eps) + bias
      = conv'(x) + bias'    with  k' = k * g,  bias' = bias - g * mean,
                                   g = scale / sqrt(var + eps)

The fold runs in float64. A torch ConvTranspose2d weight is (in, out, kH, kW),
so the per-output-channel factor ``g`` runs along axis 1.

``make_serving_fn`` returns ``fn(noise)`` whose output keeps the JAX
package's NHWC layout at this public boundary: uint8 through the fused
tanh->uint8 kernel (``kernels/quantize.py``), or float32 in [-1, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from rnagan_tpu_torch.core.config import GANModelConfig
from rnagan_tpu_torch.core.device import resolve_device
from rnagan_tpu_torch.kernels.quantize import tanh_to_uint8
from rnagan_tpu_torch.models.dcgan import DCGANGenerator, num_repeats


def fold_generator(cfg: GANModelConfig, g_state_dict: Dict[str, torch.Tensor]):
    """Fold every ConvTranspose+BN pair of a ``dcgan`` generator state_dict.
    Returns ``(folded_cfg, folded_state_dict)``: a ``batchnorm=False`` config
    and float32 weights with biases, equal to the eval-mode original."""
    if not cfg.batchnorm:
        return cfg, dict(g_state_dict)
    r = num_repeats(cfg.out_size)
    folded = {}
    for b in range(r + 1):  # every ConvTranspose but the last has a BN after it
        bn = f"model.{b}.1."
        g = (g_state_dict[bn + "weight"].double()
             / torch.sqrt(g_state_dict[bn + "running_var"].double() + 1e-5))
        k = g_state_dict[f"model.{b}.0.weight"].double() * g[None, :, None, None]
        bias = g_state_dict[bn + "bias"].double() - g * g_state_dict[bn + "running_mean"].double()
        conv_bias = g_state_dict.get(f"model.{b}.0.bias")
        if conv_bias is not None:
            bias = bias + g * conv_bias.double()
        folded[f"model.{b}.0.weight"] = k.float()
        folded[f"model.{b}.0.bias"] = bias.float()
    for key in (f"model.{r + 1}.0.weight", f"model.{r + 1}.0.bias"):
        folded[key] = g_state_dict[key].float()
    return dataclasses.replace(cfg, batchnorm=False), folded


def make_serving_fn(cfg: GANModelConfig, g_state_dict: Dict[str, torch.Tensor], *,
                    uint8_output: bool = True, quantized_head: bool = False,
                    quantized_full: bool = False,
                    device="cuda") -> Callable[[torch.Tensor], torch.Tensor]:
    """BN-folded generator on ``device``. ``fn(noise)`` maps (N, encoding_dims)
    noise to (N, H, W, C) tiles: uint8 through the tanh->uint8 kernel, or
    float32 in [-1, 1]."""
    if quantized_head:
        raise NotImplementedError("quantized_head needs the int8 matmul kernel (ROADMAP B4)")
    if quantized_full:
        raise NotImplementedError("quantized_full W8A8 serving is not ported yet (ROADMAP A5)")
    dev = resolve_device(device)
    folded_cfg, folded = fold_generator(cfg, g_state_dict)
    gen = DCGANGenerator(folded_cfg, final_tanh=False, device=dev)
    gen.load_state_dict(folded)
    gen.eval().requires_grad_(False)

    @torch.inference_mode()
    def fn(noise: torch.Tensor) -> torch.Tensor:
        pre = gen(noise.to(dev, torch.float32))  # (N, C, H, W) float32, pre-tanh
        if uint8_output:
            return tanh_to_uint8(pre)
        return torch.tanh(pre).permute(0, 2, 3, 1).contiguous()

    fn.generator = gen
    return fn
