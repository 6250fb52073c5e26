"""Seeded initial weights, made on the device in a few large calls.

The benchmark makes the weights and hands the same tensors to the program and
(made again from the seed after the window) to the reference. One flat normal
draw covers every DCGAN tensor (convolutions N(0, 0.02), BatchNorm scales
N(1, 0.02), biases zero: the DCGAN initialization the paper's torchgan models
use); one flat uniform draw covers the β-VAE (``nn.Linear``'s default,
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases; BatchNorm scale 1,
bias 0). Running statistics start at mean 0, variance 1.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.reference.nets import dcgan_specs, vae_specs


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def dcgan_weights(m: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"G": state_dict, "D": state_dict}`` of the DCGAN of ``m`` (params and BatchNorm buffers)."""
    params, stats = dcgan_specs(m)
    total = sum(math.prod(shape) for _, _, shape, _ in params)
    flat = torch.empty(total, device=device).normal_(0.0, 0.02, generator=_generator(seed, device))
    out: Dict[str, Dict[str, torch.Tensor]] = {"G": {}, "D": {}}
    at = 0
    for net, name, shape, kind in params:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if kind == "bn_scale":
            t.add_(1.0)
        elif kind in ("bn_bias", "bias"):
            t.zero_()
        out[net][name] = t
    for net, prefix, ch in stats:
        out[net][prefix + "running_mean"] = torch.zeros(ch, device=device)
        out[net][prefix + "running_var"] = torch.ones(ch, device=device)
        out[net][prefix + "num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)
    return out


def vae_weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The β-VAE's state_dict (params and BatchNorm buffers) of ``m``."""
    params, stats = vae_specs(m)
    total = sum(math.prod(shape) for _, shape, _, _ in params)
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0, generator=_generator(seed, device))
    sd: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, kind, fan_in in params:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if kind in ("linear_w", "linear_b"):
            t.mul_(1.0 / math.sqrt(fan_in))
        elif kind == "bn_scale":
            t.fill_(1.0)
        else:
            t.zero_()
        sd[name] = t
    for prefix, width in stats:
        sd[prefix + "running_mean"] = torch.zeros(width, device=device)
        sd[prefix + "running_var"] = torch.ones(width, device=device)
        sd[prefix + "num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)
    return sd


@torch.no_grad()
def load_into(module: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Copy ``sd`` into ``module``'s parameters and buffers by name (every one of them)."""
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    missing = set(own) ^ set(sd)
    if missing:
        raise KeyError(f"weights and module differ in {sorted(missing)[:6]}")
    for name, t in own.items():
        t.copy_(sd[name])


@torch.no_grad()
def calibrate_generator(g_sd: Dict[str, torch.Tensor], m: dict, noise: torch.Tensor) -> None:
    """Set the generator's running statistics to the batch statistics of its
    train-mode pass over ``noise`` (float32), layer by layer, so that an eval
    pass normalizes its activations as a trained generator's would."""
    from perfbench.reference.nets import bn_eval, repeats
    import torch.nn.functional as F

    r = repeats(m["out_size"])
    x = noise[:, :, None, None]
    for i in range(r + 1):
        stride, pad = (1, 0) if i == 0 else (2, 1)
        x = F.conv_transpose2d(x, g_sd[f"model.{i}.0.weight"], None, stride, pad)
        prefix = f"model.{i}.1."
        mean = x.mean((0, 2, 3))
        g_sd[prefix + "running_mean"].copy_(mean)
        g_sd[prefix + "running_var"].copy_(torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0))
        x = F.leaky_relu(bn_eval(x, g_sd[prefix + "weight"], g_sd[prefix + "bias"], g_sd[prefix + "running_mean"],
                                 g_sd[prefix + "running_var"]), m["leaky_slope"])
