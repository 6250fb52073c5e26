"""The DCGAN generator and discriminator and the β-VAE as plain float32 functions.

Parameters are dicts keyed by the state_dict names of the published models
(torchgan's ``nn.Sequential`` layout for the DCGAN, ``src/betaVAE.py``'s for
the β-VAE), so one set of weights loads into the program and feeds these
functions. BatchNorm has the semantics the program states (flax's, momentum
0.9): train mode normalizes with the biased batch statistics,
``var = max(E[x^2] - E[x]^2, 0)``, and returns the running statistics
``0.9 * old + 0.1 * batch``; eval mode normalizes with the running ones.

``q`` rounds the operands of every convolution and matrix product (inputs
and weights) before the float32 product: the identity for the reference,
:func:`fp8_operands` or :func:`tf32_operands` for the lower-precision
controls. Its backward passes the gradient through unchanged.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Stats = List[Tuple[torch.Tensor, torch.Tensor]]
Round = Callable[[torch.Tensor], torch.Tensor]

BN_EPS = 1e-5
MOMENTUM = 0.9


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


class _Rounded(torch.autograd.Function):
    """``fn(x)`` forward, the identity backward (a straight-through rounding)."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x.detach())

    @staticmethod
    def backward(ctx, g):
        return g, None


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def fp8_operands(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale that maps its largest magnitude to 448."""
    return _Rounded.apply(t, _fp8)


def tf32_operands(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32's 10 mantissa bits (to nearest, ties away from zero)."""
    return _Rounded.apply(t, _tf32)


def bn_train(x, scale, bias, mean, var):
    axes = [0, *range(2, x.ndim)]
    m = x.mean(axes)
    v = torch.clamp((x * x).mean(axes) - m * m, min=0.0)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (x - m.reshape(shape)) * (torch.rsqrt(v + BN_EPS) * scale).reshape(shape) + bias.reshape(shape)
    return y, ((MOMENTUM * mean + (1.0 - MOMENTUM) * m).detach(), (MOMENTUM * var + (1.0 - MOMENTUM) * v).detach())


def bn_eval(x, scale, bias, mean, var):
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return (x - mean.reshape(shape)) * (torch.rsqrt(var + BN_EPS) * scale).reshape(shape) + bias.reshape(shape)


def _bn(x, p, prefix, stats, k, train, new):
    if train:
        x, s = bn_train(x, p[prefix + "weight"], p[prefix + "bias"], *stats[k])
        new.append(s)
        return x
    return bn_eval(x, p[prefix + "weight"], p[prefix + "bias"], *stats[k])


# ------------------------------------------------------------------ DCGAN


def repeats(out_size: int) -> int:
    return out_size.bit_length() - 4


def dcgan_specs(m: dict) -> Tuple[list, list]:
    """``(params, stats)`` of the DCGAN generator and discriminator of the
    configuration ``m``: params as ``(net, name, shape, kind)`` in the
    modules' order, kinds ``conv``, ``bn_scale``, ``bn_bias``, ``bias``;
    stats as ``(net, prefix, channels)``."""
    r, step = repeats(m["out_size"]), m["step_channels"]
    d = step * 2 ** r
    params, stats = [], []
    g = [("model.0.0.weight", (m["encoding_dims"], d, 4, 4), "conv")]
    g_stats = [d]
    c = d
    for i in range(1, r + 1):
        g.append((f"model.{i}.0.weight", (c, c // 2, 4, 4), "conv"))
        c //= 2
        g_stats.append(c)
    bns = [(f"model.{i}.1.", ch) for i, ch in enumerate(g_stats)]
    ordered = []
    for (name, shape, kind), (prefix, ch) in zip(g, bns):
        ordered += [(name, shape, kind), (prefix + "weight", (ch,), "bn_scale"), (prefix + "bias", (ch,), "bn_bias")]
    ordered += [(f"model.{r + 1}.0.weight", (step, m["out_channels"], 4, 4), "conv"),
                (f"model.{r + 1}.0.bias", (m["out_channels"],), "bias")]
    params += [("G", *t) for t in ordered]
    stats += [("G", prefix, ch) for prefix, ch in bns]
    dl = [("model.0.0.weight", (step, m["out_channels"], 4, 4), "conv"), ("model.0.0.bias", (step,), "bias")]
    c = step
    for i in range(1, r + 1):
        dl += [(f"model.{i}.0.weight", (2 * c, c, 4, 4), "conv"), (f"model.{i}.1.weight", (2 * c,), "bn_scale"),
               (f"model.{i}.1.bias", (2 * c,), "bn_bias")]
        stats.append(("D", f"model.{i}.1.", 2 * c))
        c *= 2
    dl += [(f"model.{r + 1}.0.weight", (1, c, 4, 4), "conv"), (f"model.{r + 1}.0.bias", (1,), "bias")]
    params += [("D", *t) for t in dl]
    return params, stats


def generator(p: Params, stats: Stats, z: torch.Tensor, train: bool, m: dict,
              q: Round = identity) -> Tuple[torch.Tensor, Stats]:
    """z (N, encoding_dims) -> the pre-tanh map (N, C, H, W) and the new statistics."""
    r, slope = repeats(m["out_size"]), m["leaky_slope"]
    x = z[:, :, None, None]
    new: Stats = []
    for i in range(r + 2):
        w = p[f"model.{i}.0.weight"]
        stride, pad = (1, 0) if i == 0 else (2, 1)
        x = F.conv_transpose2d(q(x), q(w), p.get(f"model.{i}.0.bias"), stride, pad)
        if i == r + 1:
            break
        x = F.leaky_relu(_bn(x, p, f"model.{i}.1.", stats, i, train, new), slope)
    return x, new


def discriminator(p: Params, stats: Stats, x: torch.Tensor, train: bool, m: dict,
                  q: Round = identity) -> Tuple[torch.Tensor, Stats]:
    """images (N, C, H, W) in [-1, 1] -> scores (N,) and the new statistics."""
    r, slope = repeats(m["out_size"]), m["leaky_slope"]
    new: Stats = []
    for i in range(r + 2):
        stride, pad = (1, 0) if i == r + 1 else (2, 1)
        x = F.conv2d(q(x), q(p[f"model.{i}.0.weight"]), p.get(f"model.{i}.0.bias"), stride, pad)
        if i == r + 1:
            break
        if i > 0:
            x = _bn(x, p, f"model.{i}.1.", stats, i - 1, train, new)
        x = F.leaky_relu(x, slope)
    score = x.reshape(x.shape[0])
    return (F.leaky_relu(score, slope) if m.get("disc_last_leaky", True) else score), new


# ------------------------------------------------------------------ β-VAE


def vae_specs(m: dict) -> Tuple[list, list]:
    """``(params, stats)`` of the β-VAE of ``m``: params ``(name, shape,
    kind, fan_in)`` in ``parameters()`` order (kinds ``linear_w``,
    ``linear_b``, ``bn_scale``, ``bn_bias``), stats ``(prefix, width)``."""
    params, stats = [], []

    def block(prefix, fan_in, width):
        params.extend([(prefix + "0.weight", (width, fan_in), "linear_w", fan_in),
                       (prefix + "0.bias", (width,), "linear_b", fan_in),
                       (prefix + "1.weight", (width,), "bn_scale", fan_in),
                       (prefix + "1.bias", (width,), "bn_bias", fan_in)])
        stats.append((prefix + "1.", width))

    fan_in = m["rna_features"]
    for i, width in enumerate(m["encoder_dims"]):
        block(f"encoder.encoder.{i + 1}.", fan_in, width)
        fan_in = width
    for head in ("z_mu.", "z_logvar."):
        params.extend([(head + "weight", (m["z_dim"], fan_in), "linear_w", fan_in),
                       (head + "bias", (m["z_dim"],), "linear_b", fan_in)])
    fan_in = m["z_dim"]
    for i, width in enumerate(m["decoder_dims"]):
        block(f"decoder.{i}.", fan_in, width)
        fan_in = width
    last = f"decoder.{len(m['decoder_dims'])}.0."
    params.extend([(last + "weight", (m["rna_features"], fan_in), "linear_w", fan_in),
                   (last + "bias", (m["rna_features"],), "linear_b", fan_in)])
    return params, stats


def _linear(p, prefix, x, q):
    return F.linear(q(x), q(p[prefix + "weight"]), p[prefix + "bias"])


def vae_encode(p: Params, stats: Stats, x: torch.Tensor, train: bool, m: dict,
               keep: Optional[torch.Tensor] = None, q: Round = identity, logvar: bool = True):
    """``(z_mean, z_logvar, new_stats)``; train mode applies the dropout mask ``keep``."""
    slope = m.get("leaky_slope", 0.01)
    if train and keep is not None:
        rate = m["dropout_rate"]
        x = torch.where(keep, x / torch.full((), 1.0 - rate, device=x.device), torch.zeros((), device=x.device))
    new: Stats = []
    for i in range(len(m["encoder_dims"])):
        prefix = f"encoder.encoder.{i + 1}."
        x = F.leaky_relu(_bn(_linear(p, prefix + "0.", x, q), p, prefix + "1.", stats, i, train, new), slope)
    z_mean = _linear(p, "z_mu.", x, q)
    z_logvar = _linear(p, "z_logvar.", x, q) if logvar else None
    return z_mean, z_logvar, new


def vae_decode(p: Params, stats: Stats, z: torch.Tensor, train: bool, m: dict, q: Round = identity):
    slope = m.get("leaky_slope", 0.01)
    k0 = len(m["encoder_dims"])
    new: Stats = []
    x = z
    for i in range(len(m["decoder_dims"])):
        prefix = f"decoder.{i}."
        x = F.leaky_relu(_bn(_linear(p, prefix + "0.", x, q), p, prefix + "1.", stats, k0 + i, train, new), slope)
    return torch.tanh(_linear(p, f"decoder.{len(m['decoder_dims'])}.0.", x, q)), new


def z_mean_eval(p: Params, stats: Stats, x: torch.Tensor, m: dict, q: Round = identity,
                rows: int = 1024) -> torch.Tensor:
    """The frozen encoder's latent mean in eval mode, in blocks of ``rows``."""
    with torch.no_grad():
        return torch.cat([vae_encode(p, stats, x[s:s + rows], False, m, q=q, logvar=False)[0]
                          for s in range(0, len(x), rows)])


def stats_list(sd: Params, prefixes: Sequence[str]) -> Stats:
    return [(sd[pre + "running_mean"], sd[pre + "running_var"]) for pre in prefixes]
