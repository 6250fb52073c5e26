"""SAGAN, the self-attention GAN family (port of ``rnagan_tpu/models/sagan.py``).

The DCGAN topology of :mod:`rnagan_tpu_torch.models.dcgan` with spectral
normalization on every convolution and one self-attention block at
``GANModelConfig.attn_size`` in both nets. The discriminator has no
BatchNorm: spectral norm conditions it.

**Spectral norm** is flax 0.12's ``nn.SpectralNorm`` (one power-iteration
step, epsilon 1e-12), written out (:func:`spectral_norm`):

* the kernel is read as flax holds it, reshaped to ``(-1, out_features)``;
* ``v = l2n(u W^T)``, ``u' = l2n(v W)`` with ``l2n(x) = x * rsqrt(sum(x^2) +
  eps)``, both without gradient; ``sigma = v W u'^T`` keeps its gradient in
  ``W``; the kernel used is ``W / sigma`` (``W`` when ``sigma`` is 0);
* vectors (biases) are left alone;
* the iteration runs on every forward, eval mode too. Train mode returns
  ``(u', sigma)`` as the layer's new state, eval mode its old state; the
  stored ``sigma`` never normalizes anything.

``torch.nn.utils.spectral_norm`` differs on each point (it skips the
iteration in eval, divides by ``max(norm, eps)``, reshapes out-first, keeps
``v``, draws ``u`` from the global generator), so it is not used.

State: each BatchNorm's ``(running_mean, running_var)`` and each spectral
norm's ``(sn_u, sn_sigma)`` (buffers of the normalized layer) form one list of
pairs in module order, the ``Stats`` the trainer threads (the JAX package
keeps both in ``batch_stats``). A forward takes that list and returns the
new one, as ``models/batchnorm.py`` does: nothing is written in place.

**Attention** (``SelfAttention2d``): 1x1 convs theta and phi to C/8, g to
C/2 (each floored at 1), phi and g 2x2 max-pooled (``_MaxPool2``: the
library pool, whose backward records no dependence on its input); logits a
product in the compute dtype, cast to float32; softmax in float32, cast
back; an output 1x1 conv back to C; ``x + gamma * o`` with a float32 scalar
``gamma`` that starts at 0. It is written with ``torch.bmm`` and ``softmax``
to keep the JAX package's rounding points (its einsums are XLA, not a Pallas
kernel). Each call is the device stage ``gan_attn`` inside the stage that
runs it (``core/profiling.py::nested``) and adds 1 to the counter
``gan.attn_calls``.

Counters (``core/profiling.py``): a training forward adds 1 to ``gan.layers``
for each weight it reads through ``Walk.weight`` or ``Walk.dense`` (the
convolutions and linear maps; in ``biggan_pub`` also the critic's projection
embedding), and 1 to ``gan.sn_layers`` for each of those it normalizes
spectrally. A class embedding looked up as a plain table counts in neither.

Module names follow the flax tree (``ConvTranspose_i``, ``_BN_i``,
``Conv_i``, ``Attention_<size>.{theta,phi,g,o}``), so
:func:`flax_source` maps each state_dict key to its flax leaf
(``convert.py``). Layout is NCHW; parameters stay float32 and
``cfg.compute_dtype`` names the compute type.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rnagan_tpu_torch.core import profiling
from rnagan_tpu_torch.core.config import GANModelConfig
from rnagan_tpu_torch.core.device import compute_dtype
from rnagan_tpu_torch.models.batchnorm import Stats, batch_norm
from rnagan_tpu_torch.models.dcgan import ArchTraits, cast_weight, check_arch, num_repeats

SN_EPS = 1e-12


def l2_normalize(x: torch.Tensor, eps: float = SN_EPS) -> torch.Tensor:
    """flax's ``_l2_normalize``: ``x * rsqrt(sum(x^2) + eps)`` over all elements."""
    return x * torch.rsqrt((x * x).sum() + eps)


def _kind(m: nn.Module) -> str:
    if isinstance(m, nn.ConvTranspose2d):
        return "convt"
    if isinstance(m, nn.Conv2d):
        return "conv"
    return "dense"


def flax_matrix(weight: torch.Tensor, kind: str) -> torch.Tensor:
    """A torch weight as flax's kernel reshaped to ``(-1, out)``, rows in
    flax's order: Conv2d (out, in, kh, kw) from HWIO; ConvTranspose2d (in,
    out, kh, kw) from HWIO, flipped (``convert.convt_kernel_to_torch``);
    Linear (out, in) from (in, out)."""
    if kind == "conv":
        w = weight.permute(2, 3, 1, 0)
    elif kind == "convt":
        w = weight.flip(2, 3).permute(2, 3, 0, 1)
    else:
        w = weight.t()
    return w.reshape(-1, w.shape[-1])


def spectral_norm(weight: torch.Tensor, u: torch.Tensor,
                  kind: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """flax ``nn.SpectralNorm`` on one float32 kernel: ``(weight / sigma,
    new u, sigma)``. ``u`` is (1, out); the new ``u`` and ``sigma`` carry no
    gradient, the normalized weight does (through ``sigma`` too)."""
    w = flax_matrix(weight, kind)
    with torch.no_grad():
        v = l2_normalize(u @ w.t())
    vw = v @ w
    u_new = l2_normalize(vw.detach())
    sigma = (vw @ u_new.t())[0, 0]
    return weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma)), u_new, sigma.detach()


def sn_layer(layer: nn.Module) -> nn.Module:
    """Give ``layer`` its spectral-norm state: buffers ``sn_u`` (1, out),
    drawn at init, and ``sn_sigma`` (), 1 at init."""
    out = layer.weight.shape[1 if isinstance(layer, nn.ConvTranspose2d) else 0]
    dev = layer.weight.device
    layer.register_buffer("sn_u", torch.zeros(1, out, device=dev))
    layer.register_buffer("sn_sigma", torch.ones((), device=dev))
    return layer


def _is_state(m: nn.Module) -> bool:
    return isinstance(m, nn.BatchNorm2d) or hasattr(m, "sn_u")


class Walk:
    """One forward's view of a net: its parameters (or ``params`` given in
    their place), the incoming state pairs, and the new ones it produces."""

    def __init__(self, net: "SNNet", stats: Stats, train: bool,
                 params: Optional[Sequence[torch.Tensor]] = None):
        p = dict(net.named_parameters())
        self.p = p if params is None else dict(zip(p, params, strict=True))
        self.stats, self.train = stats, train
        self.dt = compute_dtype(net.cfg.compute_dtype)
        self.new: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def child(self) -> "Walk":
        """The same view with no updates of its own (a recomputed block's)."""
        c = copy.copy(self)
        c.new = {}
        return c

    def result(self) -> Stats:
        return [self.new.get(k, s) for k, s in enumerate(self.stats)]

    def param(self, m: nn.Module, name: str) -> torch.Tensor:
        return self.p[f"{m.qualname}.{name}" if m.qualname else name]

    def weight(self, m: nn.Module, layout: torch.memory_format = torch.contiguous_format) -> torch.Tensor:
        """``m``'s weight, spectrally normalized, in the compute dtype and
        ``layout`` (``dcgan.cast_weight``: a channels-last weight is one copy)."""
        u, sigma = self.stats[m.slot]
        w, u_new, s_new = self.normalize(self.param(m, "weight"), u, m)
        self.new[m.slot] = (u_new, s_new) if self.train else (u, sigma)
        if self.train:
            profiling.count("gan.layers", 1)
            profiling.count("gan.sn_layers", 1)
        return cast_weight(w, self.dt, layout)

    def normalize(self, weight: torch.Tensor, u: torch.Tensor,
                  m: nn.Module) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(weight / sigma, new u, sigma)``: flax's spectral norm."""
        return spectral_norm(weight, u, _kind(m))

    def bias(self, m: nn.Module) -> Optional[torch.Tensor]:
        return None if m.bias is None else self.param(m, "bias").to(self.dt)

    def conv(self, m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight(m), self.bias(m), m.stride, m.padding)

    def convt(self, m: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight(m), self.bias(m), m.stride, m.padding)

    def dense(self, m: nn.Linear, x: torch.Tensor, sn: bool = True) -> torch.Tensor:
        if not sn and self.train:
            profiling.count("gan.layers", 1)
        w = self.weight(m) if sn else self.param(m, "weight").to(self.dt)
        return F.linear(x.to(self.dt), w, self.bias(m))

    def bn(self, m: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
        scale = self.param(m, "weight") if m.affine else None
        bias = self.param(m, "bias") if m.affine else None
        y, mean, var = batch_norm(x, scale, bias, *self.stats[m.slot], train=self.train)
        self.new[m.slot] = (mean, var)
        return y


class SNNet(ArchTraits, nn.Module):
    """What the SAGAN and BigGAN nets share: the state pairs (BatchNorm and
    spectral norm, module order), seeded init and the flax names."""

    cfg: GANModelConfig

    def _finish(self, seed: int) -> None:
        """Number the state modules, name every module, draw the weights
        (not on the ``meta`` device, which only lays a net out)."""
        self._state_modules: List[nn.Module] = [m for m in self.modules() if _is_state(m)]
        for k, m in enumerate(self._state_modules):
            m.slot = k
        for name, m in self.named_modules():
            m.qualname = name
        dev = next(self.parameters()).device
        if dev.type != "meta":
            self._init_weights(torch.Generator(device=dev).manual_seed(seed))

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        """Drawn from ``gen`` in module order: convs and Linear N(0, 0.02),
        BatchNorm scale N(1, 0.02), biases and attention ``gamma`` 0, ``sn_u``
        N(0, 1) (``models/dcgan.py:45-49``, flax ``SpectralNorm``'s ``u``)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) or (
                    isinstance(m, nn.BatchNorm2d) and m.affine):
                m.weight.normal_(1.0 if isinstance(m, nn.BatchNorm2d) else 0.0, 0.02, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            if hasattr(m, "sn_u"):
                m.sn_u.normal_(generator=gen)

    def bn_stats(self) -> Stats:
        """The state pairs in module order: ``(running_mean, running_var)``
        of a BatchNorm, ``(sn_u, sn_sigma)`` of a spectrally normalized layer."""
        return [(m.running_mean, m.running_var) if isinstance(m, nn.BatchNorm2d)
                else (m.sn_u, m.sn_sigma) for m in self._state_modules]

    @torch.no_grad()
    def load_bn_stats(self, stats: Stats) -> None:
        for (a, b), (x, y) in zip(self.bn_stats(), stats, strict=True):
            a.copy_(x)
            b.copy_(y)


class _Generator(SNNet):
    def forward(self, z: torch.Tensor, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Module mode: the state is the buffers; train mode writes the new
        state back, as flax's mutable ``batch_stats``."""
        out, new = self.forward_stats(z, self.bn_stats(), self.training, labels=labels)
        if self.training:
            self.load_bn_stats(new)
        return out


class _MaxPool2(torch.autograd.Function):
    """``F.max_pool2d(x, 2)`` whose backward, PyTorch's kernel, reads x's size
    and order but records no dependence on x. Autograd's own records one, and
    a double backward (the penalty's) turns it into a gradient of zeros for x
    in contiguous NCHW order, which a sum carries into a channels-last
    gradient. The values are the library pool's."""

    @staticmethod
    def forward(ctx, x):
        y, indices = torch.ops.aten.max_pool2d_with_indices(x, (2, 2), (2, 2))
        ctx.save_for_backward(x, indices)
        return y

    @staticmethod
    def backward(ctx, g):
        x, indices = ctx.saved_tensors
        return torch.ops.aten.max_pool2d_with_indices_backward(g, x.detach(), (2, 2), (2, 2), (0, 0), (1, 1), False,
                                                               indices)


class SelfAttention2d(nn.Module):
    """Self-attention over the H*W tokens with 2x2-pooled keys and values."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        c_qk, c_v = max(channels // 8, 1), max(channels // 2, 1)  # floors keep tiny widths valid
        conv = lambda cin, cout: sn_layer(nn.Conv2d(cin, cout, 1, bias=False, device=device))  # noqa: E731
        self.theta, self.phi, self.g = conv(channels, c_qk), conv(channels, c_qk), conv(channels, c_v)
        self.o = conv(c_v, channels)
        self.gamma = nn.Parameter(torch.zeros((), device=device))

    def attend(self, walk: Walk, x: torch.Tensor) -> torch.Tensor:
        profiling.count("gan.attn_calls", 1)
        with profiling.nested("gan_attn", x.device):
            return self._attend(walk, x)

    def _attend(self, walk: Walk, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        theta = walk.conv(self.theta, x)
        phi = _MaxPool2.apply(walk.conv(self.phi, x))
        g = _MaxPool2.apply(walk.conv(self.g, x))
        q = theta.flatten(2).transpose(1, 2)  # (N, HW, C/8), tokens in (h, w) order
        logits = torch.bmm(q, phi.flatten(2)).float()  # (N, HW, HW/4)
        attn = torch.softmax(logits, dim=-1).to(walk.dt)
        o = torch.bmm(attn, g.flatten(2).transpose(1, 2))  # (N, HW, C/2)
        o = walk.conv(self.o, o.transpose(1, 2).reshape(n, -1, h, w))
        return x + walk.param(self, "gamma").to(walk.dt) * o


class SAGANGenerator(_Generator):
    """z (N, encoding_dims) -> images (N, out_channels, out_size, out_size):
    the DCGAN generator's ConvTranspose stack, spectrally normalized, with
    ``Attention_<attn_size>`` after the block that reaches that size."""

    ARCHS = ("sagan",)
    CLI_DEFAULTS = {"step_channels": 32, "attn_size": 32}

    def __init__(self, cfg: GANModelConfig, *, final_tanh: bool = True, seed: int = 0, device=None):
        super().__init__()
        check_arch(cfg, self.ARCHS)
        self.cfg, self.final_tanh = cfg, final_tanh
        r = num_repeats(cfg.out_size)
        d = cfg.step_channels * 2**r
        bias = not cfg.batchnorm
        self.add_module("ConvTranspose_0", sn_layer(nn.ConvTranspose2d(
            cfg.encoding_dims, d, 4, 1, 0, bias=bias, device=device)))
        if cfg.batchnorm:
            self.add_module("_BN_0", nn.BatchNorm2d(d, eps=1e-5, device=device))
        size = 4
        for i in range(r):
            self.add_module(f"ConvTranspose_{i + 1}", sn_layer(nn.ConvTranspose2d(
                d, d // 2, 4, 2, 1, bias=bias, device=device)))
            d //= 2
            if cfg.batchnorm:
                self.add_module(f"_BN_{i + 1}", nn.BatchNorm2d(d, eps=1e-5, device=device))
            size *= 2
            if size == cfg.attn_size:
                self.add_module(f"Attention_{size}", SelfAttention2d(d, device=device))
        self.add_module(f"ConvTranspose_{r + 1}", sn_layer(nn.ConvTranspose2d(
            d, cfg.out_channels, 4, 2, 1, bias=True, device=device)))
        self._finish(seed)

    def forward_stats(self, z: torch.Tensor, stats: Stats, train: bool,
                      params: Optional[Sequence[torch.Tensor]] = None,
                      labels: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Stats]:
        """``(images, new_stats)`` from the state ``stats`` and, when given,
        ``params`` in place of the module's parameters (EMA sampling).
        ``labels`` are ignored: SAGAN is unconditional."""
        cfg, r = self.cfg, num_repeats(self.cfg.out_size)
        walk = Walk(self, stats, train, params)
        x = z.to(walk.dt)[:, :, None, None]
        size = 4  # after the head
        for i in range(r + 1):
            x = walk.convt(getattr(self, f"ConvTranspose_{i}"), x)
            if cfg.batchnorm:
                x = walk.bn(getattr(self, f"_BN_{i}"), x)
            x = F.leaky_relu(x, cfg.leaky_slope)
            if i > 0:
                size *= 2
                if size == cfg.attn_size:
                    x = getattr(self, f"Attention_{size}").attend(walk, x)
        x = walk.convt(getattr(self, f"ConvTranspose_{r + 1}"), x).float()
        return (torch.tanh(x) if self.final_tanh else x), walk.result()


class SAGANDiscriminator(SNNet):
    """images (N, out_channels, out_size, out_size) -> (N,) critic scores:
    spectrally normalized strided convs with biases, no BatchNorm, attention
    at ``attn_size`` on the way down."""

    ARCHS = ("sagan",)

    def __init__(self, cfg: GANModelConfig, *, seed: int = 0, device=None):
        super().__init__()
        check_arch(cfg, self.ARCHS)
        if cfg.critic != "unconditional":
            raise ValueError(f"critic={cfg.critic!r} is for the dcgan family; sagan's critic is unconditional")
        self.cfg = cfg
        r = num_repeats(cfg.out_size)
        d = cfg.step_channels
        self.add_module("Conv_0", sn_layer(nn.Conv2d(cfg.out_channels, d, 4, 2, 1, device=device)))
        size = cfg.out_size // 2
        if size == cfg.attn_size:
            self.add_module(f"Attention_{size}", SelfAttention2d(d, device=device))
        for i in range(r):
            self.add_module(f"Conv_{i + 1}", sn_layer(nn.Conv2d(d, 2 * d, 4, 2, 1, device=device)))
            d *= 2
            size //= 2
            if size == cfg.attn_size:
                self.add_module(f"Attention_{size}", SelfAttention2d(d, device=device))
        self.add_module(f"Conv_{r + 1}", sn_layer(nn.Conv2d(d, 1, 4, 1, 0, device=device)))
        self._finish(seed)

    def forward(self, x: torch.Tensor, stats: Stats, train: bool,
                cond: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Stats]:
        """``(scores, new_stats)``; ``cond`` and ``labels`` are ignored."""
        cfg, r = self.cfg, num_repeats(self.cfg.out_size)
        walk = Walk(self, stats, train)
        x = x.to(walk.dt)
        size = cfg.out_size
        for i in range(r + 1):
            x = F.leaky_relu(walk.conv(getattr(self, f"Conv_{i}"), x), cfg.leaky_slope)
            size //= 2
            if size == cfg.attn_size:
                x = getattr(self, f"Attention_{size}").attend(walk, x)
        x = walk.conv(getattr(self, f"Conv_{r + 1}"), x).float()
        if cfg.disc_last_leaky:
            x = F.leaky_relu(x, cfg.leaky_slope)
        return x.reshape(x.shape[0]), walk.result()


# ------------------------------------------------------------- flax layout


def _flax_module_path(qualname: str) -> Tuple[str, ...]:
    """A module's path in the flax tree: the torch name's parts, with the
    ``BatchNorm_0`` that the JAX ``_BN`` wrapper nests under ``_BN_i``."""
    parts = tuple(qualname.split(".")) if qualname else ()
    return parts + ("BatchNorm_0",) if parts and parts[-1].startswith("_BN_") else parts


def flax_source(net: nn.Module, key: str) -> Tuple[str, Tuple[str, ...], str]:
    """Where the state_dict entry ``key`` of a SAGAN or BigGAN net lives in
    the JAX package's variables: ``(collection, path, kind)``, ``collection``
    ``"params"`` or ``"batch_stats"``, ``kind`` the layout transform of
    ``convert.py`` (``"conv"``, ``"convt"``, ``"dense"``, ``"vec"``; ``"count"``
    for BatchNorm's ``num_batches_tracked``, which flax lacks)."""
    mod_name, _, leaf = key.rpartition(".")
    m = net.get_submodule(mod_name)
    path = _flax_module_path(mod_name)
    if leaf in ("sn_u", "sn_sigma"):
        parent, _, own = mod_name.rpartition(".")
        sn_path = _flax_module_path(parent) + (f"sn_{own}",)
        return "batch_stats", sn_path + (f"{own}/kernel/{leaf[3:]}",), "vec"
    if isinstance(m, nn.BatchNorm2d):
        table = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                 "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}
        if leaf == "num_batches_tracked":
            return "batch_stats", path, "count"
        col, name = table[leaf]
        return col, path + (name,), "vec"
    if isinstance(m, nn.Embedding):
        return "params", path + ("embedding",), "vec"
    if leaf == "weight":
        return "params", path + ("kernel",), _kind(m)
    return "params", path + (leaf,), "vec"  # biases, attention's gamma
