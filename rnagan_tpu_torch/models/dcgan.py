"""DCGAN-family generators and discriminators (port of ``rnagan_tpu/models/dcgan.py``).

torchgan's ``nn.Sequential`` layout, so ``model.<block>.0|1`` keys match the
``.model`` bundles the JAX package exports (``models/dcgan_torch.py``).

:class:`DCGANGenerator` (arch ``dcgan``):

* block 0: ``ConvTranspose2d(z, d, 4, 1, 0)`` on the 1x1 noise map, BN, LeakyReLU;
* blocks 1..r: ``ConvTranspose2d(c, c/2, 4, 2, 1)``, BN, LeakyReLU;
* block r+1: ``ConvTranspose2d(step, out_channels, 4, 2, 1)`` with a bias.

:class:`DCGANUpGenerator` (arch ``dcgan_up``, the resize-convolution
generator) has no torchgan layout (``dcgan_torch.py:79-83``); the port's own
keeps the block numbering of ``dcgan``:

* block 0: the same ConvTranspose2d head, BN, LeakyReLU;
* blocks 1..r: 2x bilinear upsample (align_corners=False), reflection pad 1,
  ``Conv2d(c, c/2, 3, 1, 0)`` with a bias (flax ``nn.Conv``'s default), BN,
  LeakyReLU;
* block r+1: upsample, pad, ``Conv2d(step, out_channels, 3, 1, 0)``, then tanh
  unless ``compat_no_tanh`` (the reference's final block omits it).

:class:`ConditionalDCGANGenerator` (arch ``condgan``) is ``dcgan`` with the
labels' one-hot concatenated to z, so its head has ``encoding_dims +
num_classes`` input channels.

Discriminator (the mirror; ``dcgan`` and ``dcgan_up`` share it):

* block 0: ``Conv2d(in, step, 4, 2, 1)`` with a bias, LeakyReLU;
* blocks 1..r: ``Conv2d(c, 2c, 4, 2, 1)``, BN, LeakyReLU;
* block r+1: ``Conv2d(d, 1, 4, 1, 0)`` with a bias, reshaped to (N,) scores,
  then LeakyReLU when ``disc_last_leaky``;
* ``critic="projection"`` adds ``<cond_proj(z_mean), sum_hw h>`` to the score,
  ``h`` the last 4x4 feature map and ``cond_proj`` a bias-free Linear.

:class:`ConditionalDCGANDiscriminator` (``condgan``) appends the one-hot as
constant maps after the image channels, so block 0 reads ``out_channels +
num_classes`` channels.

``r = out_size.bit_length() - 4`` (5 at 256x256). Without BatchNorm
(``cfg.batchnorm=False``; for the generator also the BN-folded serving form)
every conv carries a bias. A stride-2 ``ConvTranspose2d`` with padding 1
equals flax's ``padding="SAME"`` once the kernel is flipped in transit; a
``Conv2d`` kernel is only transposed (``convert.py``).

Layout: the nets take and give NCHW shapes. On a CUDA card every
convolution they issue runs on channels-last (NHWC-strided) operands, so
cuDNN's NHWC kernels get the order they compute in and transpose nothing
(:func:`conv_layout`; on the CPU the order stays contiguous NCHW):

* the weights are cast to the compute dtype straight into that order
  (:func:`cast_weight`: one copy, whose gradient comes back as one copy into
  the float32 master's contiguous order); the discriminator's input is cast
  into it the same way, the noise enters as an NHWC view (:func:`noise_map`),
  and convolution, BatchNorm, LeakyReLU, the upsample and the pad keep it;
* a train-mode generator hands its output to the discriminator in that
  order; in eval mode its output is contiguous NCHW.

On every device the discriminator's convolutions differentiate through
first-order convolutions (:class:`_Conv2d`), so the gradient penalty's
double backward keeps the maps' order too, and its last block, one output
channel over the whole 4x4 map, is computed as the dot product it is
(:func:`discriminator_conv`).

Each convolution layer a forward runs adds 1 to the counter ``gan.convs``,
and to ``gan.convs_channels_last`` when both operands are channels-last
(``core/profiling.py``).

BatchNorm has flax's semantics (``models/batchnorm.py``). ``forward_stats`` /
the discriminator's ``forward`` take the running statistics as an argument
and return the updated ones, so each training stage decides which to keep;
a generator's ``forward`` keeps them in its BatchNorm buffers.

Parameters stay float32; ``cfg.compute_dtype`` names the compute type (cast
copies of the weights, float32 output), as the JAX modules do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rnagan_tpu_torch.core import profiling
from rnagan_tpu_torch.core.config import GANModelConfig
from rnagan_tpu_torch.core.device import compute_dtype
from rnagan_tpu_torch.models.batchnorm import Stats, batch_norm

def num_repeats(size: int) -> int:
    if size < 16 or (size & (size - 1)) != 0:
        raise ValueError("image size must be >= 16 and a power of 2")
    return size.bit_length() - 4


def check_arch(cfg: GANModelConfig, archs: Sequence[str]) -> None:
    """Raise ValueError unless ``cfg.arch`` is one of ``archs``."""
    if cfg.arch not in archs:
        raise ValueError(f"arch={cfg.arch!r} is not one of {tuple(archs)} here")


def _up2_adjoint(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The adjoint of the 2x bilinear upsample (align_corners=False) along
    ``dim``, (..., 2n, ...) -> (..., n, ...): output 2i is 0.25 x[i-1] +
    0.75 x[i] (x[0] alone at 0), output 2i+1 is 0.75 x[i] + 0.25 x[i+1]
    (x[n-1] alone at the end); sums of slices, in float32 at least."""
    g = g.to(torch.promote_types(g.dtype, torch.float32))
    even, odd = g.narrow(dim, 0, g.shape[dim]).unflatten(dim, (-1, 2)).unbind(dim + 1 if dim >= 0 else dim)
    n = even.shape[dim]
    nxt = torch.cat([even.narrow(dim, 1, n - 1), odd.narrow(dim, n - 1, 1)], dim)
    prv = torch.cat([even.narrow(dim, 0, 1), odd.narrow(dim, 0, n - 1)], dim)
    return 0.75 * (even + odd) + 0.25 * (nxt + prv)


def _pad1_adjoint(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The adjoint of the reflect pad of 1 along ``dim``, (..., n+2, ...) ->
    (..., n, ...): the pad's first element goes back to x[1], its last to x[n-2]."""
    n = g.shape[dim] - 2
    inner, left, right = g.narrow(dim, 1, n), g.narrow(dim, 0, 1), g.narrow(dim, n + 1, 1)
    zeros = torch.zeros_like(inner)
    return inner + (torch.cat([zeros.narrow(dim, 0, 1), left, zeros.narrow(dim, 0, n - 2)], dim)
                    + torch.cat([zeros.narrow(dim, 0, n - 2), right, zeros.narrow(dim, 0, 1)], dim))


class _Upsample2x(torch.autograd.Function):
    """``F.interpolate``'s 2x bilinear forward with a backward of slices and
    sums: PyTorch's CUDA backward adds with atomics, so two runs of one
    training step differ in the last bits; this one does not."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)

    @staticmethod
    def backward(ctx, g):
        return _up2_adjoint(_up2_adjoint(g, 3), 2).to(ctx.dtype)


class _ReflectPad1(torch.autograd.Function):
    """``F.pad(x, (1, 1, 1, 1), mode="reflect")`` with a deterministic
    backward (PyTorch's CUDA backward adds with atomics). A channels-last
    ``x`` is padded by slices and concatenations, which keep its order: the
    CUDA reflection pad makes its input contiguous."""

    @staticmethod
    def forward(ctx, x):
        if x.is_contiguous():
            return F.pad(x, (1, 1, 1, 1), mode="reflect")
        h, w = x.shape[2], x.shape[3]
        x = torch.cat([x.narrow(3, 1, 1), x, x.narrow(3, w - 2, 1)], 3)
        return torch.cat([x.narrow(2, 1, 1), x, x.narrow(2, h - 2, 1)], 2)

    @staticmethod
    def backward(ctx, g):
        return _pad1_adjoint(_pad1_adjoint(g, 3), 2)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of (N, C, H, W), align_corners=False. Equals
    ``jax.image.resize(..., "bilinear")``: at the border JAX drops the
    out-of-range tap and renormalizes, torch clamps the source coordinate,
    and both give the edge pixel. On CUDA its backward is deterministic
    (``_Upsample2x``), so a ``dcgan_up`` step repeats bit for bit."""
    if x.is_cuda:
        return _Upsample2x.apply(x)
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def reflect_pad_hw(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """Reflect padding of H and W; on CUDA with ``pad`` 1 its backward is
    deterministic (``_ReflectPad1``)."""
    if x.is_cuda and pad == 1:
        return _ReflectPad1.apply(x)
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def up_block(x: torch.Tensor, weight3: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``dcgan_up``'s up-block convolution: 2x bilinear upsample -> reflect
    pad 1 -> 3x3 VALID conv with a bias; (N, Cin, H, W) -> (N, Cout, 2H, 2W)."""
    return F.conv2d(reflect_pad_hw(upsample2x_bilinear(x), 1), weight3, bias)


def conv_layout(x: torch.Tensor) -> torch.memory_format:
    """The order the nets convolve ``x``'s batch in: channels-last on a CUDA
    card, where cuDNN's NHWC kernels want it; contiguous NCHW on the CPU,
    whose float32 convolutions sum in another order in channels-last and then
    lie outside the port's parity tolerances with the JAX package."""
    return torch.channels_last if x.is_cuda else torch.contiguous_format


def noise_map(z: torch.Tensor, layout: torch.memory_format) -> torch.Tensor:
    """The (N, C) noise as the head's (N, C, 1, 1) input map, a view. A 1x1
    map is contiguous in either order, and a convolution takes the ambiguous
    one for NCHW: in channels-last order it is given channels-last strides,
    as an NHWC view, so cuDNN's weight gradient of the head stays NHWC."""
    if layout == torch.channels_last:
        return z[:, None, None, :].permute(0, 3, 1, 2)
    return z[:, :, None, None]


class _ChannelsLastCast(torch.autograd.Function):
    """A weight cast to ``dtype`` in channels-last order, one copy. The
    gradient goes back as one copy too, into the weight's dtype and
    contiguous order: the order of the float32 master, its Adam moments and
    K3, which reads each buffer element by element. The backward is an
    ordinary differentiable op."""

    @staticmethod
    def forward(ctx, w, dtype):
        ctx.dtype = w.dtype
        return w.to(dtype, memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype, memory_format=torch.contiguous_format), None


def cast_weight(w: torch.Tensor, dtype: torch.dtype, layout: torch.memory_format) -> torch.Tensor:
    """A convolution's weight (``Conv2d``'s (out, in, kH, kW) or
    ``ConvTranspose2d``'s (in, out, kH, kW)) in ``dtype`` and ``layout``;
    in channels-last order its gradient comes back contiguous
    (:class:`_ChannelsLastCast`)."""
    if layout == torch.channels_last:
        return _ChannelsLastCast.apply(w, dtype)
    return w.to(dtype)


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` whose backward is built of first-order convolutions on
    the maps themselves: the input's gradient a transposed convolution of
    the output's gradient with the weight, the weight's cuDNN's
    weight-gradient kernel. A double backward (the gradient penalty's)
    then differentiates the transposed convolution as it differentiates any
    convolution. Autograd's own double backward of a convolution computes
    the weight term as a convolution of the batch-transposed maps
    (``_convolution_double_backward``): operands in neither layout, made
    contiguous and transposed again by cuDNN, and a convolution whose filter
    is the whole output map, which cuDNN runs slowly."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        return F.conv2d(x, w, b, stride, padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding = ctx.stride, ctx.padding
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            # the output padding that gives back x's size from a strided convolution
            extra = [x.shape[i] - ((g.shape[i] - 1) * stride[i - 2] - 2 * padding[i - 2] + w.shape[i])
                     for i in (2, 3)]
            gx = F.conv_transpose2d(g, w, None, stride, padding, extra)
        if ctx.needs_input_grad[1]:
            gw = torch.ops.aten.convolution_backward(g, x, w, None, stride, padding, (1, 1), False, (0, 0), 1,
                                                     (False, True, False))[1]
        if ctx.needs_input_grad[2]:
            gb = g.sum((0, 2, 3))
        return gx, gw, gb, None, None


def discriminator_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride,
                       padding) -> torch.Tensor:
    """The discriminator's convolution, through :class:`_Conv2d`, whose
    double backward keeps the maps' order. The last block, one output
    channel whose kernel covers the whole map, is the dot product it equals,
    of map and kernel flattened in the map's order (NHWC for a channels-last
    map: cuDNN transposes around a channels-last convolution with one output
    channel)."""
    if w.shape[0] == 1 and x.shape[2:] == w.shape[2:] and not any(padding):
        order = (0, 2, 3, 1) if x.is_contiguous(memory_format=torch.channels_last) else (0, 1, 2, 3)
        flat = lambda t: t.permute(order).reshape(t.shape[0], -1)  # noqa: E731
        return F.linear(flat(x), flat(w), b)[:, :, None, None]
    return _Conv2d.apply(x, w, b, tuple(stride), tuple(padding))


def count_conv(x: torch.Tensor, w: torch.Tensor) -> None:
    """Count a convolution layer run on input ``x`` and weight ``w``:
    ``gan.convs``, and ``gan.convs_channels_last`` when both are channels-last."""
    profiling.count("gan.convs", 1)
    if x.is_contiguous(memory_format=torch.channels_last) and w.is_contiguous(memory_format=torch.channels_last):
        profiling.count("gan.convs_channels_last", 1)


def join_onehot(x: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``x`` with the labels' one-hot joined on the channel axis (1): after a
    generator's (N, z) noise, or after a discriminator's image channels as
    constant maps."""
    onehot = F.one_hot(labels.to(x.device).long(), num_classes).to(x.dtype)
    if x.ndim == 4:
        onehot = onehot[:, :, None, None].expand(-1, -1, x.shape[2], x.shape[3])
    return torch.cat([x, onehot], dim=1)


def _output(x: torch.Tensor, train: bool) -> torch.Tensor:
    """A generator's last map in float32: channels-last as it is in train
    mode (the discriminator reads it so), contiguous NCHW in eval mode."""
    if train:
        return x.float()
    return x.to(torch.float32, memory_format=torch.contiguous_format)


class _DCGAN(nn.Module):
    """What the nets share: seeded init and the BN buffers as ``Stats``."""

    cfg: GANModelConfig
    #: the ``cfg.arch`` values the class builds
    ARCHS: Tuple[str, ...] = ()
    #: one-hot labels join the input (the ``condgan`` variants)
    conditional = False
    #: the nets convolve channels-last operands: a caller may hand the
    #: discriminator an NHWC batch as its permuted (N, C, H, W) view
    channels_last = True

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        """Convs and Linear N(0, 0.02), BN scale N(1, 0.02), biases zero
        (``models/dcgan.py:45-49``), drawn in module order from ``seed``."""
        gen = None
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.BatchNorm2d, nn.Linear)):
                if gen is None:
                    gen = torch.Generator(device=m.weight.device).manual_seed(seed)
                m.weight.normal_(1.0 if isinstance(m, nn.BatchNorm2d) else 0.0, 0.02, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()

    def _bns(self):
        return [m for m in self.modules() if isinstance(m, nn.BatchNorm2d)]

    def bn_stats(self) -> Stats:
        """The BatchNorm buffers (running mean, running var), in module order."""
        return [(bn.running_mean, bn.running_var) for bn in self._bns()]

    @torch.no_grad()
    def load_bn_stats(self, stats: Stats) -> None:
        for bn, (mean, var) in zip(self._bns(), stats, strict=True):
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)

    def _bn(self, x, p, block: int, stats: Stats, k: int, train: bool, new: Stats):
        x, mean, var = batch_norm(x, p[f"model.{block}.1.weight"], p[f"model.{block}.1.bias"],
                                  *stats[k], train=train)
        new.append((mean, var))
        return x

    def _labelled(self, x: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
        """The input, with the labels' one-hot joined for a conditional net."""
        if not self.conditional:
            return x
        if labels is None:
            raise ValueError(f"arch={self.cfg.arch!r} requires labels")
        return join_onehot(x, labels, self.cfg.num_classes)


class _Generator(_DCGAN):
    """Module mode over ``forward_stats``."""

    def forward(self, z: torch.Tensor, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Module mode: BatchNorm reads its buffers; train mode also writes the
        updated statistics back to them, as flax's mutable ``batch_stats``."""
        out, new = self.forward_stats(z, self.bn_stats(), self.training, labels=labels)
        if self.training:
            self.load_bn_stats(new)
        return out

    def _head(self, cin: int, cout: int, device) -> nn.Sequential:
        """The ConvTranspose2d head on the 1x1 noise map, BN, LeakyReLU."""
        return self._block(nn.ConvTranspose2d(cin, cout, 4, 1, 0, bias=not self.cfg.batchnorm,
                                              device=device), cout, device)

    def _block(self, conv: nn.Module, cout: int, device) -> nn.Sequential:
        layers = [conv]
        if self.cfg.batchnorm:
            layers.append(nn.BatchNorm2d(cout, eps=1e-5, device=device))
        layers.append(nn.LeakyReLU(self.cfg.leaky_slope))
        return nn.Sequential(*layers)


class DCGANGenerator(_Generator):
    """z (N, encoding_dims) -> images (N, out_channels, out_size, out_size).

    Weights are drawn from ``seed``. ``final_tanh=False`` returns the
    pre-tanh map, for the fused uint8 egress."""

    ARCHS = ("dcgan",)

    def __init__(self, cfg: GANModelConfig, *, final_tanh: bool = True, seed: int = 0, device=None):
        super().__init__()
        check_arch(cfg, self.ARCHS)
        self.cfg = cfg
        self.final_tanh = final_tanh
        r = num_repeats(cfg.out_size)
        d = cfg.step_channels * 2**r
        zdim = cfg.encoding_dims + (cfg.num_classes if self.conditional else 0)
        blocks = [self._head(zdim, d, device)]
        for _ in range(r):
            blocks.append(self._block(nn.ConvTranspose2d(d, d // 2, 4, 2, 1, bias=not cfg.batchnorm,
                                                         device=device), d // 2, device))
            d //= 2
        blocks.append(nn.Sequential(
            nn.ConvTranspose2d(d, cfg.out_channels, 4, 2, 1, bias=True, device=device)))
        self.model = nn.Sequential(*blocks)
        self._init_weights(seed)

    def forward_stats(self, z: torch.Tensor, stats: Stats, train: bool,
                      params: Optional[Sequence[torch.Tensor]] = None,
                      labels: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Stats]:
        """``(images, new_stats)`` with the BatchNorm statistics ``stats`` and,
        when given, ``params`` in place of the module's parameters (the EMA
        generator samples this way)."""
        dt = compute_dtype(self.cfg.compute_dtype)
        p = dict(self.named_parameters())
        if params is not None:
            p = dict(zip(p, params, strict=True))
        layout = conv_layout(z)
        x = noise_map(self._labelled(z, labels).to(dt), layout)
        new: Stats = []
        last = len(self.model) - 1
        for i, block in enumerate(self.model):
            conv = block[0]
            bias = p.get(f"model.{i}.0.bias")
            w = cast_weight(p[f"model.{i}.0.weight"], dt, layout)
            count_conv(x, w)
            x = F.conv_transpose2d(x, w, None if bias is None else bias.to(dt), conv.stride, conv.padding)
            if i == last:
                break
            if self.cfg.batchnorm:
                x = self._bn(x, p, i, stats, i, train, new)
            x = F.leaky_relu(x, self.cfg.leaky_slope)
        x = _output(x, train)
        return (torch.tanh(x) if self.final_tanh else x), new


class ConditionalDCGANGenerator(DCGANGenerator):
    """``dcgan`` conditioned on labels: ``forward(z, labels)`` with (N,) int
    labels in [0, num_classes)."""

    ARCHS = ("condgan",)
    conditional = True


class DCGANUpGenerator(_Generator):
    """The resize-convolution generator (arch ``dcgan_up``): z (N,
    encoding_dims) -> images (N, out_channels, out_size, out_size), tanh
    unless ``compat_no_tanh``. Weights are drawn from ``seed``."""

    ARCHS = ("dcgan_up",)

    def __init__(self, cfg: GANModelConfig, *, compat_no_tanh: bool = False, seed: int = 0,
                 device=None):
        super().__init__()
        check_arch(cfg, self.ARCHS)
        self.cfg = cfg
        self.compat_no_tanh = compat_no_tanh
        r = num_repeats(cfg.out_size)
        d = cfg.step_channels * 2**r
        blocks = [self._head(cfg.encoding_dims, d, device)]
        for _ in range(r):
            blocks.append(self._block(nn.Conv2d(d, d // 2, 3, 1, 0, bias=True, device=device),
                                      d // 2, device))
            d //= 2
        blocks.append(nn.Sequential(nn.Conv2d(d, cfg.out_channels, 3, 1, 0, bias=True, device=device)))
        self.model = nn.Sequential(*blocks)
        self._init_weights(seed)

    def forward_stats(self, z: torch.Tensor, stats: Stats, train: bool,
                      params: Optional[Sequence[torch.Tensor]] = None,
                      labels: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Stats]:
        """``(images, new_stats)``, as :meth:`DCGANGenerator.forward_stats`."""
        dt = compute_dtype(self.cfg.compute_dtype)
        p = dict(self.named_parameters())
        if params is not None:
            p = dict(zip(p, params, strict=True))
        new: Stats = []
        last = len(self.model) - 1
        bias = p.get("model.0.0.bias")
        layout = conv_layout(z)
        x = noise_map(z.to(dt), layout)
        w = cast_weight(p["model.0.0.weight"], dt, layout)
        count_conv(x, w)
        x = F.conv_transpose2d(x, w, None if bias is None else bias.to(dt))
        for i in range(last + 1):
            if i > 0:
                x = reflect_pad_hw(upsample2x_bilinear(x), 1)
                w = cast_weight(p[f"model.{i}.0.weight"], dt, layout)
                count_conv(x, w)
                x = F.conv2d(x, w, p[f"model.{i}.0.bias"].to(dt))
            if i == last:
                break
            if self.cfg.batchnorm:
                x = self._bn(x, p, i, stats, i, train, new)
            x = F.leaky_relu(x, self.cfg.leaky_slope)
        x = _output(x, train)
        return (x if self.compat_no_tanh else torch.tanh(x)), new


class DCGANDiscriminator(_DCGAN):
    """images (N, out_channels, out_size, out_size) -> (N,) critic scores.

    Weights are drawn from ``seed``; ``critic="projection"`` adds the
    ``cond_proj`` Linear (encoding_dims -> the last feature width)."""

    ARCHS = ("dcgan", "dcgan_up")

    def __init__(self, cfg: GANModelConfig, *, seed: int = 0, device=None):
        super().__init__()
        check_arch(cfg, self.ARCHS)
        if cfg.critic not in ("unconditional", "projection"):
            raise ValueError(f"unknown critic: {cfg.critic}")
        self.cfg = cfg
        r = num_repeats(cfg.out_size)
        d = cfg.step_channels
        slope = cfg.leaky_slope
        cin = cfg.out_channels + (cfg.num_classes if self.conditional else 0)
        blocks = [nn.Sequential(nn.Conv2d(cin, d, 4, 2, 1, bias=True, device=device),
                                nn.LeakyReLU(slope))]
        for _ in range(r):
            layers = [nn.Conv2d(d, 2 * d, 4, 2, 1, bias=not cfg.batchnorm, device=device)]
            if cfg.batchnorm:
                layers.append(nn.BatchNorm2d(2 * d, eps=1e-5, device=device))
            blocks.append(nn.Sequential(*layers, nn.LeakyReLU(slope)))
            d *= 2
        blocks.append(nn.Sequential(nn.Conv2d(d, 1, 4, 1, 0, bias=True, device=device)))
        self.model = nn.Sequential(*blocks)
        if cfg.critic == "projection":
            self.cond_proj = nn.Linear(cfg.encoding_dims, d, bias=False, device=device)
        self._init_weights(seed)

    def forward(self, x: torch.Tensor, stats: Stats, train: bool,
                cond: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Stats]:
        """``(scores, new_stats)``. ``cond`` (N, encoding_dims) is the frozen
        VAE's z_mean, required by the projection critic; ``labels`` (N,) the
        conditional critic's classes."""
        cfg = self.cfg
        dt = compute_dtype(cfg.compute_dtype)
        p = dict(self.named_parameters())
        new: Stats = []
        layout = conv_layout(x)
        x = self._labelled(x, labels).to(dt, memory_format=layout)
        last = len(self.model) - 1
        for i, block in enumerate(self.model):
            conv = block[0]
            if i == last:
                h = x  # the final 4x4 feature map
            bias = p.get(f"model.{i}.0.bias")
            w = cast_weight(p[f"model.{i}.0.weight"], dt, layout)
            count_conv(x, w)
            x = discriminator_conv(x, w, None if bias is None else bias.to(dt), conv.stride, conv.padding)
            if i == last:
                break
            if cfg.batchnorm and i > 0:
                x = self._bn(x, p, i, stats, i - 1, train, new)
            x = F.leaky_relu(x, cfg.leaky_slope)
        score = x.float().reshape(x.shape[0])
        if cfg.critic == "projection":
            if cond is None:
                raise ValueError("critic='projection' requires cond (z_mean)")
            proj = F.linear(cond.to(dt), p["cond_proj.weight"].to(dt))
            score = score + (h.sum(dim=(2, 3)) * proj).sum(dim=-1).float()
        if cfg.disc_last_leaky:
            score = F.leaky_relu(score, cfg.leaky_slope)
        return score, new


class ConditionalDCGANDiscriminator(DCGANDiscriminator):
    """The discriminator of ``condgan``: ``forward(x, stats, train,
    labels=labels)`` with the one-hot of (N,) int labels as constant maps after
    the image channels."""

    ARCHS = ("condgan",)
    conditional = True


def _classes(net: str):
    """The registry (``rnagan_tpu/models/dcgan.py:262-297``, and the port's
    ``biggan_pub``); SAGAN and the BigGANs are imported here, as they import
    this module."""
    from rnagan_tpu_torch.models.biggan import BigGANDiscriminator, BigGANGenerator
    from rnagan_tpu_torch.models.biggan_pub import PublishedBigGANDiscriminator, PublishedBigGANGenerator
    from rnagan_tpu_torch.models.sagan import SAGANDiscriminator, SAGANGenerator

    if net == "generator":
        return {"dcgan": DCGANGenerator, "dcgan_up": DCGANUpGenerator,
                "condgan": ConditionalDCGANGenerator, "sagan": SAGANGenerator,
                "biggan": BigGANGenerator, "biggan_pub": PublishedBigGANGenerator}
    return {"dcgan": DCGANDiscriminator, "dcgan_up": DCGANDiscriminator,
            "condgan": ConditionalDCGANDiscriminator, "sagan": SAGANDiscriminator,
            "biggan": BigGANDiscriminator, "biggan_pub": PublishedBigGANDiscriminator}


def make_generator(cfg: GANModelConfig, **kwargs) -> nn.Module:
    """The generator of ``cfg.arch``; ``kwargs`` go to the class (``seed``,
    ``device``, ...)."""
    classes = _classes("generator")
    check_arch(cfg, tuple(classes))
    return classes[cfg.arch](cfg, **kwargs)


def make_discriminator(cfg: GANModelConfig, **kwargs) -> nn.Module:
    """The discriminator of ``cfg.arch``; ``dcgan`` and ``dcgan_up`` share the
    plain one."""
    classes = _classes("discriminator")
    check_arch(cfg, tuple(classes))
    return classes[cfg.arch](cfg, **kwargs)
