"""Functional BatchNorm with the semantics of flax ``nn.BatchNorm``.

The JAX package's DCGAN BatchNorm (``rnagan_tpu/models/dcgan.py::_BN``) is
flax's with ``momentum=0.9``, ``epsilon=1e-5`` and the default
``use_fast_variance=True``. In train mode that means:

* the batch statistics are reduced in float32 over every axis but the
  channels, ``var = max(E[x^2] - E[x]^2, 0)`` (the biased variance);
* ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, cast to
  the compute dtype of ``x``;
* the running statistics become ``0.9 * old + 0.1 * batch``, the variance the
  biased one.

In eval mode the running statistics normalize. Torch's own BatchNorm differs
on two counts: momentum 0.1 is the weight of the batch, and its running
variance takes the *unbiased* batch variance. This module never mutates a
buffer: it returns the new statistics and the caller decides which to keep.

Under a mesh (``parallel/collectives.py::active``) the train-mode statistics
are those of the global batch, as pjit makes them in the JAX package: each
rank's sums of ``x`` and ``x^2`` go through one differentiable all-reduce of
a (2, C) float32 buffer over the data group and are divided by the global
row count, then ``var = max(E[x^2] - E[x]^2, 0)`` as on one device. Its
backward all-reduces the statistics' gradients, so forward, backward and
double backward are those of the one-rank batch. Without a data group the
one-device arithmetic runs, bit for bit as before.

On the card a train-mode call takes one autograd op backed by hand-written
kernels (``kernels/batchnorm.py``, LeakyReLU fused when ``leaky_slope`` is
given) where the input allows it (:func:`takes_kernels`: a bf16
channels-last map with C % 8 == 0, outside a mesh); every other input keeps
the PyTorch ops below, bit for bit. Each train-mode call on a CUDA map adds 1
to the counter ``bn.layers``, and one on the kernels 1 to ``bn.layers_kernel``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from rnagan_tpu_torch.core import profiling
from rnagan_tpu_torch.kernels.batchnorm import EPS, MOMENTUM, batch_norm_act, kernel_map
from rnagan_tpu_torch.parallel import collectives

#: running (mean, var) of each BatchNorm of a module, in module order
Stats = List[Tuple[torch.Tensor, torch.Tensor]]


class _Mean(torch.autograd.Function):
    """``x.mean(axes)``, whose gradient goes back broadcast (:class:`_MeanGrad`)."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.shape, ctx.axes = x.shape, axes
        return x.mean(axes)

    @staticmethod
    def backward(ctx, g):
        return _MeanGrad.apply(g, ctx.shape, ctx.axes), None


class _MeanGrad(torch.autograd.Function):
    """A mean's gradient ``g / n`` expanded to the input's shape with no
    copy: the values of autograd's own mean backward, which writes them out
    as a contiguous map. The op that takes the broadcast gradient then keeps
    its other operand's layout, so a channels-last map's gradients stay
    channels-last. Its own gradient divides and then sums, in autograd's
    order, so a double backward keeps autograd's bits too."""

    @staticmethod
    def forward(ctx, g, shape, axes):
        ctx.n, ctx.axes = math.prod(shape[a] for a in axes), axes
        kept = [1 if a in axes else s for a, s in enumerate(shape)]
        return (g / ctx.n).reshape(kept).expand(shape)

    @staticmethod
    def backward(ctx, gg):
        return (gg / ctx.n).sum(ctx.axes), None, None


def takes_kernels(x: torch.Tensor, train: bool) -> bool:
    """Whether a call on ``x`` takes ``kernels/batchnorm.py``'s op: train
    mode on a CUDA map the kernels read as it is (``kernel_map``: bf16
    channels-last, C % 8 == 0, 16-byte aligned), and no data group."""
    return train and x.is_cuda and kernel_map(x) and collectives.data_group() is None


def batch_norm(x: torch.Tensor, scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
               mean: torch.Tensor, var: torch.Tensor, *, train: bool,
               leaky_slope: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x`` (N, C, ...) in the compute dtype; ``scale``, ``bias`` and the
    running ``mean``, ``var`` (C,) float32; a None ``scale`` or ``bias`` is
    left out (flax's ``use_scale=False``, ``use_bias=False``). Returns ``(y,
    new_mean, new_var)``: ``y`` in ``x``'s dtype, through
    ``F.leaky_relu(y, leaky_slope)`` when ``leaky_slope`` is given; in eval
    mode the running statistics come back as they were."""
    if train and x.is_cuda:
        profiling.count("bn.layers", 1)
        if takes_kernels(x, train):
            profiling.count("bn.layers_kernel", 1)
            return batch_norm_act(x, scale, bias, mean, var, leaky_slope)
    axes = [0, *range(2, x.ndim)]
    xf = x.float()
    if train:
        group = collectives.data_group()
        if group is None:
            m = _Mean.apply(xf, axes)
            v = torch.clamp(_Mean.apply(xf * xf, axes) - m * m, min=0.0)
        else:
            count = xf.numel() // xf.shape[1] * collectives.group_size(group)  # equal shards
            sums = collectives.all_reduce_sum(torch.stack([xf.sum(axes), (xf * xf).sum(axes)]), group)
            m, sq = sums[0] / count, sums[1] / count
            v = torch.clamp(sq - m * m, min=0.0)
        new_mean = (MOMENTUM * mean + (1.0 - MOMENTUM) * m).detach()
        new_var = (MOMENTUM * var + (1.0 - MOMENTUM) * v).detach()
    else:
        m, v, new_mean, new_var = mean, var, mean, var
    shape = (1, -1) + (1,) * (x.ndim - 2)
    mul = torch.rsqrt(v + EPS)
    if scale is not None:
        mul = mul * scale
    # + (-m), exactly xf - m: the double backward then negates the (C,) gradient, not a broadcast map
    y = (xf + (-m).reshape(shape)) * mul.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    y = y.to(x.dtype)
    if leaky_slope is not None:
        y = F.leaky_relu(y, leaky_slope)
    return y, new_mean, new_var
