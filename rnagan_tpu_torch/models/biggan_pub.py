"""BigGAN as its authors publish it (arch ``biggan_pub``).

Brock, Donahue & Simonyan, *Large Scale GAN Training for High Fidelity
Natural Image Synthesis* (ICLR 2019, arXiv:1809.11096), in the equations of
the authors' PyTorch code (github.com/ajbrock/BigGAN-PyTorch, ``BigGAN.py``
and ``layers.py``), wired as RNA-GAN's ``--gan_type biggan`` calls it
(``histopathology_gan.py:211-234``: ``dim_z=2048, G_ch=64, resolution=256,
n_classes=2``). The port's ``biggan`` (``models/biggan.py``) is the JAX
package's own BigGAN-style net and stays as it is.

With ``ch = step_channels``, the tables ``G_arch`` and ``D_arch`` at 32, 64
and 256 (:data:`G_ARCH`, :data:`D_ARCH`; other sizes raise):

* **Generator.** ``y_emb = shared(y)``, an ``Embedding(num_classes,
  embed_dim)``. z splits into chunks of ``encoding_dims // (blocks + 1)``
  (292 of 2048 at 256; the published ``torch.split``, so a remainder, the
  last 4 columns at 2048, feeds nothing): chunk 0 feeds ``linear``
  (spectrally normalized, ``16 * ch * 4 * 4`` wide at 256), read as NCHW
  ``(N, 16 ch, 4, 4)``; block i is conditioned on ``c = [y_emb, chunk i+1]``.
  A block (``GBlock``): ``h = up2(relu(bn1(x, c)))``, ``h = conv1(h)``,
  ``h = conv2(relu(bn2(h, c)))``, ``out = h + conv_sc(up2(x))``; 3x3
  convolutions with padding 1 and the 1x1 shortcut, all with biases and
  spectrally normalized; ``up2`` the 2x nearest upsample. The conditional
  BatchNorm (``ccbn``): ``BN(x) * (1 + gain(c)) + bias(c)``, ``BN`` without
  affine, ``gain`` and ``bias`` spectrally normalized linear maps without
  biases. ``Attention`` (``models/sagan.py::SelfAttention2d``, which is
  ``layers.Attention``) follows the block at ``attn_size``. The head:
  ``tanh(output_conv(relu(output_bn(h))))``, ``output_bn`` with a scale
  and a bias, ``output_conv`` a spectrally normalized 3x3 convolution to
  the image channels.
* **Discriminator.** Blocks (``DBlock``): ``h = conv2(relu(conv1(pre(x))))``,
  ``pre`` a ReLU except in block 0, then a 2x2 average pool where the table
  pools; the shortcut is ``conv_sc`` then the pool for a pre-activated
  block, the pool then ``conv_sc`` for block 0, the identity where neither
  the width changes nor the block pools. ``Attention`` follows the block at
  ``attn_size``. The score: ``linear(sum_hw relu(h)) + <embed(y), sum_hw
  relu(h)>``, ``linear`` a spectrally normalized ``Linear(16 ch, 1)`` and
  ``embed`` a spectrally normalized ``Embedding(num_classes, 16 ch)``. No
  LeakyReLU on the score (``disc_last_leaky`` is not read).
* **Spectral norm** (``layers.SN`` with one singular value and one
  iteration, :func:`spectral_norm`): the weight as ``W = weight.view(out,
  -1)`` and ``u`` (1, out); ``v = normalize(u W)``, ``u' = normalize(v
  W^T)`` without gradient (``F.normalize``'s ``x / max(||x||, eps)``, eps
  1e-12, ``BigGAN.py``'s ``SN_eps``); ``sigma = v W^T u'^T`` with its
  gradient through ``W``; the weight used is ``weight / sigma``. Every
  forward iterates; a training forward returns ``(u', sigma)`` as the
  layer's new state, an evaluation forward its old state.
* **Initialization** (``init='ortho'``): orthogonal for every convolution,
  linear and embedding weight, biases 0; ``output_bn`` scale 1 and bias 0;
  attention's ``gamma`` 0; ``u`` standard normal.

Departures from the published code, each what the rest of the port does:
BatchNorm's statistics are flax's (``models/batchnorm.py``: the biased batch
variance, ``0.9 * old + 0.1 * batch``, eps 1e-5) where ``F.batch_norm`` keeps
the unbiased variance; the state (BatchNorm statistics and each spectral
norm's ``(u, sigma)``) is the ``Stats`` list the trainer threads
(``models/sagan.py``), not buffers written in place; compute runs in
``cfg.compute_dtype`` on float32 parameters, with the power iteration, the
BatchNorm statistics and attention's softmax in float32. ``cfg.remat``
recomputes each block in the backward pass (``models/biggan.py::_remat``).

Convolutions (:meth:`PublishedWalk.conv`) take the DCGAN nets' route
(``models/dcgan.py``). On a CUDA card every one runs on channels-last
operands (``dcgan.conv_layout``; the CPU keeps NCHW): each normalized
float32 weight is cast into bf16 channels-last by one copy
(``dcgan.cast_weight``, whose gradient comes back float32 and contiguous), the
generator's first map is made channels-last once, the discriminator's input
is cast into that order (the trainer hands it the NHWC tiles as a permuted
view), and CCBN, the upsample, the pools, the residual sums and attention's
products keep it. There the convolutions differentiate through first-order
convolutions (``dcgan._Conv2d``), so the penalty's double backward keeps the
maps' order and never runs autograd's own double backward of a convolution.
The pools (:class:`_AvgPool2`, ``sagan._MaxPool2``: PyTorch's kernels) keep
it in that double backward too. One map leaves it there: the critic
attention's query product hands the query convolution a contiguous gradient
(``bmm``'s double backward), which cuDNN transposes (a few µs a step). Each
convolution a forward runs adds 1 to the counter ``gan.convs``, and to
``gan.convs_channels_last`` when both operands are channels-last
(``dcgan.count_conv``). An evaluation forward of the generator hands back
contiguous NCHW float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rnagan_tpu_torch.core.config import GANModelConfig
from rnagan_tpu_torch.models import dcgan
from rnagan_tpu_torch.models.batchnorm import Stats
from rnagan_tpu_torch.models.biggan import _remat, upsample2x_nearest
from rnagan_tpu_torch.models.dcgan import check_arch
from rnagan_tpu_torch.models.sagan import SelfAttention2d, SNNet, Walk, _Generator, sn_layer

#: ``BigGAN.py``'s ``SN_eps``
SN_EPS = 1e-12
#: ``G_arch``: out_size -> (in, out) channel multiples of ``ch`` a block; block i doubles the map to 8 * 2**i
G_ARCH: Dict[int, Tuple[Tuple[int, int], ...]] = {
    32: ((4, 4), (4, 4), (4, 4)),
    64: ((16, 16), (16, 8), (8, 4), (4, 2)),
    256: ((16, 16), (16, 8), (8, 8), (8, 4), (4, 2), (2, 1)),
}
#: ``D_arch``: out_size -> (in, out, pools, resolution) a block; in 0 is the image's channels
D_ARCH: Dict[int, Tuple[Tuple[int, int, bool, int], ...]] = {
    32: ((0, 4, True, 16), (4, 4, True, 16), (4, 4, False, 16), (4, 4, False, 16)),
    64: ((0, 1, True, 32), (1, 2, True, 16), (2, 4, True, 8), (4, 8, True, 4), (8, 16, False, 4)),
    256: ((0, 1, True, 128), (1, 2, True, 64), (2, 4, True, 32), (4, 8, True, 16), (8, 8, True, 8),
          (8, 16, True, 4), (16, 16, False, 4)),
}


def check_size(out_size: int) -> None:
    if out_size not in G_ARCH:
        raise ValueError(f"arch='biggan_pub' has the published tables at {sorted(G_ARCH)}, not {out_size}")


def chunk_size(cfg: GANModelConfig) -> int:
    """The width of each latent chunk: ``encoding_dims // (blocks + 1)`` (292 at 2048 and 256x256)."""
    return cfg.encoding_dims // (len(G_ARCH[cfg.out_size]) + 1)


def spectral_norm(weight: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``layers.SN`` on one float32 weight: ``(weight / sigma, new u, sigma)``;
    the new ``u`` and ``sigma`` carry no gradient, the weight does (through ``sigma`` too)."""
    w = weight.reshape(weight.shape[0], -1)
    with torch.no_grad():
        v = F.normalize(u @ w, eps=SN_EPS)
        u_new = F.normalize(v @ w.t(), eps=SN_EPS)
    sigma = ((v @ w.t()) @ u_new.t())[0, 0]
    return weight / sigma, u_new, sigma.detach()


class _AvgPool2(torch.autograd.Function):
    """``F.avg_pool2d(x, 2)`` with the backward of ``sagan._MaxPool2``'s kind:
    PyTorch's kernel, recording no dependence on x, so the penalty's double
    backward hands x no contiguous NCHW gradient of zeros."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.avg_pool2d(x, 2)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.ops.aten.avg_pool2d_backward(g, x.detach(), (2, 2), (2, 2), (0, 0), False, True, None)


class PublishedWalk(Walk):
    """A forward's view of a ``biggan_pub`` net: the published spectral norm,
    and the convolution route of the module docstring."""

    def normalize(self, weight, u, m):
        return spectral_norm(weight, u)

    def conv(self, m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        layout = dcgan.conv_layout(x)
        w, b = self.weight(m, layout), self.bias(m)
        dcgan.count_conv(x, w)
        if layout == torch.channels_last:
            return dcgan._Conv2d.apply(x, w, b, tuple(m.stride), tuple(m.padding))
        # NCHW (the CPU): F.conv2d's own backward, whose rounding the float32 tests against the
        # plain reference were set on; a bias gradient that cancels exactly in a balanced batch
        # takes Adam's first step in the sign of that rounding, and the next stage's loss with it
        return F.conv2d(x, w, b, m.stride, m.padding)


class CCBN(nn.Module):
    """``layers.ccbn``: BatchNorm without affine, then ``* (1 + gain(c)) + bias(c)``."""

    def __init__(self, channels: int, cond_dim: int, device=None):
        super().__init__()
        self.bn = nn.BatchNorm2d(channels, eps=1e-5, affine=False, device=device)
        self.gain = sn_layer(nn.Linear(cond_dim, channels, bias=False, device=device))
        self.bias = sn_layer(nn.Linear(cond_dim, channels, bias=False, device=device))

    def norm(self, walk: Walk, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        gain = walk.dense(self.gain, cond)[:, :, None, None]
        bias = walk.dense(self.bias, cond)[:, :, None, None]
        return walk.bn(self.bn, x) * (1.0 + gain) + bias


def _conv(cin: int, cout: int, k: int, device) -> nn.Conv2d:
    return sn_layer(nn.Conv2d(cin, cout, k, padding=k // 2, device=device))


class GBlock(nn.Module):
    def __init__(self, cin: int, cout: int, cond_dim: int, device=None):
        super().__init__()
        self.bn1 = CCBN(cin, cond_dim, device)
        self.conv1 = _conv(cin, cout, 3, device)
        self.bn2 = CCBN(cout, cond_dim, device)
        self.conv2 = _conv(cout, cout, 3, device)
        self.conv_sc = _conv(cin, cout, 1, device)

    def run(self, walk: Walk, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = upsample2x_nearest(F.relu(self.bn1.norm(walk, x, cond)))
        h = walk.conv(self.conv1, h)
        h = walk.conv(self.conv2, F.relu(self.bn2.norm(walk, h, cond)))
        return h + walk.conv(self.conv_sc, upsample2x_nearest(x))


class DBlock(nn.Module):
    def __init__(self, cin: int, cout: int, pools: bool, preactivation: bool, device=None):
        super().__init__()
        self.pools, self.preactivation = pools, preactivation
        self.conv1 = _conv(cin, cout, 3, device)
        self.conv2 = _conv(cout, cout, 3, device)
        if cin != cout or pools:
            self.conv_sc = _conv(cin, cout, 1, device)

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        return _AvgPool2.apply(x) if self.pools else x

    def run(self, walk: Walk, x: torch.Tensor) -> torch.Tensor:
        h = walk.conv(self.conv1, F.relu(x) if self.preactivation else x)
        h = self._pool(walk.conv(self.conv2, F.relu(h)))
        if not hasattr(self, "conv_sc"):
            return h + x
        if self.preactivation:
            return h + self._pool(walk.conv(self.conv_sc, x))
        return h + walk.conv(self.conv_sc, self._pool(x))


class _Published(SNNet):
    ARCHS = ("biggan_pub",)
    conditional = True
    #: attention at 64x64 and a 128-wide shared embedding
    CLI_DEFAULTS = {"step_channels": 64, "attn_size": 64, "embed_dim": 128}

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        """Drawn from ``gen`` in module order: convolution, linear and
        embedding weights orthogonal, biases 0, ``output_bn`` scale 1 and
        bias 0, attention's ``gamma`` 0, ``sn_u`` standard normal."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear, nn.Embedding)):
                nn.init.orthogonal_(m.weight, generator=gen)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d) and m.affine:
                m.weight.fill_(1.0)
                m.bias.zero_()
            if hasattr(m, "sn_u"):
                m.sn_u.normal_(generator=gen)

    def _check(self, cfg: GANModelConfig) -> None:
        check_arch(cfg, self.ARCHS)
        check_size(cfg.out_size)
        if cfg.num_classes < 1:
            raise ValueError("arch='biggan_pub' is class-conditional: num_classes must be at least 1")
        if cfg.critic != "unconditional":
            raise ValueError(f"critic={cfg.critic!r} is for the dcgan family; biggan_pub projects on its labels")


def _labels(labels: Optional[torch.Tensor], device) -> torch.Tensor:
    if labels is None:
        raise ValueError("arch='biggan_pub' requires labels")
    return labels.to(device).long()


class PublishedBigGANGenerator(_Published, _Generator):
    """z (N, encoding_dims) and labels (N,) -> images (N, out_channels, out_size, out_size)."""

    def __init__(self, cfg: GANModelConfig, *, final_tanh: bool = True, seed: int = 0, device=None):
        super().__init__()
        self._check(cfg)
        self.cfg, self.final_tanh = cfg, final_tanh
        ch, arch, chunk = cfg.step_channels, G_ARCH[cfg.out_size], chunk_size(cfg)
        self.shared = nn.Embedding(cfg.num_classes, cfg.embed_dim, device=device)
        self.linear = sn_layer(nn.Linear(chunk, arch[0][0] * ch * 16, device=device))
        self.blocks = nn.ModuleList()
        size = 4
        for cin, cout in arch:
            size *= 2
            block = nn.ModuleList([GBlock(cin * ch, cout * ch, cfg.embed_dim + chunk, device)])
            if size == cfg.attn_size:
                block.append(SelfAttention2d(cout * ch, device=device))
            self.blocks.append(block)
        self.output_bn = nn.BatchNorm2d(arch[-1][1] * ch, eps=1e-5, device=device)
        self.output_conv = _conv(arch[-1][1] * ch, cfg.out_channels, 3, device)
        self._finish(seed)

    def forward_stats(self, z: torch.Tensor, stats: Stats, train: bool,
                      params: Optional[Sequence[torch.Tensor]] = None,
                      labels: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Stats]:
        """``(images, new_stats)`` from the state ``stats`` and, when given,
        ``params`` in place of the module's parameters (EMA sampling)."""
        walk = PublishedWalk(self, stats, train, params)
        chunks = torch.split(z.to(walk.dt), chunk_size(self.cfg), dim=1)
        y = F.embedding(_labels(labels, z.device), walk.param(self.shared, "weight").to(walk.dt))
        h = walk.dense(self.linear, chunks[0])
        h = h.reshape(h.shape[0], -1, 4, 4)
        h = h.contiguous(memory_format=dcgan.conv_layout(h))
        for i, block in enumerate(self.blocks):
            h = _remat(walk, block[0].run, self.cfg.remat, h, torch.cat([y, chunks[i + 1]], dim=1))
            if len(block) > 1:
                h = block[1].attend(walk, h)
        h = dcgan._output(walk.conv(self.output_conv, F.relu(walk.bn(self.output_bn, h))), train)
        return (torch.tanh(h) if self.final_tanh else h), walk.result()


class PublishedBigGANDiscriminator(_Published):
    """images (N, out_channels, out_size, out_size) and labels (N,) -> (N,) critic scores."""

    #: a caller may hand the critic an NHWC batch as its permuted (N, C, H, W) view
    channels_last = True

    def __init__(self, cfg: GANModelConfig, *, seed: int = 0, device=None):
        super().__init__()
        self._check(cfg)
        self.cfg = cfg
        ch = cfg.step_channels
        self.blocks = nn.ModuleList()
        for i, (cin, cout, pools, res) in enumerate(D_ARCH[cfg.out_size]):
            block = nn.ModuleList([DBlock(cin * ch if i else cfg.out_channels, cout * ch, pools, i > 0, device)])
            if res == cfg.attn_size:
                block.append(SelfAttention2d(cout * ch, device=device))
            self.blocks.append(block)
        width = D_ARCH[cfg.out_size][-1][1] * ch
        self.linear = sn_layer(nn.Linear(width, 1, device=device))
        self.embed = sn_layer(nn.Embedding(cfg.num_classes, width, device=device))
        self._finish(seed)

    def forward(self, x: torch.Tensor, stats: Stats, train: bool,
                cond: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Stats]:
        """``(scores, new_stats)``; ``cond`` is ignored."""
        walk = PublishedWalk(self, stats, train)
        h = x.to(walk.dt, memory_format=dcgan.conv_layout(x))
        for block in self.blocks:
            h = _remat(walk, block[0].run, self.cfg.remat, h)
            if len(block) > 1:
                h = block[1].attend(walk, h)
        h = F.relu(h).sum(dim=(2, 3))
        out = walk.dense(self.linear, h)[:, 0]
        emb = F.embedding(_labels(labels, x.device), walk.weight(self.embed))
        return (out + (emb * h).sum(dim=1)).float(), walk.result()

