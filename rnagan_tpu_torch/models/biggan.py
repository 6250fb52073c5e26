"""BigGAN-style class-conditional residual GAN (port of ``rnagan_tpu/models/biggan.py``).

* Residual up blocks (``GBlock``): conditional BatchNorm, LeakyReLU, 2x
  nearest upsample, spectrally normalized 3x3 conv, conditional BatchNorm,
  LeakyReLU, 3x3 conv; the skip is upsample then a 1x1 conv. Down blocks
  (``DBlock``): (LeakyReLU,) 3x3 conv, LeakyReLU, 3x3 conv, 2x2 average
  pool; the skip is a 1x1 conv then the pool.
* Hierarchical latent (:func:`split_latent`): z splits into ``n_up + 1``
  chunks, the first ones taking the remainder; chunk 0 seeds the 4x4 map
  through ``linear_in``, chunk i+1 conditions block i.
* ``ConditionalBatchNorm``: flax BatchNorm without scale or bias, then
  ``* (1 + gamma(cond)) + beta(cond)``, both projections bias-free Linear
  layers that start at 0. ``cond`` is the shared class embedding joined with
  the block's chunk, or the chunk alone when ``num_classes`` is 0.
* Self-attention (``models/sagan.py``) at ``attn_size`` in both nets.
* Projection discriminator: ``linear_out(sum_hw h) + <proj_embed(y), sum_hw
  h>`` when labels are given.

Channels: ``step_channels * min(16, 2**(n_up - i))`` after generator block
i (1024 at 4x4 for ``step_channels`` 64 at 256x256), mirrored in the
discriminator. ``linear_in``'s output is read as NHWC ``(N, 4, 4, C)``, as
the JAX package reshapes it, then laid out NCHW, so a flax Dense kernel
moves by a plain transpose.

``cfg.remat`` recomputes each residual block in the backward pass
(``torch.utils.checkpoint``, non-reentrant, which also serves the gradient
penalty's double backward). A block returns its new BatchNorm and spectral
norm state as values, so the recomputation writes nothing.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from rnagan_tpu_torch.core.config import GANModelConfig
from rnagan_tpu_torch.models.batchnorm import Stats
from rnagan_tpu_torch.models.dcgan import check_arch
from rnagan_tpu_torch.models.sagan import SelfAttention2d, SNNet, Walk, _Generator, sn_layer


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of (N, C, H, W): ``jax.image.resize(..., "nearest")``."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _n_up(out_size: int) -> int:
    if out_size < 8 or (out_size & (out_size - 1)) != 0:
        raise ValueError("image size must be >= 8 and a power of 2")
    return out_size.bit_length() - 3  # 4x4 seed -> out_size


def latent_sizes(dim: int, n_chunks: int) -> List[int]:
    base, rem = divmod(dim, n_chunks)
    return [base + (1 if i < rem else 0) for i in range(n_chunks)]


def split_latent(z: torch.Tensor, n_chunks: int) -> Tuple[torch.Tensor, ...]:
    """z split on its last axis into ``n_chunks`` near-equal chunks, the first
    ones one wider when the width does not divide (2048 over 7: 293 x 4, 292 x 3)."""
    return torch.split(z, latent_sizes(z.shape[-1], n_chunks), dim=-1)


def _remat(walk: Walk, fn: Callable, remat: bool, *xs: torch.Tensor) -> torch.Tensor:
    """``fn(walk, *xs)``, recomputed in the backward pass when ``remat``; the
    block's state updates come back as values of the first run only."""
    if not remat:
        return fn(walk, *xs)

    def pure(*args):
        sub = walk.child()
        return fn(sub, *args), sub.new

    out, new = checkpoint(pure, *xs, use_reentrant=False, preserve_rng_state=False)
    walk.new.update(new)
    return out


class ConditionalBatchNorm(nn.Module):
    def __init__(self, channels: int, cond_dim: int, device=None):
        super().__init__()
        self.bn = nn.BatchNorm2d(channels, eps=1e-5, affine=False, device=device)
        self.gamma = nn.Linear(cond_dim, channels, bias=False, device=device)
        self.beta = nn.Linear(cond_dim, channels, bias=False, device=device)

    def norm(self, walk: Walk, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = walk.bn(self.bn, x)
        gamma = walk.dense(self.gamma, cond, sn=False)[:, :, None, None]
        beta = walk.dense(self.beta, cond, sn=False)[:, :, None, None]
        return h * (1.0 + gamma) + beta


class GBlock(nn.Module):
    def __init__(self, cin: int, cout: int, cond_dim: int, slope: float, device=None):
        super().__init__()
        self.slope = slope
        self.cbn1 = ConditionalBatchNorm(cin, cond_dim, device)
        self.conv1 = sn_layer(nn.Conv2d(cin, cout, 3, padding=1, bias=False, device=device))
        self.cbn2 = ConditionalBatchNorm(cout, cond_dim, device)
        self.conv2 = sn_layer(nn.Conv2d(cout, cout, 3, padding=1, bias=False, device=device))
        self.conv_skip = sn_layer(nn.Conv2d(cin, cout, 1, bias=False, device=device))

    def run(self, walk: Walk, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.cbn1.norm(walk, x, cond), self.slope)
        h = walk.conv(self.conv1, upsample2x_nearest(h))
        h = F.leaky_relu(self.cbn2.norm(walk, h, cond), self.slope)
        h = walk.conv(self.conv2, h)
        return h + walk.conv(self.conv_skip, upsample2x_nearest(x))


class DBlock(nn.Module):
    def __init__(self, cin: int, cout: int, slope: float, first: bool, device=None):
        super().__init__()
        self.slope, self.first = slope, first
        self.conv1 = sn_layer(nn.Conv2d(cin, cout, 3, padding=1, bias=False, device=device))
        self.conv2 = sn_layer(nn.Conv2d(cout, cout, 3, padding=1, bias=False, device=device))
        self.conv_skip = sn_layer(nn.Conv2d(cin, cout, 1, bias=False, device=device))

    def run(self, walk: Walk, x: torch.Tensor) -> torch.Tensor:
        h = x if self.first else F.leaky_relu(x, self.slope)
        h = F.leaky_relu(walk.conv(self.conv1, h), self.slope)
        h = F.avg_pool2d(walk.conv(self.conv2, h), 2)
        return h + F.avg_pool2d(walk.conv(self.conv_skip, x), 2)


class _BigGAN(SNNet):
    ARCHS = ("biggan",)

    @classmethod
    def takes_labels(cls, cfg: GANModelConfig) -> bool:
        """Labels join G's latent chunks and D's projection when ``num_classes`` > 0."""
        return cfg.num_classes > 0

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        """Drawn from ``gen`` in module order: convs, Linear and embeddings
        orthogonal (``models/biggan.py:48``), the conditional BatchNorm
        projections 0, ``bn_out`` scale 1 and bias 0 (flax's defaults),
        attention convs N(0, 0.02) and ``gamma`` 0, ``sn_u`` N(0, 1)."""
        skip = set()  # set by their parent, which comes first in module order
        for m in self.modules():
            if isinstance(m, ConditionalBatchNorm):
                m.gamma.weight.zero_()
                m.beta.weight.zero_()
                skip |= {m.gamma, m.beta}
            elif isinstance(m, SelfAttention2d):
                for conv in (m.theta, m.phi, m.g, m.o):
                    conv.weight.normal_(0.0, 0.02, generator=gen)
                    skip.add(conv)
            elif isinstance(m, (nn.Conv2d, nn.Linear, nn.Embedding)) and m not in skip:
                nn.init.orthogonal_(m.weight, generator=gen)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d) and m.affine:
                m.weight.fill_(1.0)
                m.bias.zero_()
            if hasattr(m, "sn_u"):
                m.sn_u.normal_(generator=gen)


class BigGANGenerator(_BigGAN, _Generator):
    """z (N, encoding_dims) [+ labels (N,) when ``num_classes`` > 0] ->
    images (N, out_channels, out_size, out_size)."""

    def __init__(self, cfg: GANModelConfig, *, final_tanh: bool = True, seed: int = 0, device=None):
        super().__init__()
        check_arch(cfg, self.ARCHS)
        self.cfg, self.final_tanh = cfg, final_tanh
        n_up = _n_up(cfg.out_size)
        ch = [cfg.step_channels * min(16, 2 ** (n_up - i)) for i in range(n_up + 1)]
        sizes = latent_sizes(cfg.encoding_dims, n_up + 1)
        emb = cfg.embed_dim if cfg.num_classes > 0 else 0
        if cfg.num_classes > 0:
            self.shared_embed = nn.Embedding(cfg.num_classes, cfg.embed_dim, device=device)
        self.linear_in = sn_layer(nn.Linear(sizes[0], 16 * ch[0], device=device))
        size = 4
        for i in range(n_up):
            self.add_module(f"block_{i}", GBlock(ch[i], ch[i + 1], emb + sizes[i + 1], cfg.leaky_slope,
                                                 device))
            size *= 2
            if size == cfg.attn_size:
                self.add_module(f"Attention_{size}", SelfAttention2d(ch[i + 1], device=device))
        self.bn_out = nn.BatchNorm2d(ch[-1], eps=1e-5, device=device)
        self.conv_out = sn_layer(nn.Conv2d(ch[-1], cfg.out_channels, 3, padding=1, device=device))
        self._finish(seed)

    def forward_stats(self, z: torch.Tensor, stats: Stats, train: bool,
                      params: Optional[Sequence[torch.Tensor]] = None,
                      labels: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Stats]:
        """``(images, new_stats)`` from the state ``stats`` and, when given,
        ``params`` in place of the module's parameters (EMA sampling)."""
        cfg = self.cfg
        n_up = _n_up(cfg.out_size)
        walk = Walk(self, stats, train, params)
        chunks = split_latent(z.to(walk.dt), n_up + 1)
        emb = None
        if cfg.num_classes > 0:
            if labels is None:
                raise ValueError("arch='biggan' with num_classes > 0 requires labels")
            emb = F.embedding(labels.to(z.device).long(),
                              walk.param(self.shared_embed, "weight").to(walk.dt))
        n, c0 = z.shape[0], self.linear_in.weight.shape[0] // 16
        h = walk.dense(self.linear_in, chunks[0]).reshape(n, 4, 4, c0).permute(0, 3, 1, 2).contiguous()
        size = 4
        for i in range(n_up):
            cond = chunks[i + 1] if emb is None else torch.cat([emb, chunks[i + 1]], dim=-1)
            h = _remat(walk, getattr(self, f"block_{i}").run, cfg.remat, h, cond)
            size *= 2
            if size == cfg.attn_size:
                h = getattr(self, f"Attention_{size}").attend(walk, h)
        h = F.leaky_relu(walk.bn(self.bn_out, h), cfg.leaky_slope)
        h = walk.conv(self.conv_out, h).float()
        return (torch.tanh(h) if self.final_tanh else h), walk.result()


class BigGANDiscriminator(_BigGAN):
    """images (N, out_channels, out_size, out_size) [+ labels] -> (N,) critic
    scores; the projection term joins when ``num_classes`` > 0 and labels
    are given."""

    def __init__(self, cfg: GANModelConfig, *, seed: int = 0, device=None):
        super().__init__()
        check_arch(cfg, self.ARCHS)
        if cfg.critic != "unconditional":
            raise ValueError(f"critic={cfg.critic!r} is for the dcgan family; biggan projects on its labels")
        self.cfg = cfg
        n_down = _n_up(cfg.out_size)
        ch = [cfg.step_channels * min(16, 2 ** (i + 1)) for i in range(n_down)]
        size, cin = cfg.out_size, cfg.out_channels
        for i in range(n_down):
            self.add_module(f"block_{i}", DBlock(cin, ch[i], cfg.leaky_slope, i == 0, device))
            cin = ch[i]
            size //= 2
            if size == cfg.attn_size:
                self.add_module(f"Attention_{size}", SelfAttention2d(ch[i], device=device))
        self.linear_out = sn_layer(nn.Linear(ch[-1], 1, device=device))
        if cfg.num_classes > 0:
            self.proj_embed = nn.Embedding(cfg.num_classes, ch[-1], device=device)
        self._finish(seed)

    def forward(self, x: torch.Tensor, stats: Stats, train: bool,
                cond: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Stats]:
        """``(scores, new_stats)``; ``cond`` is ignored."""
        cfg = self.cfg
        walk = Walk(self, stats, train)
        h = x.to(walk.dt)
        size = cfg.out_size
        for i in range(_n_up(cfg.out_size)):
            h = _remat(walk, getattr(self, f"block_{i}").run, cfg.remat, h)
            size //= 2
            if size == cfg.attn_size:
                h = getattr(self, f"Attention_{size}").attend(walk, h)
        h = F.leaky_relu(h, cfg.leaky_slope).sum(dim=(2, 3))  # global sum pool -> (N, C)
        out = walk.dense(self.linear_out, h)[:, 0]
        if cfg.num_classes > 0 and labels is not None:
            emb = F.embedding(labels.to(x.device).long(), walk.param(self.proj_embed, "weight").to(walk.dt))
            out = out + (emb * h).sum(dim=-1)
        out = out.float()
        if cfg.disc_last_leaky:
            out = F.leaky_relu(out, cfg.leaky_slope)
        return out, walk.result()
