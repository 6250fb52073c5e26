"""A frozen copy of the port's seeded draws, so the references draw the same bits.

The port keys every draw of a training step or a request by an integer seed:
``SeedStream.seed`` hashes (run seed, name, step, stage) with SHA-256, and
Philox4x32-10 (Random123) turns a seed and a counter into four uint32 words.
The uniforms of the infused noise take word 0 of counter (row, col, 0, 0) and
key (seed, 0); the GP's epsilon and the standard normals take key (seed, 1);
the β-VAE's dropout mask and row draws take every word of counter (k, 0, 0,
0) under key (seed, 2). A word maps to [0, 1) by its top 24 bits.

This file is a copy of that arithmetic (``core/rng.py`` and
``kernels/infusion.py`` of the port, as of the benchmark's first version), in
int64 tensor ops on any device. It stays as it is: a change to the port's
draws shows as a failed comparison, not as a silent change of the yardstick.
"""

from __future__ import annotations

import hashlib
import math
import struct

import torch

MASK = 0xFFFFFFFF
_M0, _M1, _W0, _W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85


def stream_seed(run_seed: int, name: str, step: int = 0, stage: int = 0) -> int:
    """The 31-bit seed of (``name``, ``step``, ``stage``) under ``run_seed``."""
    msg = struct.pack("<qqq", int(run_seed), int(step), int(stage)) + name.encode()
    return int.from_bytes(hashlib.sha256(msg).digest()[:4], "little") & 0x7FFFFFFF


def _mulhilo(m: int, c: torch.Tensor):
    a = m * (c & 0xFFFF)
    b = m * (c >> 16)
    t = a + ((b & 0xFFFF) << 16)
    return ((b >> 16) + (t >> 32)) & MASK, t & MASK


def philox4x32(counter, key):
    """Philox4x32-10 on int64 tensors holding uint32 values; ``key`` two ints."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & MASK, key[1] & MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & MASK, (k1 + _W1) & MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def unit(words: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in [0, 1) from their top 24 bits."""
    return (words >> 8).to(torch.float32) * (1.0 / (1 << 24))


def noise_uniform(seed: int, n: int, d: int, noise_range: float, device) -> torch.Tensor:
    """The infused noise's (n, d) uniforms in [-noise_range, noise_range)."""
    row = torch.arange(n, dtype=torch.int64, device=device)[:, None].expand(n, d)
    col = torch.arange(d, dtype=torch.int64, device=device)[None, :].expand(n, d)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    w0 = philox4x32((row, col, zero, zero), (int(seed), 0))[0]
    return (unit(w0) * 2.0 - 1.0) * noise_range


def _words2(seed: int, n: int, device):
    i = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return philox4x32((i, zero, zero, zero), (int(seed), 1))[:2]


def _words4(seed: int, n: int, device) -> torch.Tensor:
    k = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return torch.stack(philox4x32((k, zero, zero, zero), (int(seed), 2)), dim=-1).reshape(-1)[:n]


def uniform(seed: int, shape, device) -> torch.Tensor:
    """Uniforms in [0, 1): element k is word 0 of counter k under key (seed, 1)."""
    return unit(_words2(seed, math.prod(shape), device)[0]).reshape(shape)


def uniform4(seed: int, shape, device) -> torch.Tensor:
    """Uniforms in [0, 1), four a counter under key (seed, 2)."""
    return unit(_words4(seed, math.prod(shape), device)).reshape(shape)


def randint(seed: int, high: int, shape, device) -> torch.Tensor:
    """Integers in [0, high): the four-word stream's words modulo ``high``."""
    return (_words4(seed, math.prod(shape), device) % high).reshape(shape)


def normal(seed: int, shape, device) -> torch.Tensor:
    """Standard normals by Box-Muller: counter k gives elements 2k and 2k + 1."""
    n = math.prod(shape)
    w0, w1 = _words2(seed, (n + 1) // 2, device)
    r = torch.sqrt(-2.0 * torch.log1p(-unit(w0)))
    theta = (2.0 * math.pi) * unit(w1)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1).reshape(-1)[:n].reshape(shape)


def standardize(x: torch.Tensor) -> torch.Tensor:
    """Per-column standardization over the rows, ddof=1, ``+1e-12`` inside the root."""
    c = x - x.mean(dim=0)
    var = (c * c).sum(dim=0) / max(x.shape[0] - 1, 1)
    return c / torch.sqrt(var + 1e-12)


def infused_noise(z_mean: torch.Tensor, seed: int, noise_range: float) -> torch.Tensor:
    """RNA-GAN's noise prior: ``standardize(U(-r, r) + z_mean)`` over the batch."""
    n, d = z_mean.shape
    return standardize(noise_uniform(seed, n, d, noise_range, z_mean.device) + z_mean)
