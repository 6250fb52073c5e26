"""Explicit seed discipline (the port's counterpart of ``rnagan_tpu/core/rng.py``).

One run seed derives an integer seed for every (stream name, step, stage),
by hashing: the derivation is pure, so the same arguments give the same seed
in any process and in any order. :meth:`SeedStream.table` gives the seeds of
a run of steps as one int64 tensor, the table a training step captured in a
CUDA graph reads its seeds from (``train/step_graph.py``).

The seeds key Philox4x32-10 streams (``kernels/infusion.py``): the
infused-noise kernel's uniforms (key word 1 is 0 there); :func:`uniform` and
:func:`normal` (key word 1 is 1), the GAN step's GP epsilon and
standard-normal noise and the β-VAE step's reparametrization epsilon; and
:func:`uniform4` and :func:`randint` (key word 1 is 2), which use all four
words of a counter, the β-VAE step's dropout mask (128 x 19,198 uniforms a
step at full width) and the rows a resident-matrix step draws, and
:func:`permutation`, an epoch's order. The ResNet trainers draw from them
too: the classifier's flips (``"ml"``), SimCLR's seven draws a view
(``"ssl"``), the fusion RNA encoder's dropout mask (``"fusion"``) and
``fit_resident``'s permutation (``"ml_epoch"``). A seed is a host int or a
one-element integer tensor on the device; both give the same bits, so a
captured step draws what the eager step draws.
``torch.Generator``s seeded here (:meth:`SeedStream.generator`) draw
everything else. Nothing draws from PyTorch's global generator. The streams
are the port's own: they do not reproduce ``jax.random``'s bits, and the
tests hand both packages the same draws instead.
"""

from __future__ import annotations

import hashlib
import math
import struct
from typing import Sequence

import torch

from rnagan_tpu_torch.kernels.infusion import _MASK, philox4x32, philox_key


class SeedStream:
    """Named, step-indexed integer seeds from one run seed.

    >>> s = SeedStream(99)
    >>> s.seed("d", step=10) == s.seed("d", step=10)
    True
    """

    def __init__(self, seed: int):
        self.run_seed = int(seed)

    def seed(self, name: str, step: int = 0, stage: int = 0) -> int:
        """A 31-bit seed for (``name``, ``step``, ``stage``)."""
        msg = struct.pack("<qqq", self.run_seed, int(step), int(stage)) + name.encode()
        return int.from_bytes(hashlib.sha256(msg).digest()[:4], "little") & 0x7FFFFFFF

    def table(self, name: str, start: int, steps: int, stages: int) -> torch.Tensor:
        """The seeds of steps ``[start, start + steps)`` x stages ``[0,
        stages)``: an int64 (steps, stages) CPU tensor whose entry (i, j) is
        ``seed(name, start + i, j)``."""
        return torch.tensor([[self.seed(name, start + i, j) for j in range(stages)] for i in range(steps)],
                            dtype=torch.int64).reshape(steps, stages)

    def generator(self, name: str, step: int = 0, stage: int = 0, device="cpu") -> torch.Generator:
        """A ``torch.Generator`` on ``device`` seeded for (``name``, ``step``, ``stage``)."""
        return torch.Generator(device=device).manual_seed(self.seed(name, step, stage))


def _words(seed, n: int, device) -> Sequence[torch.Tensor]:
    """Philox4x32-10 words 0 and 1 of counters (i, 0, 0, 0), i < n, key
    (seed, 1): two (n,) int64 tensors of uint32 values. Key word 1 keeps
    these streams apart from the infused-noise kernel's (key word 1 is 0
    there)."""
    i = torch.arange(n, dtype=torch.int64, device=device) & _MASK
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return philox4x32((i, zero, zero, zero), (philox_key(seed), 1))[:2]


def _words4(seed, n: int, device) -> torch.Tensor:
    """The first ``n`` words of Philox4x32-10 counters (k, 0, 0, 0), key
    (seed, 2), taken in order: element ``4k + j`` is word ``j`` of counter
    ``k``. An (n,) int64 tensor of uint32 values, a quarter of the counters
    (and of the rounds' elementwise work) that one word a counter takes."""
    k = torch.arange((n + 3) // 4, dtype=torch.int64, device=device) & _MASK
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return torch.stack(philox4x32((k, zero, zero, zero), (philox_key(seed), 2)), dim=-1).reshape(-1)[:n]


def _unit(words: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in [0, 1) from their top 24 bits."""
    return (words >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform(seed, shape, device) -> torch.Tensor:
    """float32 uniforms in [0, 1) of ``shape`` from ``seed`` (an int or a
    one-element integer tensor on ``device``): element k is word 0 of
    counter k, in row-major order."""
    n = math.prod(shape)
    return _unit(_words(seed, n, device)[0]).reshape(shape)


def uniform4(seed, shape, device) -> torch.Tensor:
    """float32 uniforms in [0, 1) of ``shape`` from ``seed`` (an int or a
    one-element integer tensor on ``device``), four a counter: element
    ``4k + j`` (row-major) is word ``j`` of counter ``k``."""
    return _unit(_words4(seed, math.prod(shape), device)).reshape(shape)


def randint(seed, high: int, shape, device) -> torch.Tensor:
    """int64 integers in ``[0, high)`` of ``shape`` from ``seed``: the
    :func:`uniform4` stream's words modulo ``high`` (uniform with replacement,
    a bias below ``high / 2**32``)."""
    if not 1 <= high <= 1 << 32:
        raise ValueError(f"randint draws from [0, high) with 1 <= high <= 2**32; got {high}")
    return (_words4(seed, math.prod(shape), device) % high).reshape(shape)


def permutation(seed, n: int, device) -> torch.Tensor:
    """A permutation of ``range(n)`` (int64) from ``seed``: the order that
    sorts the :func:`uniform4` stream's first ``n`` words, ties by index
    (a stable sort), drawn on ``device`` with no host synchronization."""
    return torch.sort(_words4(seed, n, device), stable=True).indices


def normal(seed, shape, device) -> torch.Tensor:
    """float32 standard normals of ``shape`` from ``seed`` by Box-Muller:
    counter k gives elements 2k and 2k + 1 (row-major), ``r cos(2 pi v)`` and
    ``r sin(2 pi v)`` with ``r = sqrt(-2 log(1 - u))``, u and v from its words
    0 and 1."""
    n = math.prod(shape)
    w0, w1 = _words(seed, (n + 1) // 2, device)
    r = torch.sqrt(-2.0 * torch.log1p(-_unit(w0)))
    theta = (2.0 * math.pi) * _unit(w1)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1).reshape(-1)[:n].reshape(shape)
