"""Explicit seed discipline (the port's counterpart of ``rnagan_tpu/core/rng.py``).

One run seed derives an integer seed for every (stream name, step, stage),
by hashing: the derivation is pure, so the same arguments give the same seed
in any process and in any order. :meth:`SeedStream.table` gives the seeds of
a run of steps as one int64 tensor, the table a training step captured in a
CUDA graph reads its seeds from (``train/step_graph.py``).

The seeds key Philox4x32-10 streams (``kernels/infusion.py``): the
infused-noise kernel's uniforms, and :func:`uniform` and :func:`normal`, the
GP's epsilon and the standard-normal noise of a training step. A seed is a
host int or a one-element integer tensor on the device; both give the same
bits, so a captured step draws what the eager step draws. ``torch.Generator``s
seeded here (:meth:`SeedStream.generator`) draw everything else. Nothing draws
from PyTorch's global generator. The streams are the port's own: they do not
reproduce ``jax.random``'s bits, and the tests hand both packages the same
draws instead.
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


def _unit(words: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in [0, 1) from their top 24 bits."""
    return (words >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform(seed, shape, device) -> torch.Tensor:
    """float32 uniforms in [0, 1) of ``shape`` from ``seed`` (an int or a
    one-element integer tensor on ``device``): element k is word 0 of
    counter k, in row-major order."""
    n = math.prod(shape)
    return _unit(_words(seed, n, device)[0]).reshape(shape)


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
