"""Explicit seed discipline (the port's counterpart of ``rnagan_tpu/core/rng.py``).

One run seed derives an integer seed for every (stream name, step, stage),
by hashing: the derivation is pure, so the same arguments give the same seed
in any process and in any order. The seeds feed the infused-noise kernel's
Philox stream (``kernels/infusion.py``) and the ``torch.Generator``s that
draw the GP's epsilon and standard-normal noise. Nothing draws from
PyTorch's global generator. The streams are the port's own: they do not
reproduce ``jax.random``'s bits, and the tests hand both packages the same
draws instead.
"""

from __future__ import annotations

import hashlib
import struct

import torch


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

    def generator(self, name: str, step: int = 0, stage: int = 0, device="cpu") -> torch.Generator:
        """A ``torch.Generator`` on ``device`` seeded for (``name``, ``step``, ``stage``)."""
        return torch.Generator(device=device).manual_seed(self.seed(name, step, stage))
