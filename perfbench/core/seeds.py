"""Seeds of a run's parts, derived from ``--seed`` (any whole number up to 2**63)."""

from __future__ import annotations

import hashlib


def derive(seed: int, name: str) -> int:
    """A 31-bit seed for the part ``name`` of the run of ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF
