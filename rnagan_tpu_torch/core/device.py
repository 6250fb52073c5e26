"""Device selection for the port's entry points.

Entry points default to ``device="cuda"`` and raise when CUDA is absent:
nothing silently moves to the CPU. Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def compute_dtype(name: str) -> torch.dtype:
    """``"float32" | "bfloat16"`` -> torch dtype (params stay float32)."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
