"""The device a run uses: synchronization, its name and memory peak, the card's clocks,
and the table of peaks every roofline and utilization is taken against."""

from __future__ import annotations

import subprocess
import sys
from typing import Any, Dict

import torch

#: NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAKS = {"hbm_bytes_per_s": 3.35e12, "bf16_flop_per_s": 989e12, "tf32_flop_per_s": 495e12,
         "fp32_flop_per_s": 67e12}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def require_cards(chips: int) -> None:
    """Exit without a result unless CUDA holds ``chips`` cards."""
    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is false: no result without the card", file=sys.stderr)
        raise SystemExit(3)
    if torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} cards, CUDA holds {torch.cuda.device_count()}", file=sys.stderr)
        raise SystemExit(3)


def describe(device: torch.device, count: int) -> Dict[str, Any]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def card_sample(device: torch.device) -> str:
    """The card's name, power limit, SM clock and temperature from ``nvidia-smi`` (one line)."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--id={device.index or 0}",
                              "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu,power.draw",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"
