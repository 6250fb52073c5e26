"""Metrics / logging sink (copy of ``rnagan_tpu/core/metrics.py``).

One :class:`MetricsLogger` writes a JSONL event log (when given a
``log_dir``), the console, and tensorboardX when it is importable and asked
for. It logs plain epoch means (:func:`epoch_means`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import torch


def epoch_means(per_step: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """The mean of per-step (0-dim tensor) metrics, summed in step order in
    float64 as the JAX loops sum them; one copy off the card."""
    if not per_step:
        return {}
    keys = list(per_step[0])
    table = torch.stack([torch.stack([m[k].float() for k in keys]) for m in per_step]).cpu().tolist()
    sums = dict.fromkeys(keys, 0.0)
    for row in table:
        for k, v in zip(keys, row):
            sums[k] += v
    return {k: v / len(table) for k, v in sums.items()}


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, use_tensorboard: bool = False, run_name: str = "run"):
        self.log_dir = log_dir
        self.run_name = run_name
        self._jsonl = None
        self._tb = None
        self._t0 = time.time()
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, f"{run_name}.jsonl"), "a", buffering=1)
            if use_tensorboard:
                try:
                    from tensorboardX import SummaryWriter

                    self._tb = SummaryWriter(log_dir=os.path.join(log_dir, "tb"))
                except ImportError:
                    self._tb = None

    def scalars(self, tag: str, values: Dict[str, float], step: int) -> None:
        rec = {"tag": tag, "step": step, "t": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in values.items()})
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb:
            for k, v in values.items():
                self._tb.add_scalar(f"{tag}/{k}", float(v), step)

    def console(self, msg: str) -> None:
        print(msg, flush=True)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
