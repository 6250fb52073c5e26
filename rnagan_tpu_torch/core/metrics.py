"""Metrics / logging sink (copy of ``rnagan_tpu/core/metrics.py``).

One :class:`MetricsLogger` writes a JSONL event log (when given a
``log_dir``), the console, and tensorboardX when it is importable and asked
for. It logs plain epoch means (:func:`epoch_means`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def epoch_means(rows: torch.Tensor, keys: Sequence[str],
                preds: Optional[torch.Tensor] = None) -> Tuple[Dict[str, float], Optional[np.ndarray]]:
    """An epoch's per-step metric rows (steps, len(keys)) and, optionally, a
    vector of class predictions, off the card in one copy: the metrics'
    means, summed in step order in float64 as the JAX loops sum them ({}
    without steps), and the predictions as int64."""
    flat = rows.detach().float().reshape(-1)
    if preds is not None:
        flat = torch.cat([flat, preds.reshape(-1).to(flat.device, torch.float32)])
    host = flat.cpu()
    table = host[:rows.numel()].reshape(rows.shape).tolist()
    sums = [0.0] * len(keys)
    for row in table:
        sums = [a + b for a, b in zip(sums, row)]
    means = {k: v / len(table) for k, v in zip(keys, sums)} if table else {}
    return means, None if preds is None else host[rows.numel():].numpy().astype(np.int64)


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
