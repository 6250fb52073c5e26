"""The traced run's profiled sub-window and what is read from it.

``torch.profiler`` records a few steps or requests; its Chrome trace gives
every device operation (kernels, copies, fills) and every host event with
start and duration on one clock. Before any number is read from it, the
trace is checked against what the benchmark counted itself:

* every kernel that a wrapper's ``launches`` counter counts appears in the
  trace exactly as often as the counter rose (:data:`COUNTED`);
* the steps are alike: between every ``per_unit``-th record of the marking
  kernel (K3 for training, K2 for synthesis) the trace holds the same number
  of kernel records, so no replay lost records (the first step is left out:
  ``fit``'s first step has no running sums to add to);
* the device operations span at least :data:`MIN_SPAN` of the CUDA-event
  time of the same steps, and their union never exceeds it.

A trace that fails raises :class:`IncompleteTrace`: no number comes from it.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

#: kernel-name pattern of each counted kernel, and the counter that counts its launches
COUNTED = {"fused_adam": ("rnagan_tpu_torch.kernels.fused_adam", "fused_adam"),
           "tanh_to_uint8": ("rnagan_tpu_torch.kernels.quantize", "tanh_to_uint8"),
           "infused_noise": ("rnagan_tpu_torch.kernels.infusion", "infused_noise")}
#: the least share of the CUDA-event time that the traced device operations span
MIN_SPAN = 0.85
#: the longest idle gaps that the breakdown labels by their host event
GAPS_LABELLED = 300
#: device operation categories: first match wins
CATEGORIES = (("K3 fused_adam", ("fused_adam",)), ("K1 infused_noise", ("infused_noise",)),
              ("K2 tanh_to_uint8", ("tanh_to_uint8",)),
              ("convolution", ("conv", "dgrad", "wgrad", "fprop", "cudnn", "implicit")),
              ("gemm", ("gemm", "cublas", "cutlass")), ("reduction", ("reduce",)),
              ("copy", ("memcpy",)), ("fill", ("memset",)))


class IncompleteTrace(RuntimeError):
    pass


def category(name: str) -> str:
    n = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in n for k in keys):
            return cat
    return "elementwise and other"


@dataclass
class Profile:
    """Device operations and host events (name, start s, end s) of the profiled
    sub-window, its CUDA-event length, the steps or requests it held and the
    counters' rises over it."""

    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    window_s: float
    units: int
    counters: Dict[str, int] = field(default_factory=dict)

    def kernels(self, pattern: str) -> List[Tuple[str, float, float]]:
        return [op for op in self.device if pattern in op[0]]

    def device_s(self, pattern: Optional[str] = None, cat: Optional[str] = None) -> float:
        """Summed device seconds of the operations whose name holds ``pattern`` or of category ``cat``."""
        return sum(e - s for n, s, e in self.device
                   if (pattern is None or pattern in n) and (cat is None or category(n) == cat))

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union of their intervals)."""
        total, end = 0.0, float("-inf")
        for _, s, e in sorted(self.device, key=lambda op: op[1]):
            if e > end:
                total += e - max(s, end)
                end = e
        return total


def _counter_values() -> Dict[str, int]:
    import importlib

    out = {}
    for pattern, (module, attr) in COUNTED.items():
        out[pattern] = int(getattr(getattr(importlib.import_module(module), attr), "launches"))
    return out


def profile(fn: Callable[[], int], device: torch.device) -> Profile:
    """Run ``fn()`` (which returns the steps or requests it ran, ending with the
    device idle) under the profiler, timed by CUDA events."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize(device)
    before = _counter_values()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        units = fn()
        end.record()
        torch.cuda.synchronize(device)
    window_s = start.elapsed_time(end) / 1e3
    after = _counter_values()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    dev, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = str(ev.get("cat", "")).lower()
        item = (str(ev.get("name", "")), float(ev["ts"]) / 1e6, (float(ev["ts"]) + float(ev["dur"])) / 1e6)
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            name = item[0] if cat == "kernel" else f"{cat[4:]}: {item[0]}"
            dev.append((name, item[1], item[2]))
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            host.append(item)
    return Profile(dev, host, window_s, units, {k: after[k] - before[k] for k in before})


def check_complete(p: Profile, mark: str, per_unit: int) -> None:
    """Raise :class:`IncompleteTrace` unless the trace holds every counted
    kernel, alike steps and the CUDA-event time (module docstring)."""
    if not p.device:
        raise IncompleteTrace("the trace holds no device operation")
    for pattern, rise in p.counters.items():
        seen = len(p.kernels(pattern))
        if seen != rise:
            raise IncompleteTrace(f"{pattern}: {seen} kernel records in the trace, {rise} launches counted")
    if len(p.kernels(mark)) < per_unit * p.units:
        raise IncompleteTrace(f"{mark}: {len(p.kernels(mark))} records for {p.units} units of {per_unit}")
    kernels = sorted((op for op in p.device if not op[0].startswith(("memcpy", "memset"))), key=lambda op: op[1])
    marks = [i for i, op in enumerate(kernels) if mark in op[0]][per_unit - 1::per_unit]
    sizes = Counter(b - a for a, b in zip(marks[1:], marks[2:]))  # the first step may differ (warm host state)
    if len(sizes) > 1:
        raise IncompleteTrace(f"steps differ in their kernel records: {dict(sizes)} (records per step: count)")
    span = max(e for _, _, e in p.device) - min(s for _, s, _ in p.device)
    if span < MIN_SPAN * p.window_s or p.busy_s() > 1.01 * p.window_s:
        raise IncompleteTrace(f"device operations span {span:.6f} s, busy {p.busy_s():.6f} s, "
                              f"of {p.window_s:.6f} s by CUDA events")


def breakdown(p: Profile, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle gaps
    (the :data:`GAPS_LABELLED` longest) summed by the innermost host event
    (benchmark span or operator) running when each gap began."""
    ops: Dict[str, float] = defaultdict(float)
    for n, s, e in p.device:
        ops[re.sub(r"\s+", " ", n)[:120]] += e - s
    found, end = [], None
    for _, s, e in sorted(p.device, key=lambda op: op[1]):
        if end is not None and s > end:
            found.append((s - end, end))
        end = e if end is None else max(end, e)
    names = [h[0] for h in p.host]
    starts = np.array([h[1] for h in p.host]) if p.host else np.zeros(0)
    ends = np.array([h[2] for h in p.host]) if p.host else np.zeros(0)
    gaps: Dict[str, float] = defaultdict(float)
    for length, at in sorted(found, reverse=True)[:GAPS_LABELLED]:
        inside = np.flatnonzero((starts <= at) & (ends > at))
        label = names[inside[np.argmin(ends[inside] - starts[inside])]] if len(inside) else "no host event"
        gaps[label[:120]] += length
    order = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": order(ops), "idle_gaps": order(gaps)}
