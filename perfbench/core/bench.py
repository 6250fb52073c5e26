"""One run of one cell: set-up, the measured window, the traced sub-window, the comparison.

A driver (``drivers/<name>.py``, named by the cell's traffic file) defines
``Runner(ctx)`` with:

* ``setup()``: build the program's objects from the seed, drive the first
  steps through the window's own call and record what the comparison needs,
  and warm up every shape the window uses;
* ``unit() -> Unit``: one epoch, chunk or request of the window, ending with
  the device idle;
* ``profile_unit() -> int``: a few steps or requests for the profiler;
  returns how many;
* ``end_to_end(window) -> dict``: the end-to-end metrics it can give;
* ``counts() -> dict``: the work of a step or request, from the shapes;
* ``check() -> dict``: frees the program's state, runs the reference and
  returns the numbers that ``limits/<cell>.json`` holds limits for;
* ``mark`` and ``per_unit``: the kernel whose records split the trace into
  steps (``core/trace.py``), and how many of them a step launches.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from perfbench.core import compare, device as dev_mod, trace as trace_mod
from perfbench.core.device import PEAKS
from perfbench.core.spec import Cell, merge

#: profiled sub-windows a traced run tries before it fails: the profiler drops a kernel record now and then
#: (one K3 record of 250 in one of ten traced β-VAE runs), and a refused trace gives no number
TRACE_ATTEMPTS = 3
#: top-level module names that no run may load
BANNED = ("jax", "jaxlib", "flax", "optax", "rnagan_tpu")


@dataclass
class Unit:
    steps: int
    work: int
    latencies: List[float] = field(default_factory=list)


class Spans:
    """Host-clock spans of the traced run's window, by name (seconds). In the
    profiled sub-window (``labelling``) a span only names the host's work in
    the trace; outside a traced run ``span`` does nothing."""

    def __init__(self, active: bool):
        self.active = active
        self.recording = False
        self.labelling = False
        self.seconds: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.recording:
            if self.labelling:
                with torch.profiler.record_function("perfbench." + name):
                    yield
            else:
                yield
            return
        with torch.profiler.record_function("perfbench." + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


@dataclass
class Context:
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    device: torch.device
    spans: Spans


@dataclass
class Window:
    seconds: float
    steps: int
    work: int
    latencies: List[float]


@dataclass
class Readings:
    """What a per-layer metric's reader (``metrics/<name>.py``, ``read(r)``) reads."""

    window: Window
    spans: Dict[str, List[float]]
    profile: trace_mod.Profile
    counts: Dict[str, Any]
    peaks: Dict[str, float] = field(default_factory=lambda: dict(PEAKS))


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between order statistics."""
    xs = sorted(values)
    at = (len(xs) - 1) * q / 100.0
    lo = int(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


def run(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device, started: float,
        shrink: Optional[Dict[str, Dict[str, Any]]] = None,
        log: Callable[[str], None] = lambda s: print(s, file=sys.stderr)) -> Dict[str, Any]:
    """The cell's result line (a dict, in the contract's key order)."""
    shrink = shrink or {}
    spans = Spans(traced)
    ctx = Context(merge(cell.config, shrink.get("config", {})), merge(cell.traffic, shrink.get("traffic", {})),
                  int(seed), device, spans)
    runner = cell.driver().Runner(ctx)
    runner.setup()
    dev_mod.sync(device)
    setup_s = time.perf_counter() - started
    log(f"card before the window: {dev_mod.card_sample(device)}; devices {torch.cuda.device_count()}")
    spans.recording = traced
    steps = work = 0
    latencies: List[float] = []
    t0 = time.perf_counter()
    while True:
        u = runner.unit()
        steps, work = steps + u.steps, work + u.work
        latencies += u.latencies
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    spans.recording = False
    window = Window(elapsed, steps, work, latencies)
    log(f"card after the window: {dev_mod.card_sample(device)}; {steps} steps, {work} samples in {elapsed:.6f} s")
    metrics = {}
    e2e = {**runner.end_to_end(window), "setup_s": setup_s}
    result: Dict[str, Any] = {"correct": False, "attempted": steps, "failed": 0}
    breakdown = None
    busy = None
    if traced:
        spans.labelling = True
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            prof = trace_mod.profile(runner.profile_unit, device)
            try:
                trace_mod.check_complete(prof, runner.mark, runner.per_unit)
                break
            except trace_mod.IncompleteTrace as e:
                log(f"profiled sub-window {attempt} of {TRACE_ATTEMPTS} refused: {e}")
                if attempt == TRACE_ATTEMPTS:
                    raise
        spans.labelling = False
        readings = Readings(window, spans.seconds, prof, runner.counts())
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        busy = {"busy_s": prof.busy_s(), "window_s": prof.window_s}
        breakdown = trace_mod.breakdown(prof)
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    described = dev_mod.describe(device, 1)
    if busy:
        described.update(busy)
    numbers = runner.check()
    del runner
    gc.collect()
    checks = compare.judge(numbers, cell.limits)
    result.update(correct=compare.passes(checks), metrics=metrics, device=described)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def banned_modules() -> List[str]:
    return sorted({name for name in sys.modules if name.split(".")[0] in BANNED})

