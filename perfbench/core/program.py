"""Readers of what the program records about its own work
(``rnagan_tpu_torch/core/profiling.py``), shared by the per-layer metrics:

* spans: host events ``rnagan.<span>`` in the profiled sub-window's trace;
* stages: the device operations between a stage's mark kernel
  (``rnagan_mark_<stage>``) and the next mark, summed;
* counters: the program's process-wide counters, at reading time.

A reader returns None where the program recorded nothing of the kind (a
program without these spans, marks or counters), never 0 for a missing record.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Iterator, Optional, Tuple

from perfbench.core import trace

SPAN_PREFIX = "rnagan."
MARK = re.compile(r"rnagan_mark_(\w+?)(?:\(|$)")
#: the mark that closes a step: what follows it belongs to no stage until the next mark
END = "end"


def span_ms(p: trace.Profile, name: str) -> Optional[float]:
    """Host ms a step or request inside span ``name``."""
    seconds = [e - s for n, s, e in p.host if n == SPAN_PREFIX + name]
    return 1e3 * sum(seconds) / p.units if seconds and p.units else None


def _mark(name: str) -> Optional[str]:
    m = MARK.search(name)
    return m.group(1) if m else None


def _staged(p: trace.Profile) -> Iterator[Tuple[Optional[str], str, float]]:
    """(stage, name, seconds) of every device operation other than a mark, in
    start order; stage None before the first mark and after an ``end``."""
    stage = None
    for n, s, e in sorted(p.device, key=lambda op: op[1]):
        m = _mark(n)
        if m is not None:
            stage = None if m == END else m
        else:
            yield stage, n, e - s


def stage_seconds(p: trace.Profile) -> Dict[Optional[str], float]:
    """Device seconds by stage over the sub-window (None: outside every stage)."""
    out: Dict[Optional[str], float] = defaultdict(float)
    for stage, _, seconds in _staged(p):
        out[stage] += seconds
    return out


def stage_ms(p: trace.Profile, *stages: str) -> Optional[float]:
    """Device ms a step or request in ``stages`` together; None unless one of them was marked."""
    marked = {_mark(n) for n, _, _ in p.device}
    if not p.units or not marked.intersection(stages):
        return None
    seconds = stage_seconds(p)
    return 1e3 * sum(seconds.get(s, 0.0) for s in stages) / p.units


def marks_ms(p: trace.Profile) -> Optional[float]:
    """Device ms a step or request of the mark kernels themselves."""
    seconds = [e - s for n, s, e in p.device if _mark(n) is not None]
    return 1e3 * sum(seconds) / p.units if seconds and p.units else None


def unmarked_share(p: trace.Profile) -> Optional[float]:
    """The share of device time (marks left out) outside every stage, %:
    before a step's first mark or after its ``end``, host-to-device copies
    (the table loads) excepted."""
    staged = list(_staged(p))
    total = sum(seconds for _, _, seconds in staged)
    if len(staged) == len(p.device) or total <= 0:
        return None
    outside = sum(seconds for stage, n, seconds in staged if stage is None and "HtoD" not in n)
    return 100.0 * outside / total


def idle_named_share(p: trace.Profile) -> Optional[float]:
    """Of the :data:`trace.GAPS_LABELLED` longest idle gaps of the device (the
    gaps ``trace.breakdown`` labels), the share of their time whose gap begins
    inside some program span, %."""
    spans = [(s, e) for n, s, e in p.host if n.startswith(SPAN_PREFIX)]
    if not spans:
        return None
    gaps, end = [], None
    for _, s, e in sorted(p.device, key=lambda op: op[1]):
        if end is not None and s > end:
            gaps.append((s - end, end))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, reverse=True)[:trace.GAPS_LABELLED]
    total = sum(length for length, _ in gaps)
    if total <= 0:
        return None
    named = sum(length for length, at in gaps if any(s <= at < e for s, e in spans))
    return 100.0 * named / total


def counter(name: str) -> Optional[float]:
    """The program's counter ``name`` now, or None where the program keeps no such counter."""
    try:
        from rnagan_tpu_torch.core import profiling
    except ImportError:
        return None
    value = getattr(profiling, "counters", {}).get(name)
    return None if value is None else float(value)


def counter_ratio(numerator: str, denominator: str) -> Optional[float]:
    """One counter over another, or None where either is missing or the second is 0."""
    num, den = counter(numerator), counter(denominator)
    return num / den if num is not None and den else None
