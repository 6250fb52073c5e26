"""One reader a per-layer metric: ``metrics/<name>.py`` defines ``read(r)`` over
``core/bench.py::Readings`` and returns the number, or None when the run gave
it nothing to read.

The readers that several metrics share live here. A quantity read in cells
that report different end-to-end metrics is one metric a kind of cell (each
metric moves one end-to-end metric), each a file that names its reader.
"""

from perfbench.counts.work import ADAM_BYTES_PER_PARAM


def category_ms(r, category: str):
    """Device ms a step or request of one kernel category (``core/trace.py::CATEGORIES``)."""
    ms = 1e3 * r.profile.device_s(cat=category) / r.profile.units
    return ms if ms > 0 else None


def entry_host_ms(r):
    """Host ms a step inside the training entry, blocking copies and table loads included."""
    calls = r.spans.get("entry")
    return 1e3 * sum(calls) / r.window.steps if calls and r.window.steps else None


def idle_share(r):
    """The device's idle share of the profiled steps or requests, %: 1 - (union
    of device operations) / (their CUDA-event time)."""
    return 100.0 * (1.0 - r.profile.busy_s() / r.profile.window_s) if r.profile.window_s > 0 else None


def mfu(r):
    """The whole step's or request's share of the card's peak, %: its required
    operations by precision (``counts/work.py``: bf16 at the bf16 dense peak,
    float32 at the float32 peak outside the tensor cores) over the window's
    measured time a step or request (host clock, no profiler)."""
    if not r.window.steps:
        return None
    least = r.counts["bf16_flop"] / r.peaks["bf16_flop_per_s"] + r.counts["fp32_flop"] / r.peaks["fp32_flop_per_s"]
    return 100.0 * least / (r.window.seconds / r.window.steps)


def k3_roofline(r):
    """K3's share of its roofline, %: its least time a step (28 bytes a
    parameter, ``counts/work.py``, at the HBM peak) over its device time a step."""
    seconds = r.profile.device_s(pattern="fused_adam") / r.profile.units
    if seconds <= 0:
        return None
    bound = ADAM_BYTES_PER_PARAM * r.counts["params"] / r.peaks["hbm_bytes_per_s"]
    return 100.0 * bound / seconds
