"""What the port records about its own work: host spans, device stage marks and counters.

All three read the clock of a ``torch.profiler`` trace, so a span, a mark
and the kernels around them line up on one timeline.

* :func:`span` names a piece of host work. While a profiler records, it is
  a ``record_function("rnagan.<name>")`` range (a ``user_annotation`` event
  in the trace, nested by time on its thread); otherwise it is one check
  and a shared no-op context.
* :func:`mark` names the stage of a step that the device work after it
  belongs to. It launches one empty kernel, ``rnagan_mark_<stage>``
  (``csrc/marks.cu``), on the current stream, only while a CUDA graph is
  being captured or a profiler records. A captured step then carries its
  stage boundaries into every replay, where no host range reaches: a
  stage's device time is the device work between its mark and the next.
  On the CPU, and on the card outside both, it launches nothing.
  :func:`nested` marks a stage inside another (``gan_attn`` inside
  whichever stage runs the attention) and marks the enclosing stage again
  when it ends, so the enclosing stage keeps the rest of its work.
* :func:`count` adds to a process-wide counter in :data:`counters` (plain
  numbers, always on), as the kernel wrappers count their ``launches``.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from rnagan_tpu_torch.kernels import _build

#: the stages :func:`mark` names, in the order of ``csrc/marks.cu``'s ``RNAGAN_STAGES``; ``end`` closes a step
STAGES = ("gan_ingest", "gan_encode", "gan_noise", "gan_g_forward", "gan_d_forward", "gan_gp", "gan_d_backward",
          "gan_d_adam", "gan_g_step", "gan_g_adam", "gan_stats", "gan_attn", "render",
          "vae_rows", "vae_mask", "vae_forward", "vae_backward", "vae_adam", "vae_stats",
          "synth_encode", "synth_noise", "synth_generator", "synth_quantize", "end")
_STAGE_INDEX = {s: i for i, s in enumerate(STAGES)}
#: the prefix of every span's name in a trace
SPAN_PREFIX = "rnagan."
#: the prefix of every mark kernel's name
MARK_PREFIX = "rnagan_mark_"

#: process-wide counters, by name (``graph.h2d_bytes``, ``graph.loaded_steps``, ``graph.capture_s``)
counters: Dict[str, float] = {}

_NO_SPAN = contextlib.nullcontext()
#: the stage :func:`mark` named last on this process (marked or not), which :func:`nested` resumes
_last = {"stage": "end"}


#: whether a profiler records on this process
recording = torch.autograd._profiler_enabled


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (never before CUDA is initialized)."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def span(name: str):
    """A context that names the host work inside it ``rnagan.<name>`` in a profiler's trace."""
    if not recording():
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


def mark(stage: str, device: torch.device) -> None:
    """Begin device stage ``stage`` (one of :data:`STAGES`) on ``device``'s current stream."""
    index = _STAGE_INDEX[stage]
    _last["stage"] = stage
    if not (recording() or _capturing()) or device.type != "cuda":
        return
    with torch.cuda.device(device):
        err = _build.library().rnagan_mark(index, torch.cuda.current_stream().cuda_stream)
    _build.check("rnagan_mark", err)


@contextlib.contextmanager
def nested(stage: str, device: torch.device):
    """Stage ``stage`` for the work inside; the stage marked before it begins again after it."""
    outer = _last["stage"]
    mark(stage, device)
    try:
        yield
    finally:
        mark(outer, device)


def count(name: str, n: float) -> None:
    """Add ``n`` to counter ``name``."""
    counters[name] = counters.get(name, 0) + n
