"""Run a function on every rank of a world.

Two ways in:

* :func:`spawn` starts ``world_size`` processes (``spawn`` start method) that
  join one process group over ``tcp://127.0.0.1:<free port>`` with the
  backend named by the caller (``gloo`` for CPU ranks and for several ranks
  on one card, ``nccl`` for one rank a card), call ``fn(rank, world_size,
  *args)`` and send back what it returns (tensors moved to the CPU). The
  tests and ``chip_smoke.py`` use it. A failing rank's traceback is raised
  in the caller, and every process is stopped before :func:`spawn` returns.
* :func:`from_environment` joins the group that torchrun describes
  (``torchrun --nproc_per_node N -m rnagan_tpu_torch.cli.gan_train ...``),
  for the CLIs.

``fn`` must be importable by name (defined at a module's top level; a
script's own functions are, since the children import the script again,
``__main__`` guard and all).
"""

from __future__ import annotations

import io
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def from_environment(backend: str) -> bool:
    """Join the process group that torchrun's environment describes, with
    ``backend``; False (and nothing joined) outside torchrun."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ or dist.is_initialized():
        return dist.is_initialized()
    from rnagan_tpu_torch.parallel.mesh import init_distributed

    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
    init_distributed(backend=backend)
    return True


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _pack(obj) -> bytes:
    """``obj`` as bytes (``torch.save``): sent by value, so a rank may exit
    before the caller reads it (a queued tensor would be shared memory)."""
    buf = io.BytesIO()
    torch.save(_to_cpu(obj), buf)
    return buf.getvalue()


def _child(rank: int, world_size: int, port: int, backend: str, threads: Optional[int],
           fn: Callable, args, results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        os.environ["LOCAL_RANK"] = str(rank)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world_size, rank=rank)
        try:
            out = _pack(fn(rank, world_size, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # the caller raises it with the rank's traceback
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world_size: int, *args: Any, backend: str, threads: Optional[int] = None,
          timeout: float = 600.0) -> List[Any]:
    """``[fn(rank, world_size, *args) for each rank]`` computed by
    ``world_size`` processes in one process group (see the module note).
    ``threads`` sets each child's ``torch.set_num_threads`` (1 keeps CPU
    worlds from oversubscribing the host). Raises if a rank fails or the
    world outlasts ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child, args=(r, world_size, port, backend, threads, fn, args, results),
                         daemon=True) for r in range(world_size)]
    for p in procs:
        p.start()
    outs, deadline = {}, time.monotonic() + timeout
    try:
        while len(outs) < world_size:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {world_size} ranks outlasted {timeout} s")
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank died with exit code {dead[0].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            outs[rank] = torch.load(io.BytesIO(out), weights_only=False)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [outs[r] for r in range(world_size)]
