"""Differentiable collectives of the data-parallel and tensor-parallel steps.

The JAX package needs none of this: under ``jit`` with sharded inputs XLA
turns a batch mean into a collective. Here each rank runs its own autograd,
so the collectives are ``torch.autograd.Function``s, and all of them are
built from ``all_reduce`` and ``broadcast`` alone, the two that gloo offers
for CUDA tensors: a gather is an all-reduce of a zero-filled buffer. That
lets two ranks share one card over gloo (NCCL refuses two ranks on one
device), and the same code runs one rank a card over NCCL.

**The convention (every trainer keeps it).** Each rank's objective is its
*share* of the global objective: a sum over its rows divided by the global
count, a term that every rank computes alike divided by the data-axis size.
Parameter gradients are then summed over the data group
(:func:`all_reduce_grads`), so the sum over ranks is the gradient of the
one-rank objective on the global batch, whatever couples the ranks in the
forward (BatchNorm over the group, a global gradient norm, NT-Xent's
negatives). Each Function's backward applies a Function again, so a double
backward (the WGAN-GP's) runs through them too.

**The two gathers.** A gather's backward depends on what consumes the
gathered tensor: when every rank computes the same value from it (the
β-VAE's model axis: the whole activation feeds the next layer and the
loss alike), each rank already holds the whole gradient and takes its slice
(``backward="slice"``); when the ranks compute different shares of one
objective from it (SimCLR's negatives), the gradient is all-reduced first
(``backward="sum"``). Mixing them up scales gradients by the group size. A
column-split layer differentiates only through its own columns, so its
input passes :func:`sum_gradients` (identity forward, all-reduce backward).

:func:`active` names the mesh whose groups the models read while a step
runs: ``models/batchnorm.py`` reduces its statistics over the data group,
``models/betavae.py`` gathers its split layers over the model group.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

_ACTIVE = contextvars.ContextVar("rnagan_mesh", default=None)


@contextlib.contextmanager
def active(mesh):
    """Run the models under ``mesh``'s groups (None: one device)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def data_group():
    """The data group of the active mesh, or None."""
    mesh = _ACTIVE.get()
    return None if mesh is None else mesh.data_group


def model_group():
    """The model group of the active mesh, or None."""
    mesh = _ACTIVE.get()
    return None if mesh is None else mesh.model_group


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad.contiguous(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``sum over the group of x``, differentiable (its backward is the same
    all-reduce of the incoming gradient); the identity without a group."""
    if group is None:
        return x
    return _AllReduceSum.apply(x.contiguous(), group)


class _SumGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad.contiguous(), ctx.group), None


def sum_gradients(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over the group: the input of a
    column-split layer, from which each rank differentiates its own columns
    only (Megatron's identity-forward, all-reduce-backward operator)."""
    if group is None:
        return x
    return _SumGradients.apply(x, group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, backward):
        size, index = dist.get_world_size(group), dist.get_rank(group)
        ctx.group, ctx.dim, ctx.backward, ctx.index, ctx.k = group, dim, backward, index, x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= size
        buf = x.new_zeros(shape)
        buf.narrow(dim, index * x.shape[dim], x.shape[dim]).copy_(x)
        dist.all_reduce(buf, group=group)  # x + 0 is exact: the gather is bit for bit
        return buf

    @staticmethod
    def backward(ctx, grad):
        if ctx.backward == "sum":
            grad = _AllReduceSum.apply(grad.contiguous(), ctx.group)
        return grad.narrow(ctx.dim, ctx.index * ctx.k, ctx.k), None, None, None


def gather(x: torch.Tensor, group, dim: int = 0, backward: str = "slice") -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order (every
    rank's ``x`` of one shape). ``backward="slice"`` when every rank computes
    the same value from the result, ``"sum"`` when the ranks compute
    different shares of one objective from it (see the module note)."""
    if backward not in ("slice", "sum"):
        raise ValueError(f"backward must be 'slice' or 'sum', not {backward!r}")
    if group is None:
        return x
    return _Gather.apply(x.contiguous(), group, dim % x.ndim, backward)


def all_reduce_grads(grads: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The gradients summed over ``group``: one all-reduce of one flat
    float32 bucket (a model's gradients in ``parameters()`` order)."""
    grads = [g.contiguous() for g in grads]
    if group is None:
        return grads
    with torch.no_grad():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        out, offset = [], 0
        for g in grads:
            out.append(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
    return out


def reduce_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Each rank's share of each scalar metric summed over ``group`` (one
    all-reduce of the stacked values): the global metric on every rank."""
    if group is None or not metrics:
        return metrics
    keys = sorted(metrics)
    with torch.no_grad():
        stacked = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        dist.all_reduce(stacked, group=group)
    return {k: stacked[i] for i, k in enumerate(keys)}


def broadcast_scalars(values: Dict[str, float], mesh, src: int = 0) -> Dict[str, float]:
    """Rank ``src``'s float values on every rank of the mesh (the keys must
    agree): decisions such as keeping the best epoch then agree too."""
    if mesh is None or mesh.world == 1 or not values:
        return values
    keys = sorted(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64, device=mesh.device)
    dist.broadcast(t, src=src)
    return {k: float(v) for k, v in zip(keys, t.tolist())}


def barrier(mesh) -> None:
    """Every rank of the mesh waits for the others (a one-element all-reduce
    on the rank's device, so it behaves alike under gloo and NCCL)."""
    if mesh is None or mesh.world == 1:
        return
    t = torch.zeros(1, device=mesh.device)
    dist.all_reduce(t)
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def global_count(mask: torch.Tensor, group) -> torch.Tensor:
    """The global number of valid rows (``mask`` 1): the mask sums
    all-reduced over ``group``, float32, at least 1."""
    with torch.no_grad():
        total = all_reduce_sum(mask.float().sum().reshape(1), group)[0]
    return torch.clamp(total, min=1.0)
