"""Rank mesh and batch placement on ``torch.distributed`` (port of
``rnagan_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a named (data, model) mesh and lets
XLA emit the collectives. Here every rank is one process with one device,
and :func:`make_mesh` lays the ranks of the process group out the same way:
rank ``r`` sits at data index ``r // model`` and model index ``r % model``
(the JAX mesh's ``reshape(data, model)``). A :class:`Mesh` holds this rank's
coordinates, the process groups of its two axes and its ``torch.device``.
Without an initialized process group it is the one-device mesh: every group
is None and every collective of ``parallel/collectives.py`` is the identity.

Data parallelism is the trainers' business (``parallel/collectives.py``
names the convention): each rank takes its rows of the global batch
(:func:`shard_batch`), computes its share of the global objective, and the
gradients are summed over the data group. Tensor parallelism is the β-VAE's:
:func:`shard_dense_params` keeps the JAX rule for which Dense layers split.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from rnagan_tpu_torch.core.config import MeshConfig
from rnagan_tpu_torch.core.device import resolve_device
from rnagan_tpu_torch.parallel import collectives


def init_distributed(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: str = "nccl") -> None:
    """Join the process group (``rnagan_tpu/parallel/mesh.py::init_distributed``).
    With no arguments it reads torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); else ``coordinator_address``
    is ``host:port`` of rank 0 and ``num_processes``, ``process_id`` the
    world size and this rank. ``backend`` is named, never guessed: ``nccl``
    for one rank a card, ``gloo`` for CPU ranks or several ranks on one card
    (NCCL refuses two ranks on one device)."""
    if coordinator_address is None:
        dist.init_process_group(backend)
        return
    if num_processes is None or process_id is None:
        raise ValueError("coordinator_address needs num_processes and process_id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) layout of the process group.

    ``data_group`` holds the ranks that share this rank's model index (they
    split the batch; gradients and batch statistics are reduced over it),
    ``model_group`` those that share its data index (they split the β-VAE's
    columns). Each is None when its axis has size 1."""

    cfg: MeshConfig
    world: int
    rank: int
    data: int
    model: int
    data_index: int
    model_index: int
    data_group: Any
    model_group: Any
    device: torch.device

    @property
    def shape(self):
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return {self.cfg.data_axis: self.data, self.cfg.model_axis: self.model}

    @property
    def writer(self) -> bool:
        """Whether this rank writes files (rank 0 writes, every rank reads)."""
        return self.rank == 0


def _rank_device(device) -> torch.device:
    """``"cuda"`` without an index is this rank's card, ``LOCAL_RANK`` (or the
    rank) modulo the cards visible; anything else is taken as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        resolve_device(dev)
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return resolve_device(dev)


def make_mesh(cfg: Optional[MeshConfig] = None, device="cuda") -> Mesh:
    """The (data, model) mesh of the process group (``cfg.data == -1``: every
    rank on the data axis), or the one-device mesh when none is
    initialized. Every rank calls it: it creates every axis group, in one
    order, on every rank."""
    cfg = cfg or MeshConfig()
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    model = cfg.model
    data = cfg.data if cfg.data > 0 else max(1, world // max(1, model))
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} devices")
    data_group = model_group = None
    if world > 1:
        for j in range(model):  # the data axis: ranks with model index j
            group = dist.new_group([i * model + j for i in range(data)]) if data > 1 else None
            if j == rank % model:
                data_group = group
        for i in range(data):  # the model axis: ranks with data index i
            group = dist.new_group([i * model + j for j in range(model)]) if model > 1 else None
            if i == rank // model:
                model_group = group
    return Mesh(cfg, world, rank, data, model, rank // model, rank % model, data_group, model_group,
                _rank_device(device))


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m) if m > 1 else n


def local_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows ``[i*n/D, (i+1)*n/D)`` of a global batch of ``n``."""
    if n % mesh.data:
        raise ValueError(f"a global batch of {n} rows does not split over {mesh.data} data ranks; "
                         "pad it to a multiple (pad_to)")
    k = n // mesh.data
    return slice(mesh.data_index * k, (mesh.data_index + 1) * k)


def shard_batch(batch: Any, mesh: Mesh, local: bool = False) -> Any:
    """This rank's rows of a global batch: a dict, list or tuple of arrays or
    tensors (leading dimension the batch; None and scalars pass). The global
    batch must divide by the data-axis size: callers pad it (``pad_to``).
    ``local=True`` passes through a batch that this process already holds
    alone (each process read its own rows: the JAX package's multi-host
    branch, ``rnagan_tpu/parallel/mesh.py:107-114``)."""
    if local or mesh.data == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    if batch is None or np.ndim(batch) == 0:
        return batch
    return batch[local_rows(len(batch), mesh)]


def replicated(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Broadcast the first data rank's ``tensors`` (parameters, statistics,
    optimizer moments) to the other ranks of this rank's data group, in
    place, one flat buffer per dtype: at ``init_state`` every replica starts
    from rank 0's numbers whatever its own init drew."""
    if mesh.data_group is None:
        return
    src = mesh.model_index  # global rank of (data 0, this model index)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src=src, group=mesh.data_group)
            offset = 0
            for t in ts:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def module_tensors(module: nn.Module):
    """A module's parameters and buffers (what :func:`replicated` sends)."""
    return [*module.parameters(), *module.buffers()]


@torch.no_grad()
def shard_dense_params(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Tensor-parallel placement (``rnagan_tpu/parallel/mesh.py::shard_dense_params``):
    every ``nn.Linear`` whose output width divides the model-axis size keeps
    only this rank's block of output features (rows of the torch weight, the
    columns of the flax kernel) and of its bias, and so does every
    ``BatchNorm1d`` of a width that divides (scale, bias, running mean and
    variance); everything else stays whole. A split module records
    ``model_split = (index, size)``; the forward gathers its outputs over
    the model group (``models/betavae.py``). In place; returns ``module``."""
    j = mesh.model_index
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.BatchNorm1d)):
            width = m.out_features if isinstance(m, nn.Linear) else m.num_features
            if mesh.model == 1 or width % mesh.model:
                continue
            k = width // mesh.model
            for name in ("weight", "bias", "running_mean", "running_var"):
                t = getattr(m, name, None)
                if t is None:
                    continue
                part = t[j * k:(j + 1) * k].clone()
                if isinstance(t, nn.Parameter):
                    setattr(m, name, nn.Parameter(part, requires_grad=t.requires_grad))
                else:
                    setattr(m, name, part)
            if isinstance(m, nn.Linear):
                m.out_features = k
            else:
                m.num_features = k
            m.model_split = (j, mesh.model)
    return module


@torch.no_grad()
def full_state_dict(module: nn.Module, mesh: Mesh):
    """``module.state_dict()`` with every split tensor gathered over the model
    group (the inverse of :func:`shard_dense_params`): the state_dict a
    one-device model of the same configuration has. Every rank of the model
    group calls it."""
    split = {name for name, m in module.named_modules() if getattr(m, "model_split", None)}
    out = {}
    for key, t in module.state_dict().items():
        owner, _, leaf = key.rpartition(".")
        if owner in split and leaf in ("weight", "bias", "running_mean", "running_var"):
            t = collectives.gather(t, mesh.model_group, dim=0)
        out[key] = t
    return out
