"""The rank mesh on ``torch.distributed`` (port of ``rnagan_tpu/parallel``):
``mesh`` lays the process group out as (data, model) and places batches and
parameters, ``collectives`` holds the differentiable all-reduce and gathers
the trainers' steps run through, ``launch`` starts a world."""

from rnagan_tpu_torch.parallel.mesh import (Mesh, init_distributed, make_mesh, pad_to_multiple,
                                            replicated, shard_batch, shard_dense_params)

__all__ = ["Mesh", "init_distributed", "make_mesh", "shard_batch", "replicated", "pad_to_multiple",
           "shard_dense_params"]
