"""Parallel tiers of the port: meshes (in-process ranks on one device,
or one rank per process over ``torch.distributed``) and their
collectives, ``MeshPlan``, ring / Ulysses / local attention, the ZeRO-1
runtime (``zero.py``) and ``DataParallelTrainer`` (the replicated, ZeRO-1
and mesh tiers)."""
from . import comm, zero
from .functional import accumulate_grads, functional_optimizer_update
from .mesh import (Mesh, MeshPlan, NamedSharding, PartitionSpec,
                   batch_sharded, data_parallel_mesh, local_device_count,
                   make_mesh, replicated)
from .ring_attention import (local_attention, ring_attention,
                             ring_attention_sharded, ulysses_attention,
                             ulysses_attention_sharded)
from .trainer import DataParallelTrainer

__all__ = ["comm", "zero", "Mesh", "MeshPlan", "NamedSharding",
           "PartitionSpec", "make_mesh", "data_parallel_mesh",
           "local_device_count", "replicated", "batch_sharded",
           "DataParallelTrainer", "accumulate_grads",
           "functional_optimizer_update", "local_attention",
           "ring_attention", "ring_attention_sharded", "ulysses_attention",
           "ulysses_attention_sharded"]
