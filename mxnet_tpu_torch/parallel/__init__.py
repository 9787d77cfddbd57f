"""Parallel tiers of the port: ``MeshPlan`` (its ranks on one device),
ring / Ulysses / local attention, and ``DataParallelTrainer`` (the
single-device replicated tier and the mesh tier)."""
from .mesh import MeshPlan
from .ring_attention import (local_attention, ring_attention,
                             ring_attention_sharded, ulysses_attention,
                             ulysses_attention_sharded)
from .trainer import DataParallelTrainer

__all__ = ["MeshPlan", "DataParallelTrainer", "local_attention",
           "ring_attention", "ring_attention_sharded", "ulysses_attention",
           "ulysses_attention_sharded"]
