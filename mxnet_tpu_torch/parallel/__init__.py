"""Parallel tiers of the port: the collapsed single-device ``MeshPlan``
and the single-device replicated ``DataParallelTrainer``."""
from .mesh import MeshPlan
from .trainer import DataParallelTrainer

__all__ = ["MeshPlan", "DataParallelTrainer"]
