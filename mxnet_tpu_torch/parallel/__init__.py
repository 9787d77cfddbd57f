"""Parallel layouts of the port (the collapsed single-device plan)."""
from .mesh import MeshPlan

__all__ = ["MeshPlan"]
