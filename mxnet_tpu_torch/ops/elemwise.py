"""The elementwise additions the symbolic graphs emit: the part of
``mxnet_tpu/ops/elemwise.py`` this port runs (``elemwise_add`` with its
``_plus``/``_add`` aliases, and ``broadcast_add``), numpy broadcasting
as in the reference."""
from __future__ import annotations

from .registry import register

__all__ = ["elemwise_add", "broadcast_add"]


@register("elemwise_add", arg_names=["lhs", "rhs"], aliases=("_plus", "_add"))
def elemwise_add(lhs, rhs):
    """``lhs + rhs`` (reference: src/operator/tensor/elemwise_binary_op.cc)."""
    return lhs + rhs


@register("broadcast_add", arg_names=["lhs", "rhs"])
def broadcast_add(lhs, rhs):
    """``lhs + rhs`` with numpy broadcasting (reference:
    src/operator/tensor/elemwise_binary_broadcast_op_basic.cc)."""
    return lhs + rhs
