"""Transformer layers of the port: ``mxnet_tpu/transformer/layers.py``
for a plan with no ``model`` axis.

The JAX module spells each Megatron-sharded layer per replica with its
collectives over ``model``.  The port runs the collapsed plan only
(``MeshPlan`` refuses ``model > 1`` until NCCL sharding lands), where
every collective is the identity: :func:`complete_psum`,
:func:`copy_to_model` and :func:`row_parallel_out`'s reduction pass the
value through, and :func:`vocab_parallel_embedding` is a plain gather.
The functions keep their names and signatures so the decode program
reads line for line like the reference.

:func:`layer_norm` routes to ``ops.fused_optimizer.fused_layer_norm`` on
every device — the CUDA kernel on the card, its plain version on the
CPU.  ``vocab_parallel_cross_entropy`` is training and waits.
"""
from __future__ import annotations

from ..ops.fused_optimizer import fused_layer_norm

__all__ = ["layer_norm", "column_parallel_dense", "row_parallel_out",
           "copy_to_model", "complete_psum", "vocab_parallel_embedding"]


def complete_psum(x, plan, axis="model"):
    """Sum per-rank partials over ``axis``: identity with the axis
    collapsed."""
    return x


def copy_to_model(x, plan):
    """Megatron's ``f`` operator: identity forward (and, with the axis
    collapsed, identity backward)."""
    return x


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the feature dim through the fused kernel."""
    return fused_layer_norm(x, scale, bias, eps)


def column_parallel_dense(x, w_local, b_local=None):
    """``x @ W (+ b)``: no collective."""
    y = x @ w_local
    if b_local is not None:
        y = y + b_local
    return y


def row_parallel_out(partial, plan, bias=None):
    """Complete a row-parallel matmul's partial sum (identity with the
    axis collapsed) and add the bias AFTER the reduction."""
    if bias is not None:
        partial = partial + bias
    return partial


def vocab_parallel_embedding(table_local, ids, plan):
    """Gather rows of the ``(V, d)`` table for token ids."""
    return table_local[ids]
