"""Transformer layers of the port: ``mxnet_tpu/transformer/layers.py``
for a plan with no ``model`` axis.

The JAX module spells each Megatron-sharded layer per replica with its
collectives over ``model``.  The port collapses that axis (``MeshPlan``
refuses ``model > 1`` until NCCL sharding lands), where every
collective is the identity: :func:`complete_psum`, :func:`copy_to_model`
and :func:`row_parallel_out`'s reduction pass the value through,
:func:`vocab_parallel_embedding` is a plain gather and
:func:`vocab_parallel_cross_entropy` a plain stable cross entropy.  The
functions keep their names and signatures so the programs read line for
line like the reference.

The ``sequence`` axis is the leading rank dimension of the activations
(``parallel/mesh.py``): :func:`sequence_offset` gives every rank's first
global position at once.

:func:`layer_norm` dispatches as the reference's does (``:110-126``):
float32 goes to ``ops.fused_optimizer.fused_layer_norm`` on every device —
the CUDA kernel on the card, its plain version on the CPU, the
reference's backward on both; another dtype (bfloat16 under a mixed
precision step) takes the reference's plain spelling, as
``fused_layernorm_enabled(dtype=bfloat16)`` is False there
(``mxnet_tpu/ops/fused_optimizer.py:81-82``).
"""
from __future__ import annotations

import torch

from ..ops.fused_optimizer import fused_layer_norm

__all__ = ["layer_norm", "column_parallel_dense", "row_parallel_out",
           "copy_to_model", "complete_psum", "vocab_parallel_embedding",
           "vocab_parallel_cross_entropy", "sequence_offset"]


def complete_psum(x, plan, axis="model"):
    """Sum per-rank partials over ``axis``: identity with the axis
    collapsed."""
    return x


def copy_to_model(x, plan):
    """Megatron's ``f`` operator: identity forward (and, with the axis
    collapsed, identity backward)."""
    return x


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the feature dim: the fused kernel for float32, the
    reference's plain spelling for another dtype."""
    if x.dtype == torch.float32:
        return fused_layer_norm(x, scale, bias, eps)
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


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


def sequence_offset(plan, t_local, device=None):
    """Global position of each sequence rank's first token, ``(K,)``: the
    axis shards tokens in order, so rank r starts at ``r * t_local`` (the
    stacked spelling of ``axis_index("sequence") * t_local``)."""
    return torch.arange(plan.size("sequence"), device=device) * t_local


def vocab_parallel_cross_entropy(logits_local, labels, plan):
    """Per-token causal-LM loss ``logsumexp(logits) - logits[label]``
    over the full vocab (the ``model`` axis is collapsed), with the
    reference's stable spelling: the max is stopped from the gradient
    (its gradient cancels exactly)."""
    m = logits_local.max(dim=-1).values.detach()
    sumexp = torch.exp(logits_local - m[..., None]).sum(dim=-1)
    picked = torch.gather(logits_local, -1,
                          labels.long()[..., None])[..., 0]
    return torch.log(sumexp) + m - picked
