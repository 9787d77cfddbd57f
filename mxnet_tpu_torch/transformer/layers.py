"""Transformer layers of the port: ``mxnet_tpu/transformer/layers.py``.

The reference spells each Megatron-sharded layer per replica, with its
collectives over the ``model`` axis explicit.  The port runs every rank
of that axis at once, as a **leading rank dimension of size Km** of the
activations (the ``vmap(axis_name="model")`` spelling, as the
``sequence`` ranks are spelled in ``parallel/mesh.py``): entry ``m`` of
dim 0 is model rank m's tensor.  Each function here takes and returns
tensors with that leading dimension (size 1 when the axis collapses),
and the reference's collectives become:

- ``psum`` over ``model``: a sum over dim 0, broadcast back to every
  rank;
- ``pmax``: an ``amax`` over dim 0;
- ``axis_index("model")``: an ``arange`` over dim 0.

The reference's custom backwards are kept exactly, as
``torch.autograd.Function``\\s:

- :func:`complete_psum` (Megatron's ``g``): the forward sums the ranks'
  partials, the backward is the **identity** — each rank's partial gets
  its own rank's cotangent (``:51-68``);
- :func:`copy_to_model` (Megatron's ``f``): the forward is the identity,
  the backward sums the ranks' partial cotangents (``:71-98``).

So the gradient of the sum of the Km ranks' losses is each rank's own
gradient of its own loss, as in the reference: a model-sharded
parameter's shard gets its rank's gradient.  A replicated parameter is
stored once and used by every rank; :func:`replicated` divides its
gradient by Km, so it comes out equal to one rank's (module docstring of
``transformer/step.py``).

``TP_ROW_PSUM`` is the reference's mutation seam: False deletes the
row-parallel output psum, the "forgot the all-reduce" bug, which the
tests show changes the ``model=2`` numbers.  Production code never
touches it.

:func:`layer_norm` dispatches as the reference's does (``:110-126``):
float32 goes to ``ops.fused_optimizer.fused_layer_norm`` on every device
— the CUDA kernel on the card, its plain version on the CPU, the
reference's backward on both; another dtype (bfloat16 under a mixed
precision step) takes the reference's plain spelling, as
``fused_layernorm_enabled(dtype=bfloat16)`` is False there
(``mxnet_tpu/ops/fused_optimizer.py:81-82``).
"""
from __future__ import annotations

import torch

from ..ops.fused_optimizer import fused_layer_norm

__all__ = ["TP_ROW_PSUM", "layer_norm", "column_parallel_dense",
           "row_parallel_out", "copy_to_model", "complete_psum",
           "replicated", "vocab_parallel_embedding",
           "vocab_parallel_cross_entropy", "sequence_offset"]

# the mutation seam (module docstring) — tests only
TP_ROW_PSUM = True


class _CompletePsum(torch.autograd.Function):
    """Sum over the rank dimension, broadcast back; identity backward."""

    @staticmethod
    def forward(ctx, x):
        return x.sum(0, keepdim=True).expand(x.shape)

    @staticmethod
    def backward(ctx, g):
        return g


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums over the rank dimension."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.sum(0, keepdim=True).expand(g.shape)


class _Replicated(torch.autograd.Function):
    """Identity forward; the backward divides by the rank count."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.k, None


def complete_psum(x, plan, axis="model"):
    """Sum the ranks' partials over the leading ``model`` dimension into
    the replicated value (identity backward); the identity when the axis
    collapses."""
    if plan.present(axis):
        return _CompletePsum.apply(x)
    return x


def copy_to_model(x, plan):
    """Megatron's ``f`` operator: identity forward, a sum over the
    ``model`` ranks backward, so a replicated activation entering a
    column-parallel region collects every rank's partial cotangent."""
    if plan.present("model"):
        return _CopyToModel.apply(x)
    return x


def replicated(w, plan):
    """A parameter replicated over ``model``, as every rank reads it: the
    value itself, whose gradient (the sum of the Km ranks' identical
    gradients) is divided by Km."""
    if plan.present("model"):
        return _Replicated.apply(w, plan.size("model"))
    return w


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the (replicated) feature dim: the fused kernel for
    float32, the reference's plain spelling for another dtype."""
    if x.dtype == torch.float32:
        return fused_layer_norm(x, scale, bias, eps)
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def column_parallel_dense(x, w_local, b_local=None):
    """``x @ W (+ b)`` per rank with W column-sharded: ``x`` is ``(Km,
    ..., d)``, ``w_local`` ``(Km, d, f/Km)``, ``b_local`` ``(Km, f/Km)``;
    no collective — the output's feature dim is the local shard."""
    km = x.shape[0]
    y = torch.matmul(x.reshape(km, -1, x.shape[-1]), w_local)
    y = y.view(x.shape[:-1] + (w_local.shape[-1],))
    if b_local is not None:
        y = y + b_local.view((km,) + (1,) * (y.dim() - 2) + (-1,))
    return y


def row_parallel_out(partial, plan, bias=None):
    """Complete a row-parallel matmul's partial sum over ``model`` and
    add the (replicated) bias AFTER the reduction."""
    if plan.present("model") and TP_ROW_PSUM:
        partial = _CompletePsum.apply(partial)
    if bias is not None:
        partial = partial + bias
    return partial


def sequence_offset(plan, t_local, device=None):
    """Global position of each sequence rank's first token, ``(Ks,)``:
    the axis shards tokens in order, so rank r starts at ``r * t_local``
    (the stacked spelling of ``axis_index("sequence") * t_local``; the
    same for every model rank)."""
    return torch.arange(plan.size("sequence"), device=device) * t_local


def _rank_offsets(km, v_local, like):
    """``axis_index("model") * v_local`` for every rank, shaped to
    broadcast over ``like`` with a leading rank dimension."""
    return (torch.arange(km, device=like.device) * v_local).view(
        (km,) + (1,) * like.dim())


def vocab_parallel_embedding(table_local, ids, plan):
    """Gather rows of the vocab-sharded ``(Km, V/Km, d)`` table for
    GLOBAL ``ids``: out-of-shard ids gather row 0 and are masked to zero,
    then one psum over ``model`` fills every position from whichever rank
    owns it.  Returns ``(Km, *ids.shape, d)``."""
    km, v_local = table_local.shape[0], table_local.shape[1]
    if not plan.present("model"):
        return table_local[0][ids][None]
    local = ids[None] - _rank_offsets(km, v_local, ids)
    in_range = (local >= 0) & (local < v_local)
    rank = torch.arange(km, device=ids.device).view(
        (km,) + (1,) * ids.dim())
    emb = table_local[rank, torch.where(in_range, local, 0)]
    emb = emb * in_range[..., None].to(emb.dtype)
    return _CompletePsum.apply(emb)


def vocab_parallel_cross_entropy(logits_local, labels, plan):
    """Per-token causal-LM loss over vocab-sharded ``(Km, ..., V/Km)``
    logits without materializing the full vocab row: the stable
    logsumexp's max rides ``pmax``, its sum of exponentials and the
    picked target logit ride ``psum``.  ``labels`` are GLOBAL vocab ids
    without the rank dimension.  The max is stopped from the gradient
    (its gradient cancels exactly), as in the reference."""
    m_local = logits_local.max(dim=-1).values.detach()
    labels = labels.long()
    if plan.present("model"):
        km, v_local = logits_local.shape[0], logits_local.shape[-1]
        m = m_local.amax(0, keepdim=True)
        sumexp = torch.exp(logits_local - m[..., None]).sum(dim=-1)
        sumexp = _CompletePsum.apply(sumexp)
        local = labels[None] - _rank_offsets(km, v_local, labels)
        in_range = (local >= 0) & (local < v_local)
        picked = torch.gather(logits_local, -1,
                              torch.where(in_range, local, 0)[..., None]
                              )[..., 0]
        picked = _CompletePsum.apply(picked * in_range.to(picked.dtype))
    else:
        m = m_local
        sumexp = torch.exp(logits_local - m[..., None]).sum(dim=-1)
        picked = torch.gather(logits_local, -1,
                              labels.expand(logits_local.shape[:-1])
                              [..., None])[..., 0]
    return torch.log(sumexp) + m - picked
