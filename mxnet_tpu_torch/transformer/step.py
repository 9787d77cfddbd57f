"""The mesh-tier train step: the port of ``build_parts`` of
``mxnet_tpu/transformer/step.py``.

``build_parts`` produces the two halves of the step over a
:class:`~.model.MeshProgram`:

- ``grads_part``: forward and backward of the per-rank losses
  (``loss_replica``, ``(K,)``) and their mean over the ``sequence``
  ranks.  That mean is the reference's ``pmean`` of the loss and of every
  gradient over the batch axes (``:150-151``, ``:166-168``): the
  parameters are shared by the K ranks of the stacked spelling, so
  autograd of the mean sums each rank's gradient and divides by K, and
  the ring backward has already routed the cross-rank cotangents once.
- ``update_part``: the optimizer applied parameter by parameter through
  a caller-supplied ``apply_update`` (the trainer passes the optimizer's
  own rule via ``functional_optimizer_update``), the loop of
  ``:186-194``.

``compute_dtype`` (mixed precision, ``:95-150``): the parameters stay
f32 — they are the masters — and are cast with the batch to the compute
dtype at the loss boundary, so activations run in bfloat16 while the
gradients come back f32 through the cast and the loss is returned f32.
No loss scaling here, as in the reference: bfloat16 has f32's exponent.

``zero`` (ZeRO-1, ROADMAP.md queue A item 6) and a pipelined plan (item
8) are not ported and raise.
"""
from __future__ import annotations

import torch

__all__ = ["build_parts"]


def build_parts(program, apply_update, state_leaf_counts, zero=0,
                zero_plan=None, compute_dtype=None):
    """``(grads_part, update_part)``.  ``state_leaf_counts[i]`` is
    parameter ``i``'s optimizer-state leaf count (the leaves of all
    parameters concatenated in order).

    ``grads_part(train_vals, x, y, key=None) -> (grads, loss)`` with
    ``train_vals`` tensors that require grad and ``x``/``y`` the
    ``(K, B, T/K)`` chunks; ``update_part(train_vals, state_leaves,
    grads, lr, t) -> (new_vals, new_leaves)``."""
    if zero or zero_plan is not None:
        raise NotImplementedError("build_parts(zero=1): ZeRO-1 over NCCL is "
                                  "ROADMAP.md queue A, item 6")
    from ..precision import resolve_dtype
    dtype = resolve_dtype(compute_dtype)
    reduced = dtype != torch.float32
    if program.plan.present("pipe"):
        raise NotImplementedError("build_parts: a pipelined plan is "
                                  "ROADMAP.md queue A, item 8")

    def _to_compute(v):
        if reduced and v.is_floating_point():
            return v.to(dtype)
        return v

    def grads_part(train_vals, x, y, key=None):
        vals = tuple(_to_compute(w) for w in train_vals)
        losses = program.loss_replica(vals, _to_compute(x), y, key)
        loss = losses.float().mean()
        grads = torch.autograd.grad(loss, tuple(train_vals))
        return grads, loss.detach()

    def update_part(train_vals, state_leaves, grads, lr, t):
        new_vals, new_leaves, off = [], [], 0
        for i, (w, g) in enumerate(zip(train_vals, grads)):
            n = state_leaf_counts[i]
            leaves = tuple(state_leaves[off:off + n])
            off += n
            nw, nl = apply_update(i, w, g, leaves, lr, t)
            new_vals.append(nw)
            new_leaves.extend(nl)
        return tuple(new_vals), tuple(new_leaves)

    return grads_part, update_part
