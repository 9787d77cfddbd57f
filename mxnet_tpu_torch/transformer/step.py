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

**The data axis** (``MeshPlan(data=D, ...)``): the D data ranks run in
turn, each on its rows of the batch, beside the sequence ranks (a loop
over data ranks around the leading sequence dimension, not a second
leading dimension).  Each data rank's loss and gradients are already
its sequence mean; the data ranks' are then averaged through the
collectives of ``parallel/comm.py`` (the reference's ``pmean`` over the
batch axes, ``:150-168``).

**ZeRO-1** (``zero=1``, :class:`TPZeroPlan`, ``:40-93,219-255``): after
the sequence mean, each data rank's flat local gradient is
reduce-scattered over ``data``; each data rank updates its ``(shard,)``
slice of the flat parameter space with its own optimizer state, and the
slices are all-gathered back into the parameters.  A pipelined plan
(item 8) is not ported and raises.
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["TPZeroPlan", "build_parts"]


class TPZeroPlan:
    """ZeRO-1 flat layout over the local parameter space of one model
    rank: local shards raveled f32 in ``param_names`` order, padded to
    the data-axis size K (the reference's ``TPZeroPlan``)."""

    def __init__(self, program, k_data):
        self.k = int(k_data)
        self.names = list(program.param_names)
        self.local_shapes = [program.local_shape(n) for n in self.names]
        self.sizes = [int(_np.prod(s)) if s else 1
                      for s in self.local_shapes]
        self.total = int(sum(self.sizes))
        self.padded = -(-self.total // self.k) * self.k
        self.shard = self.padded // self.k

    def describe(self):
        return {"k": self.k, "total": self.total, "padded": self.padded,
                "shard": self.shard}


def _unflatten(flat, plan):
    out, off = [], 0
    for shape, size in zip(plan.local_shapes, plan.sizes):
        out.append(flat[off:off + size].view(shape))
        off += size
    return tuple(out)


def build_parts(program, apply_update, state_leaf_counts, zero=0,
                zero_plan=None, compute_dtype=None, comm=None):
    """``(grads_part, update_part)``.  ``state_leaf_counts[i]`` is
    parameter ``i``'s optimizer-state leaf count (the leaves of all
    parameters concatenated in order); under ``zero=1`` each data rank
    instead holds one ``(shard,)`` slice of the :class:`TPZeroPlan`
    space per leaf.  ``comm`` carries the data axis (default: one rank).

    ``grads_part(train_vals, xs, ys, key=None) -> (grads, loss)`` with
    ``train_vals`` tensors that require grad and ``xs``/``ys`` one
    ``(K, b, T/K)`` chunk per data rank; ``grads`` are the data-mean
    gradients, or under ``zero=1`` each data rank's gradient shard.
    ``update_part(train_vals, state_leaves, grads, lr, t) -> (new_vals,
    new_leaves)``; under ``zero=1`` ``state_leaves`` holds one tuple of
    leaves per data rank."""
    from ..parallel.comm import InProcessComm
    from ..parallel.zero import _flatten_pad
    from ..precision import resolve_dtype
    if zero and zero_plan is None:
        raise ValueError("zero=1 needs a TPZeroPlan")
    dtype = resolve_dtype(compute_dtype)
    reduced = dtype != torch.float32
    if program.plan.present("pipe"):
        raise NotImplementedError("build_parts: a pipelined plan is "
                                  "ROADMAP.md queue A, item 8")
    if comm is None:
        comm = InProcessComm(1, None)

    def _to_compute(v):
        if reduced and v.is_floating_point():
            return v.to(dtype)
        return v

    def _rank(train_vals, x, y, key):
        vals = tuple(_to_compute(w) for w in train_vals)
        losses = program.loss_replica(vals, _to_compute(x), y, key)
        loss = losses.float().mean()
        grads = torch.autograd.grad(loss, tuple(train_vals))
        return grads, loss.detach()

    def grads_part(train_vals, xs, ys, key=None):
        per = [_rank(train_vals, x, y, key) for x, y in zip(xs, ys)]
        if len(per) == 1 and comm.k == 1 and not zero:
            return per[0]
        loss = comm.mean([l for _, l in per])
        if zero:
            rows = [_flatten_pad(g, zero_plan) for g, _ in per]
            return comm.reduce_scatter_mean(rows), loss
        grads = tuple(comm.mean(list(gs)) for gs in zip(*(g for g, _ in per)))
        return grads, loss

    def update_part(train_vals, state_leaves, grads, lr, t):
        if zero:
            flat_w = _flatten_pad(train_vals, zero_plan)
            shards = flat_w.view(comm.k, -1)
            new_sh, new_leaves = [], []
            for r, leaves, g_sh in zip(comm.local_ranks, state_leaves,
                                       grads):
                nw, nl = apply_update(0, shards[r], g_sh, tuple(leaves),
                                      lr, t)
                new_sh.append(nw)
                new_leaves.append(tuple(nl))
            comm.all_gather(new_sh, flat_w)
            return _unflatten(flat_w, zero_plan), new_leaves
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
