"""The mesh-tier train step: the port of ``build_parts`` of
``mxnet_tpu/transformer/step.py``.

``build_parts`` produces the two halves of the step over a
:class:`~.model.MeshProgram`:

- ``grads_part``: forward and backward of the per-rank losses
  (``loss_replica``, ``(Km, Ks)``: a leading dimension per ``model`` and
  ``sequence`` rank), then the reference's ``pmean`` of the loss and of
  every gradient over the batch axes (``:150-151``, ``:166-168``).
  In the reference each replica differentiates its OWN loss, and the
  losses and gradients are averaged over ``data`` and ``sequence`` only;
  model-sharded parameters keep their per-shard gradients (``:8-12``).
  The stacked spelling differentiates ONE scalar: the **sum** over the
  Km model ranks (the custom backwards of ``layers.py`` route each
  rank's cotangent to its own shard, so a shard's gradient is its
  rank's; a mean would scale it by 1/Km) of the **mean** over the Ks
  sequence ranks (the parameters are shared by the ranks of the stacked
  spelling, so autograd of the mean sums each rank's gradient and
  divides by Ks, and the ring backward has already routed the
  cross-rank cotangents once).  A replicated parameter is read by all
  Km ranks and would collect Km copies of its gradient;
  ``layers.replicated`` divides them back, so it comes out equal to one
  rank's.  The loss reported is model rank 0's (the Km are equal).
- ``update_part``: the optimizer applied parameter by parameter through
  a caller-supplied ``apply_update`` (the trainer passes the optimizer's
  own rule via ``functional_optimizer_update``), the loop of
  ``:186-194``; on the global parameters, as the optimizer is
  elementwise.

``compute_dtype`` (mixed precision, ``:95-150``): the parameters stay
f32 — they are the masters — and are cast with the batch to the compute
dtype at the loss boundary, so activations run in bfloat16 while the
gradients come back f32 through the cast and the loss is returned f32.
No loss scaling here, as in the reference: bfloat16 has f32's exponent.

**The data axis** (``MeshPlan(data=D, ...)``): the D data ranks run in
turn, each on its rows of the batch, around the model and sequence
dimensions (a loop over data ranks, not a third leading dimension).
Each data rank's loss and gradients are already its sequence mean; the
data ranks' are then averaged through the collectives of
``parallel/comm.py`` (the reference's ``pmean`` over the batch axes,
``:150-168``).

**ZeRO-1** (``zero=1``, :class:`TPZeroPlan`, ``:40-93,219-255``): one
flat local space per model rank (its shards raveled in ``param_names``
order, padded to the data-axis size), sharded over ``data``: the flat
axes are ``("model", "data")``, the reference's, so ZeRO checkpoints
cross between the packages.  After the sequence mean, each data rank's
``(Km, padded)`` flat gradients are laid out data-major, ``(K, Km,
shard)`` (a view at Km = 1), and go through the comm's reduce-scatter
over ``data``; data rank d updates the ``(Km, shard)`` slice it owns
(one optimizer call on its ``Km * shard`` contiguous elements, with its
own state), and the comm's all-gather writes the slices back before the
parameters are unraveled.  A pipelined plan
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


def _flatten_ranks(program, vals, plan):
    """Each model rank's flat local space, ``(Km, padded)`` f32: its
    shards raveled in ``param_names`` order, zero-padded (the reference's
    ``_flatten_pad`` on every rank)."""
    km = program.plan.size("model")
    parts = [program.rank_view(n, v.detach()).reshape(km, -1).float()
             for n, v in zip(program.param_names, vals)]
    pad = plan.padded - plan.total
    if pad:
        parts.append(parts[0].new_zeros(km, pad))
    return torch.cat(parts, 1) if len(parts) > 1 else parts[0]


def _data_major(flat, k):
    """``(Km, padded)`` in ``("model", "data")`` order to the flat
    ``(K * Km * shard,)`` vector whose K contiguous shards are the data
    ranks' ``(Km, shard)`` columns (a view at Km = 1)."""
    km = flat.shape[0]
    return flat.view(km, k, -1).transpose(0, 1).reshape(-1)


def _model_major(flat, k, km):
    """The inverse of :func:`_data_major`: ``(Km, padded)``."""
    return flat.view(k, km, -1).transpose(0, 1).reshape(km, -1)


def _unflatten_ranks(program, flat, plan):
    """The inverse of :func:`_flatten_ranks`: the global parameters (views
    of ``flat`` where the layout allows)."""
    km = flat.shape[0]
    out, off = [], 0
    for name, shape, size in zip(program.param_names, plan.local_shapes,
                                 plan.sizes):
        out.append(program.rank_unview(
            name, flat[:, off:off + size].reshape((km,) + tuple(shape))))
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

    km = program.plan.size("model")

    def _rank(train_vals, x, y, key):
        vals = tuple(_to_compute(w) for w in train_vals)
        losses = program.loss_replica(vals, _to_compute(x), y, key).float()
        grads = torch.autograd.grad(losses.sum(0).mean(), tuple(train_vals))
        return grads, losses[0].mean().detach()

    def grads_part(train_vals, xs, ys, key=None):
        per = [_rank(train_vals, x, y, key) for x, y in zip(xs, ys)]
        if len(per) == 1 and comm.k == 1 and not zero:
            return per[0]
        loss = comm.mean([l for _, l in per])
        if zero:
            # data rank d owns columns [d * shard, (d + 1) * shard) of
            # every model rank's space: its (Km * shard,) shard
            rows = [_data_major(_flatten_ranks(program, g, zero_plan),
                                comm.k) for g, _ in per]
            return comm.reduce_scatter_mean(rows), loss
        grads = tuple(comm.mean(list(gs)) for gs in zip(*(g for g, _ in per)))
        return grads, loss

    def update_part(train_vals, state_leaves, grads, lr, t):
        if zero:
            flat_w = _data_major(
                _flatten_ranks(program, train_vals, zero_plan), comm.k)
            shards = flat_w.view(comm.k, -1)
            new_sh, new_leaves = [], []
            for r, leaves, g_sh in zip(comm.local_ranks, state_leaves,
                                       grads):
                nw, nl = apply_update(0, shards[r], g_sh, tuple(leaves),
                                      lr, t)
                new_sh.append(nw)
                new_leaves.append(tuple(nl))
            comm.all_gather(new_sh, flat_w)
            return _unflatten_ranks(
                program, _model_major(flat_w, comm.k, km),
                zero_plan), new_leaves
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
