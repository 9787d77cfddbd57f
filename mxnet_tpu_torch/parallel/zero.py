"""ZeRO-1 sharded optimizer runtime (arxiv 2004.13336) for
``DataParallelTrainer(zero=1)``: the port of ``mxnet_tpu/parallel/zero.py``.

Flat layout (the reference's exactly, since sharded checkpoints record
it): every trainable parameter raveled (f32) and concatenated in
``collect_params`` order, zero-padded to a multiple of K.  Rank ``r``
owns the contiguous ``[r*shard, (r+1)*shard)`` slice of that flat space:
the reduce-scatter lands exactly the owned gradient shard, the update is
shard-local, the all-gather reassembles the flat vector.  The padding
tail stays zero across steps (gradients pad with zeros, so every
elementwise optimizer maps a zero (w, g, state) tail to a zero tail),
which is what makes resize-on-resume checkpointing exact: a shard set
saved at K truncates to the unpadded ``total`` and re-pads for any other
size losslessly (``resilience/checkpoint.py``).

The step's two halves (:func:`build_parts`) run over the ranks this
process holds, through the collectives of ``parallel/comm.py``: with
in-process ranks the K ranks run in turn on one device, each with its
own ``(shard,)`` optimizer state; with one rank per process, each
process holds one.  The shard update is
``ops.fused_optimizer.fused_optimizer_update`` (the B1 / B2 / B3 kernels
on a card, one launch per rank's shard) whenever ``supports(opt)``
holds, else ``functional_optimizer_update``, as in the reference.

``build_replica_step`` and the ``ZERO1_RUNTIME_ALL_GATHER`` seam feed the
reference's static analysis, which is ROADMAP.md queue A, item 13.
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["Zero1Plan", "build_parts", "reassemble_state", "reshard_full",
           "shard_route"]

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "float64": torch.float64}


class Zero1Plan:
    """The flat parameter layout of one ZeRO-1 trainer over ``axis``.

    Pure shape arithmetic: names/shapes/dtypes in parameter order, the
    flat ``total``, the K-padded length and the per-rank ``shard`` size.
    Deterministic given (parameters, K): the runtime and the
    resize-on-resume restore both derive their slicing from it."""

    def __init__(self, names, shapes, dtypes, axis, k):
        self.names = list(names)
        self.shapes = [tuple(int(d) for d in s) for s in shapes]
        self.dtypes = [str(d) for d in dtypes]
        self.axis = str(axis)
        self.k = int(k)
        if self.k < 1:
            raise ValueError("zero=1 needs a data axis of size >= 1, "
                             "got %d" % self.k)
        self.sizes = [int(_np.prod(s)) if s else 1 for s in self.shapes]
        self.total = int(sum(self.sizes))
        self.padded = -(-self.total // self.k) * self.k
        self.shard = self.padded // self.k

    def describe(self):
        """JSON-able layout record embedded in sharded checkpoints so a
        restore at a different fleet size can re-derive the slicing."""
        return {"names": list(self.names), "shapes": [list(s) for s in
                                                      self.shapes],
                "dtypes": list(self.dtypes), "axis": self.axis,
                "k": self.k, "total": self.total, "padded": self.padded,
                "shard": self.shard}


def _flatten_pad(vals, plan, dtype=torch.float32):
    """The parameters raveled in plan order, cast to ``dtype``, zero-padded
    to ``plan.padded``."""
    parts = [v.detach().reshape(-1).to(dtype) for v in vals]
    pad = plan.padded - plan.total
    if pad:
        parts.append(torch.zeros(pad, dtype=dtype, device=parts[0].device))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _unflatten(flat, plan):
    """The inverse of :func:`_flatten_pad`: views (or casts) of ``flat``
    in the plan's shapes and dtypes."""
    out, off = [], 0
    for shape, size, dt in zip(plan.shapes, plan.sizes, plan.dtypes):
        out.append(flat[off:off + size].view(shape).to(_TORCH_DTYPES[dt]))
        off += size
    return tuple(out)


def shard_route(tensors):
    """Which loop of ``csrc/fused_optimizer.cu`` a launch over these flat
    f32 tensors takes: ``"float4"`` when every pointer is 16-byte
    aligned (the kernel's ``aligned16``), else ``"scalar"``.  Rank r's
    shard starts ``r * shard`` elements into the flat space, so the
    float4 loop needs ``shard % 4 == 0``."""
    return "float4" if all(t.data_ptr() % 16 == 0 for t in tensors) \
        else "scalar"


def _state_leaves(state):
    if state is None:
        return ()
    if isinstance(state, (tuple, list)):
        return tuple(state)
    return (state,)


def _shard_update(opt, w_sh, g_sh, state, lr, t, inv_scale=None, ok=None):
    """One rank's update of its shard and state, in place: the fused
    kernel where ``supports(opt)`` holds, else the optimizer's own rule
    (with the unscale and the select-skip spelled around it)."""
    from ..ops import fused_optimizer as _fused
    from .functional import functional_optimizer_update
    scaled = inv_scale is not None
    if _fused.supports(opt) is not None:
        kw = {"inv_scale": inv_scale, "ok": ok} if scaled else {}
        _fused.fused_optimizer_update(opt, 0, w_sh, g_sh, state, lr, t, **kw)
        return
    nw, ns = functional_optimizer_update(
        opt, 0, w_sh, g_sh * inv_scale if scaled else g_sh, state, lr, t)
    if scaled:
        okb = ok > 0.0
        nw = torch.where(okb, nw, w_sh)
        ns = tuple(torch.where(okb, n, o) for n, o in
                   zip(_state_leaves(ns), _state_leaves(state)))
    with torch.no_grad():
        w_sh.copy_(nw)
        for s, n in zip(_state_leaves(state), _state_leaves(ns)):
            s.copy_(n)


def build_parts(rank_grads, grad_rows, opt, plan, comm, compute_dtype=None,
                grad_accum=1):
    """``(grads_part, update_part)``, the two halves of the ZeRO-1 step
    over the ranks ``comm`` holds in this process.

    ``rank_grads(i, x, y[, scale]) -> (loss, muts)`` runs local rank
    ``i``'s forward and backward on its rows, adding its flat gradient
    into ``grad_rows[i]`` (a ``(padded,)`` buffer whose tail past
    ``plan.total`` no parameter covers, so it stays zero), and returns
    the loss and the new values of the state its forward mutated
    (BatchNorm's running statistics).

    - ``grads_part(xs, ys) -> (g_shards, loss, muts)``: each rank's
      forward + backward on its rows (``grad_accum`` microbatches folded
      by ``accumulate_grads``), the flat gradients reduce-scattered over
      the data axis (mean), loss and mutated state averaged over ranks.
    - ``update_part(w_shards, states, g_shards, lr, t, out)``: each
      rank's shard updated in place, then all-gathered into ``out``.

    With ``compute_dtype=bfloat16`` the halves take the mixed-precision
    signature instead (:func:`_build_parts_reduced`)."""
    from .. import precision as _prec
    n_acc = int(grad_accum or 1)
    if compute_dtype is not None and \
            _prec.resolve_dtype(compute_dtype) != torch.float32:
        if n_acc > 1:
            raise ValueError("grad_accum is not supported with a "
                             "reduced compute dtype (see "
                             "DataParallelTrainer)")
        return _build_parts_reduced(rank_grads, grad_rows, opt, plan, comm)

    def grads_part(xs, ys):
        losses, muts_r = [], []
        for i, (x, y) in enumerate(zip(xs, ys)):
            grad_rows[i].zero_()
            if n_acc > 1:
                from .functional import accumulate_grads

                def grad_of(xm, ym, i=i):
                    loss, muts = rank_grads(i, xm, ym)
                    return loss, muts, None

                _, loss_sum, stack = accumulate_grads(grad_of, x, y, n_acc)
                grad_rows[i].div_(n_acc)
                loss = loss_sum / n_acc
                muts = tuple(m.mean(dim=0) for m in stack)
            else:
                loss, muts = rank_grads(i, x, y)
            losses.append(loss.detach().float())
            muts_r.append(muts)
        g_sh = comm.reduce_scatter_mean(grad_rows)
        loss = comm.mean(losses)
        muts = tuple(comm.mean(list(ms)) for ms in zip(*muts_r))
        return g_sh, loss, muts

    def update_part(w_shards, states, g_shards, lr, t, out):
        for w_sh, state, g_sh in zip(w_shards, states, g_shards):
            _shard_update(opt, w_sh, g_sh, state, lr, t)
        comm.all_gather(w_shards, out)
        return w_shards, states

    return grads_part, update_part


def _build_parts_reduced(rank_grads, grad_rows, opt, plan, comm):
    """The mixed-precision halves: bf16 compute, the f32 masters as each
    rank's ``(shard,)`` slice (no unsharded f32 copy of the weights),
    gradients cast to f32 before the reduce-scatter, the loss-scale tick
    and the inf/nan select-skip riding the update, the cast to bf16
    before the gather.

    - ``grads_part(xs, ys, scale) -> (g_shards_f32, loss, muts, fin)``
      (``rank_grads(i, x, y, scale)`` backs the scaled loss and returns
      the raw one; ``fin`` is 1.0 when every rank's shard is finite).
    - ``update_part(masters, states, g_shards, lr, t, scale, good,
      skipped, fin, out) -> (new_scale, new_good, new_skipped)``: each
      master shard and state updated in place, the bf16 casts gathered
      into ``out``."""
    from .. import precision as _prec

    def grads_part(xs, ys, scale):
        losses, muts_r = [], []
        for i, (x, y) in enumerate(zip(xs, ys)):
            grad_rows[i].zero_()
            loss, muts = rank_grads(i, x, y, scale)
            losses.append(loss.detach().float())
            muts_r.append(tuple(m.float() for m in muts))
        g_sh = comm.reduce_scatter_mean(
            grad_rows.float() if isinstance(grad_rows, torch.Tensor)
            else [g.float() for g in grad_rows])
        fin = comm.min([torch.isfinite(g).all().float() for g in g_sh])
        loss = comm.mean(losses)
        muts = tuple(comm.mean(list(ms)) for ms in zip(*muts_r))
        return g_sh, loss, muts, fin

    def update_part(masters, states, g_shards, lr, t, scale, good, skipped,
                    fin, out):
        inv = (1.0 / scale).float()
        for m_sh, state, g_sh in zip(masters, states, g_shards):
            _shard_update(opt, m_sh, g_sh, state, lr, t, inv_scale=inv,
                          ok=fin)
        new_scale, new_good = _prec.loss_scale_update(scale, good,
                                                      fin > 0.0)
        new_skipped = skipped + (1 - fin.int())
        comm.all_gather([m.to(out.dtype) for m in masters], out)
        return new_scale, new_good, new_skipped

    return grads_part, update_part


def reassemble_state(shard_arrays, total):
    """Concatenate one state leaf's per-rank shards (save-time order)
    and truncate the padding tail -> the exact ``(total,)`` full leaf.
    Lossless: the tail is zero (module docstring)."""
    full = _np.concatenate([_np.asarray(a).ravel() for a in shard_arrays])
    if full.shape[0] < total:
        raise ValueError("shards hold %d elements, need %d"
                         % (full.shape[0], total))
    return full[:total]


def reshard_full(full, k):
    """Deterministically re-shard one full ``(total,)`` leaf for a fleet
    of size ``k``: zero-pad to the new K-multiple and split into K equal
    contiguous shards.  ``reassemble_state(reshard_full(x, k), len(x))``
    is the identity for every k."""
    full = _np.asarray(full).ravel()
    total = full.shape[0]
    padded = -(-total // int(k)) * int(k)
    if padded != total:
        full = _np.concatenate(
            [full, _np.zeros((padded - total,), full.dtype)])
    shard = padded // int(k)
    return [full[r * shard:(r + 1) * shard] for r in range(int(k))]
