"""Control flow and the histogram: the port of
``mxnet_tpu/ops/control_flow.py``.

The reference lowers ``foreach`` / ``while_loop`` / ``cond`` to
``lax.scan`` / ``lax.while_loop`` / ``lax.cond``.  Here they are Python
loops and branches over NDArrays:

- :func:`foreach` runs ``body`` once a step on torch's tape (while
  ``autograd.record()`` is on), which gives the gradient that
  ``lax.scan``'s transpose gives; the step outputs are stacked on axis 0.
  The body sees ``autograd.is_training()`` as the caller set it, as the
  reference's does.
- :func:`while_loop` returns the final ``loop_vars`` only, as the
  reference does (upstream MXNet also returns the step outputs, padded
  to ``max_iterations``).  Each test of the condition on a device array
  reads one value back to the host: one synchronization a test on the
  card.
- :func:`cond` reads ``pred`` once (one synchronization on the card) and
  runs the chosen branch only.

The synchronizations are counted by op in
:func:`ops.contrib.host_sync_counts`.

``_histogram`` bins as ``jnp.histogram`` does: edges from
``linspace``'s arithmetic (the data's minimum and maximum when no range
is given, widened by 0.5 each way when they are equal), each value's bin
by a search against the edges (``searchsorted``, right side), a value on
the last edge in the last bin, values outside dropped; the counts are of
the data's floating dtype.  Everything stays on the data's device.
"""
from __future__ import annotations

import torch

from .contrib import _host_syncs
from .registry import register

__all__ = ["foreach", "while_loop", "cond", "histogram", "square_sum"]


def _nd(x):
    from ..ndarray import NDArray, array
    return x if isinstance(x, NDArray) else array(x)


def _truth(value, op):
    """``value`` (an NDArray of one element, or a Python value) as a bool;
    a device read is one host synchronization of ``op``."""
    from ..ndarray import NDArray
    if not isinstance(value, NDArray):
        return bool(value)
    t = value._data.detach().reshape(())
    if t.is_cuda:
        _host_syncs[op] = _host_syncs.get(op, 0) + 1
    return bool(t)


def _stack(arrays):
    from .. import autograd
    from ..ndarray import NDArray
    with torch.set_grad_enabled(autograd.is_recording()):
        return NDArray(torch.stack([a._data for a in arrays]))


def foreach(body, data, init_states):
    """Scan ``body(data_slice, states) -> (out, new_states)`` over axis 0
    of ``data`` (one array or a list); returns (the outputs stacked on
    axis 0, the final states), each one array or a list as ``body``'s
    outputs and ``init_states`` are."""
    multi_data = isinstance(data, (list, tuple))
    multi_state = isinstance(init_states, (list, tuple))
    data_list = [_nd(d) for d in (data if multi_data else [data])]
    states = [_nd(s) for s in (init_states if multi_state
                               else [init_states])]
    steps, multi_out = [], False
    for t in range(data_list[0].shape[0]):
        xs = [d[t] for d in data_list]
        out, new_states = body(xs if multi_data else xs[0],
                               states if multi_state else states[0])
        multi_out = isinstance(out, (list, tuple))
        steps.append(list(out) if multi_out else [out])
        states = list(new_states) if isinstance(new_states, (list, tuple)) \
            else [new_states]
    outs = [_stack(col) for col in zip(*steps)]
    return (outs if multi_out else outs[0],
            states if multi_state else states[0])


def while_loop(cond_fn, func, loop_vars, max_iterations=None):
    """Apply ``func`` to ``loop_vars`` while ``cond_fn(loop_vars)`` holds
    (and fewer than ``max_iterations`` steps ran); returns the final
    ``loop_vars``, a list or one array as given."""
    multi = isinstance(loop_vars, (list, tuple))
    vs = [_nd(v) for v in loop_vars] if multi else _nd(loop_vars)
    i = 0
    while max_iterations is None or i < max_iterations:
        if not _truth(cond_fn(vs), "while_loop"):
            break
        new = func(vs)
        vs = list(new) if isinstance(new, (list, tuple)) else new
        i += 1
    return vs


def cond(pred, then_func, else_func, inputs=()):
    """``then_func(*inputs)`` if ``pred`` holds, else
    ``else_func(*inputs)``."""
    branch = then_func if _truth(pred, "cond") else else_func
    return branch(*[_nd(x) for x in inputs])


@register("_histogram", arg_names=["data", "bins"], aliases=("histogram",),
          num_outputs=2, optional_args=("bins",))
def histogram(data, bins=None, bin_cnt=10, range=None):
    """(counts, bin edges) of ``data`` over explicit edges ``bins``, or
    ``bin_cnt`` equal bins over ``range`` (reference:
    src/operator/tensor/histogram.cc)."""
    flat = data.detach().reshape(-1)
    if not flat.is_floating_point():
        flat = flat.float()
    dt = flat.dtype
    if bins is not None:
        edges = bins.detach().reshape(-1).to(dt)
    else:
        n = int(bin_cnt)
        if range is None or range[0] == float("-inf"):
            lo, hi = flat.min(), flat.max()
        else:
            lo, hi = (flat.new_full((), float(r)) for r in range)
        same = lo == hi
        lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5,
                                                              hi)
        step = torch.arange(n, dtype=dt, device=flat.device) \
            / flat.new_full((), float(n))
        edges = torch.cat([lo * (1 - step) + hi * step, hi[None]])
    if flat.device.type == "meta":
        return flat.new_empty((edges.shape[0] - 1,)), edges
    m = edges.shape[0]
    idx = torch.searchsorted(edges, flat, right=True)
    idx = torch.where(flat == edges[-1], idx.new_full((), m - 1), idx)
    counts = torch.zeros(m + 1, dtype=torch.int64, device=flat.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return counts[1:m].to(dt), edges


@register("square_sum", arg_names=["data"], aliases=("_square_sum",))
def square_sum(data, axis=None, keepdims=False):
    """The sum of squares over ``axis`` (reference:
    src/operator/tensor/square_sum.cc; dense math)."""
    sq = data * data
    if axis is None:
        axis = tuple(range(data.dim()))
    return sq.sum(dim=axis, keepdim=bool(keepdims))
