"""Reductions and ordering: the port of ``mxnet_tpu/ops/reduce.py``.

``axis`` is ``None`` (every axis), an int or a tuple; ``exclude=True``
reduces over every axis but those.  An empty set of axes returns the
data as it is, as ``jnp.sum(x, axis=())`` does.  ``argmax`` / ``argmin``
return float32 indices and ``norm`` accumulates half-precision input in
float32, as the reference's do.

The ordering ops break ties as the reference does, the same on every
device: ``topk`` and ``argsort`` are stable (the lower index first;
``topk`` descending too, as ``lax.top_k`` is), and a descending ``sort``
or ``argsort`` is the ascending one reversed, as the reference's
``jnp.flip`` of ``jnp.sort`` / ``jnp.argsort`` is.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["norm", "argmax", "argmin", "argmax_channel", "topk", "sort",
           "argsort"]


def _axes(data, axis, exclude=False):
    if axis is None or axis == ():
        ax = tuple(range(data.dim()))
    elif isinstance(axis, int):
        ax = (axis,)
    else:
        ax = tuple(axis)
    ax = tuple(a % max(data.dim(), 1) for a in ax)
    if exclude:
        ax = tuple(i for i in range(data.dim()) if i not in ax)
    return ax


def _prod(x, dim, keepdim):
    for a in sorted(dim, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdim)
    return x


def _nanprod(x, dim, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dim,
                 keepdim)


_REDUCERS = {"sum": torch.sum, "mean": torch.mean, "prod": _prod,
             "max": torch.amax, "min": torch.amin, "nansum": torch.nansum,
             "nanprod": _nanprod}


def _reduce(name, aliases=()):
    fn = _REDUCERS[name]

    def op(data, axis=None, keepdims=False, exclude=False):
        ax = _axes(data, axis, exclude)
        if not ax:
            return data
        return fn(data, dim=ax, keepdim=bool(keepdims))

    op.__name__ = name
    op.__doc__ = ("Reduce %s over ``axis`` with keepdims/exclude "
                  "(reference: src/operator/tensor/broadcast_reduce_op_"
                  "value.cc)." % name)
    register(name, aliases=aliases)(op)
    return op


for _name, _aliases in [("sum", ("sum_axis",)), ("mean", ()), ("prod", ()),
                        ("max", ("max_axis",)), ("min", ("min_axis",)),
                        ("nansum", ()), ("nanprod", ())]:
    _reduce(_name, _aliases)


@register("norm")
def norm(data, ord=2, axis=None, keepdims=False):
    """L1/L2 norm over ``axis``; half-precision input accumulates in f32
    (reference: src/operator/tensor/broadcast_reduce_op_value.cc norm)."""
    ax = _axes(data, axis)
    if ord == 1:
        return torch.sum(data.abs(), dim=ax, keepdim=keepdims)
    half = data.dtype in (torch.float16, torch.bfloat16)
    acc = data.float() if half else data
    out = torch.sqrt(torch.sum(torch.square(acc), dim=ax, keepdim=keepdims))
    return out.to(data.dtype)


def _arg(fn, data, axis, keepdims):
    if axis is None:
        return fn(data.reshape(-1)).float()
    out = fn(data, dim=axis).float()
    return out.unsqueeze(axis) if keepdims else out


@register("argmax")
def argmax(data, axis=None, keepdims=False):
    """Index of the maximum along ``axis`` as float32 (reference:
    src/operator/tensor/broadcast_reduce_op_index.cc)."""
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin")
def argmin(data, axis=None, keepdims=False):
    """Index of the minimum along ``axis`` as float32."""
    return _arg(torch.argmin, data, axis, keepdims)


@register("argmax_channel")
def argmax_channel(data):
    """argmax over axis 1, as float32."""
    return torch.argmax(data, dim=1).float()


def _topk_outputs(params):
    return 2 if params.get("ret_typ", "indices") == "both" else 1


@register("topk", num_outputs=_topk_outputs)
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The ``k`` largest (smallest with ``is_ascend``) along ``axis``:
    their values, indices (in ``dtype``), both, or a 0/1 mask of the
    data's dtype (reference: src/operator/tensor/ordering_op.cc TopK)."""
    from ..precision import torch_dtype
    vals, idx = torch.sort(data, dim=axis, descending=not is_ascend,
                           stable=True)
    vals = vals.narrow(axis, 0, int(k))
    idx = idx.narrow(axis, 0, int(k))
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idx.to(torch_dtype(dtype))
    if ret_typ == "both":
        return vals, idx.to(torch_dtype(dtype))
    if ret_typ == "mask":
        return torch.zeros_like(data).scatter(axis, idx, 1.0)
    raise ValueError("unknown ret_typ %r" % ret_typ)


@register("sort")
def sort(data, axis=-1, is_ascend=True):
    """A sorted copy along ``axis``: the stable ascending sort, reversed
    for descending (so tied elements, and their gradients, land where
    the reference's ``jnp.flip`` of ``jnp.sort`` puts them, on every
    device)."""
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort")
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    """The indices that sort along ``axis`` (stable), in ``dtype``;
    descending is the ascending order reversed."""
    from ..precision import torch_dtype
    idx = torch.sort(data, dim=axis, stable=True).indices
    if not is_ascend:
        idx = torch.flip(idx, (axis,))
    return idx.to(torch_dtype(dtype))
