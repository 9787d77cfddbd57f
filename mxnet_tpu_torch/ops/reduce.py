"""Reductions: the port of ``sum``, ``mean``, ``prod``, ``max``, ``min``,
``norm``, ``argmax`` and ``argmin`` from ``mxnet_tpu/ops/reduce.py``
(the ordering ops are ROADMAP.md queue A, item 1(b)).

``axis`` is ``None`` (every axis), an int or a tuple; ``exclude=True``
reduces over every axis but those.  An empty set of axes returns the
data as it is, as ``jnp.sum(x, axis=())`` does.  ``argmax`` / ``argmin``
return float32 indices and ``norm`` accumulates half-precision input in
float32, as the reference's do.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["norm", "argmax", "argmin"]


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


_REDUCERS = {"sum": torch.sum, "mean": torch.mean, "prod": _prod,
             "max": torch.amax, "min": torch.amin}


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
                        ("max", ("max_axis",)), ("min", ("min_axis",))]:
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
