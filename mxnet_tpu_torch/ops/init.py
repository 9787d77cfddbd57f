"""Creation operators: the port of ``mxnet_tpu/ops/init.py`` (``:10-61``).

Each makes a tensor on ``ctx`` (the card unless the caller asks for the
CPU); ``_state_zeros_like`` makes it beside its ``ref`` input.
``_arange`` computes in float64 and casts, as numpy's ``arange`` does, so
its values and length match the reference's for float steps.
"""
from __future__ import annotations

import numpy as np
import torch

from ..context import current_context
from ..precision import torch_dtype
from .registry import register

__all__ = ["zeros", "state_zeros_like", "ones", "full", "arange",
           "linspace", "eye"]


def ctx_device(ctx):
    """The device an op with no tensor input makes its output on: ``ctx``,
    else the current context; the meta device of shape inference passes
    through."""
    from ..base import resolve_device
    if isinstance(ctx, torch.device) and ctx.type == "meta":
        return ctx
    return current_context() if ctx is None else resolve_device(ctx)


_dev = ctx_device


def _dt(dtype):
    return torch_dtype(dtype or "float32")


def shape_tuple(shape):
    """A shape as a tuple: MXNet takes a scalar (``shape=500``) too."""
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


_shape = shape_tuple


@register("_zeros", arg_names=[])
def zeros(shape=(), dtype="float32", ctx=None):
    """Zeros of ``shape`` (reference: src/operator/tensor/init_op.cc)."""
    return torch.zeros(_shape(shape), dtype=_dt(dtype), device=_dev(ctx))


@register("_state_zeros_like", arg_names=["ref"])
def state_zeros_like(ref, shape=(), batch_axis=0, dtype="float32"):
    """Zeros of ``shape`` whose 0 entries take ``ref.shape[batch_axis]``:
    the recurrent begin states of an unknown batch."""
    b = ref.shape[int(batch_axis)]
    return torch.zeros(tuple(b if d == 0 else d for d in _shape(shape)),
                       dtype=_dt(dtype), device=ref.device)


@register("_ones", arg_names=[])
def ones(shape=(), dtype="float32", ctx=None):
    """Ones of ``shape``."""
    return torch.ones(_shape(shape), dtype=_dt(dtype), device=_dev(ctx))


@register("_full", arg_names=[])
def full(shape=(), value=0.0, dtype="float32", ctx=None):
    """``value`` everywhere in ``shape``."""
    return torch.full(_shape(shape), value, dtype=_dt(dtype),
                      device=_dev(ctx))


@register("_arange", arg_names=[])
def arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
           ctx=None, infer_range=False):
    """Values in [start, stop) by ``step``, each repeated ``repeat``
    times; ``stop=None`` counts from 0 to ``start``, as numpy does."""
    vals = np.arange(start, stop, step, dtype=np.float64)
    out = torch.from_numpy(vals).to(device=_dev(ctx), dtype=_dt(dtype))
    if int(repeat) != 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out


@register("_linspace", arg_names=[])
def linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype="float32",
             ctx=None):
    """``num`` evenly spaced values from ``start`` to ``stop``."""
    vals = np.linspace(start, stop, int(num), endpoint=bool(endpoint),
                       dtype=np.float64)
    return torch.from_numpy(vals).to(device=_dev(ctx), dtype=_dt(dtype))


@register("_eye", arg_names=[])
def eye(N=0, M=0, k=0, dtype="float32", ctx=None):
    """Ones on the ``k``-th diagonal of an ``N x M`` matrix (``M`` 0 means
    ``N``)."""
    vals = np.eye(int(N), int(M) or None, int(k), dtype=np.float64)
    return torch.from_numpy(vals).to(device=_dev(ctx), dtype=_dt(dtype))
