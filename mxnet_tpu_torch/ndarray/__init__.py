"""``nd`` — the imperative NDArray namespace of the port (the counterpart
of ``mxnet_tpu/ndarray/``).  Functions are generated from the op
registry (``register.py``); ``nd.contrib.<op>`` holds the ``_contrib_*``
ops without their prefix.  The creation helpers, ``save`` / ``load``
(``serialization.py``) and ``waitall`` mirror the reference's.  Sparse
arrays and ``nd.random`` are ROADMAP.md queue A, items 10 and 1(b)."""
from __future__ import annotations

import sys
import types

import torch

from ..ops import registry as _reg
from .ndarray import (NDArray, _device, array, concatenate, empty,
                      imperative_invoke, invoke, np_dtype, torch_dtype)
from .register import populate as _populate

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concatenate", "invoke", "imperative_invoke", "np_dtype",
           "torch_dtype", "waitall", "save", "load", "contrib"]

_reg.load_all()
contrib = types.ModuleType(__name__ + ".contrib")
sys.modules[contrib.__name__] = contrib
_populate(sys.modules[__name__], contrib)


def _shape(shape):
    return tuple(shape) if isinstance(shape, (list, tuple)) else (shape,)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.zeros(_shape(shape),
                               dtype=torch_dtype(dtype or "float32"),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.ones(_shape(shape),
                              dtype=torch_dtype(dtype or "float32"),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.full(_shape(shape), float(val),
                              dtype=torch_dtype(dtype or "float32"),
                              device=_device(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    if stop is None:
        start, stop = 0, start
    t = torch.arange(start, stop, step, dtype=torch.float64)
    if repeat > 1:
        t = torch.repeat_interleave(t, int(repeat))
    return NDArray(t.to(dtype=torch_dtype(dtype or "float32"),
                        device=_device(ctx)))


def waitall():
    """Block until the card has finished all queued work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def save(fname, data, format="mxtpu"):
    """Save a list or dict of NDArrays; ``format="mxnet"`` writes the
    reference's dmlc-stream layout (``serialization.py``)."""
    from ..serialization import save_ndarrays
    save_ndarrays(fname, data, format=format)


def load(fname, ctx=None):
    """Load NDArrays saved by :func:`save` (either format), onto ``ctx``
    (the CUDA device by default)."""
    from ..serialization import load_ndarrays
    return load_ndarrays(fname, ctx=ctx)
