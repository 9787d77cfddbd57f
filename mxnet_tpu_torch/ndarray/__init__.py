"""``nd`` — the imperative NDArray namespace of the port (the counterpart
of ``mxnet_tpu/ndarray/``).  Functions are generated from the op
registry (``register.py``); ``nd.contrib.<op>`` holds the ``_contrib_*``
ops without their prefix.  The creation helpers, ``save`` / ``load``
(``serialization.py``) and ``waitall`` mirror the reference's.
``nd.Custom`` runs a Python ``CustomOp`` (``operator.py``).
``nd.random`` holds the samplers of ``ops/random.py`` under the
reference's public names (``mxnet_tpu/ndarray/__init__.py:121-183``),
with ``randn`` and ``seed``; a draw lands on ``ctx`` (the card unless
the caller asks for the CPU).  ``nd.sparse`` holds the row-sparse and
CSR arrays (``sparse.py``); ``zeros(stype=)`` makes one."""
from __future__ import annotations

import sys
import types

import torch

from ..ops import registry as _reg
from .ndarray import (NDArray, _device, array, concatenate, empty,
                      imperative_invoke, invoke, np_dtype, torch_dtype)
from .register import populate as _populate
from . import sparse

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concatenate", "invoke", "imperative_invoke", "np_dtype",
           "torch_dtype", "waitall", "save", "load", "contrib", "random",
           "Custom", "sparse"]

_reg.load_all()
contrib = types.ModuleType(__name__ + ".contrib")
sys.modules[contrib.__name__] = contrib
_populate(sys.modules[__name__], contrib)


def _shape(shape):
    return tuple(shape) if isinstance(shape, (list, tuple)) else (shape,)


def zeros(shape, ctx=None, dtype=None, stype=None, **kwargs):
    if stype not in (None, "default"):
        return sparse.zeros(stype, _shape(shape), ctx=ctx, dtype=dtype)
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


def Custom(*args, **kwargs):
    """Run a Python ``CustomOp`` registered by ``operator.register``
    (``operator.py``)."""
    from ..operator import _custom_entry
    return _custom_entry(*args, **kwargs)


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


# random namespace ----------------------------------------------------------
random = types.ModuleType(__name__ + ".random")
sys.modules[random.__name__] = random

# each public sampler's leading scalar parameters, in the order a
# positional call gives them
_POSITIONAL = {
    "uniform": ("low", "high", "shape"),
    "normal": ("loc", "scale", "shape"),
    "gamma": ("alpha", "beta", "shape"),
    "exponential": ("lam", "shape"),
    "poisson": ("lam", "shape"),
    "negative_binomial": ("k", "p", "shape"),
    "generalized_negative_binomial": ("mu", "alpha", "shape"),
    "randint": ("low", "high", "shape"),
    "multinomial": (),
    "shuffle": (),
}


def _rand_fn(op_name, pub_name):
    op = _reg.get(op_name)

    def fn(*args, **kwargs):
        if args and not isinstance(args[0], NDArray):
            for v, k in zip(args, _POSITIONAL[pub_name]):
                kwargs.setdefault(k, v)
            args = ()
        return invoke(op, args, kwargs)

    fn.__name__ = pub_name
    fn.__doc__ = op.doc
    return fn


for _pub, _opn in [
        ("uniform", "_random_uniform"), ("normal", "_random_normal"),
        ("gamma", "_random_gamma"), ("exponential", "_random_exponential"),
        ("poisson", "_random_poisson"),
        ("negative_binomial", "_random_negative_binomial"),
        ("generalized_negative_binomial",
         "_random_generalized_negative_binomial"),
        ("randint", "_random_randint"),
        ("multinomial", "_sample_multinomial"), ("shuffle", "_shuffle")]:
    setattr(random, _pub, _rand_fn(_opn, _pub))


def _randn(*shape, ctx=None, dtype=None):
    """Standard normal draws of ``shape``."""
    return random.normal(0.0, 1.0, shape=shape, dtype=dtype or "float32",
                         ctx=ctx)


def _seed(seed_state, ctx="all"):
    """``mx.random.seed``: reseed every device's generator and numpy's
    global RNG (``_rng.seed``)."""
    from .. import _rng
    _rng.seed(seed_state)


random.randn = _randn
random.seed = _seed
