"""Weight initializers: the port of ``mxnet_tpu/initializer.py``.

The same registry and name rules (``:40-66``): a parameter named
``*weight`` gets the chosen init, ``*bias`` / ``*beta`` /
``running_mean`` zeros, ``*gamma`` / ``running_var`` ones.

An initializer fills a float32 array in place, drawing the reference's
formulas from the generator its caller passes (``rng=``):

- none: numpy's global RNG, as the reference's initializers draw; after
  ``mx.random.seed(s)`` (which seeds it) a draw is bitwise the
  reference's after its ``mx.random.seed(s)``;
- a ``numpy.random.RandomState``: a host numpy array, which the
  parameter then copies to its device; one shape and one seed give a
  draw bitwise equal to the reference's after ``np.random.seed`` of the
  same seed;
- a ``torch.Generator``: a tensor on the generator's device, drawn there
  (:class:`TorchDraws`), so a large model is initialized on the card
  without a pass through the host.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Constant", "Uniform", "Normal", "Xavier", "LSTMBias", "FusedRNN",
           "TorchDraws"]

_REG = {}


class InitDesc(str):
    """Name + attrs describing a parameter to initialize."""

    def __new__(cls, name, attrs=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        return ret


class TorchDraws:
    """A ``torch.Generator`` behind the two draws of ``RandomState`` the
    initializers make: float32 tensors on the generator's device."""

    def __init__(self, generator):
        self.generator = generator

    def uniform(self, low, high, shape):
        return torch.empty(shape, device=self.generator.device).uniform_(
            float(low), float(high), generator=self.generator)

    def normal(self, loc, scale, shape):
        return torch.empty(shape, device=self.generator.device).normal_(
            float(loc), float(scale), generator=self.generator)


def _need_rng(rng, who):
    """The draws of ``rng``: numpy's global RNG when None."""
    if rng is None:
        return np.random
    if isinstance(rng, torch.Generator):
        return TorchDraws(rng)
    return rng


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``[name, kwargs]`` as JSON: what a variable's ``__init__``
        attribute records and :func:`create` reads back."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr, rng=None):
        """Fill ``arr`` in place by the name rules: a numpy array from a
        ``RandomState``, a tensor on its device from a
        ``torch.Generator``."""
        if not isinstance(desc, InitDesc):
            desc = InitDesc(desc)
        init = desc.attrs.get("__init__", "")
        if init:
            create(init)._init_weight(desc, arr, rng)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr, rng)
        elif name.endswith("bias") or name.endswith("beta"):
            arr[...] = 0.0
        elif name.endswith("gamma"):
            arr[...] = 1.0
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            arr[...] = 0.0
        elif name.endswith("running_var") or name.endswith("moving_var"):
            arr[...] = 1.0
        elif name.endswith("moving_inv_var") or name.endswith("moving_avg") \
                or name.endswith("min") or name.endswith("max"):
            arr[...] = 0.0
        else:
            self._init_weight(desc, arr, rng)

    def _init_weight(self, name, arr, rng):
        raise NotImplementedError


def register(klass, *aliases):
    for n in (klass.__name__,) + aliases:
        _REG[n.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    if isinstance(name, str) and name.startswith("["):
        name, kwargs = json.loads(name)
    key = str(name).lower()
    if key not in _REG:
        raise MXNetError("Cannot find initializer %r. Registered: %s"
                         % (name, sorted(_REG)))
    return _REG[key](**kwargs)


class Zero(Initializer):
    def _init_weight(self, _, arr, rng):
        arr[...] = 0.0


class One(Initializer):
    def _init_weight(self, _, arr, rng):
        arr[...] = 1.0


class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr, rng):
        arr[...] = self.value


class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr, rng):
        arr[...] = _need_rng(rng, "Uniform").uniform(
            -self.scale, self.scale, arr.shape)


class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr, rng):
        arr[...] = _need_rng(rng, "Normal").normal(0, self.sigma, arr.shape)


class Xavier(Initializer):
    """Reference: initializer.py Xavier (rnd_type/factor_type/magnitude)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr, rng):
        shape = arr.shape
        hw_scale = 1.0
        if len(shape) < 2:
            raise ValueError("Xavier requires >=2D weight, got %s for %s"
                             % (shape, name))
        if len(shape) > 2:
            hw_scale = np.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = np.sqrt(self.magnitude / factor)
        rng = _need_rng(rng, "Xavier")
        if self.rnd_type == "uniform":
            arr[...] = rng.uniform(-scale, scale, arr.shape)
        else:
            arr[...] = rng.normal(0, scale, arr.shape)


class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter (i, f, g, o) at
    ``forget_bias`` (reference: initializer.py LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, _, arr, rng):
        num_hidden = arr.shape[0] // 4
        arr[...] = 0.0
        arr[num_hidden:2 * num_hidden] = self.forget_bias


class FusedRNN(Initializer):
    """The initializer a ``FusedRNNCell``'s flat parameter vector carries
    in its ``__init__`` attribute: ``init`` (Uniform when None) over the
    whole vector.  As the reference's, it is recorded with no arguments
    (``dumps``), so a recreated one is Uniform, and ``forget_bias`` is
    never applied (reference: initializer.py FusedRNN)."""

    def __init__(self, init=None, num_hidden=0, num_layers=0, mode="lstm",
                 bidirectional=False, forget_bias=1.0):
        super().__init__()
        self._init = create(init) if init is not None else Uniform()

    def _init_weight(self, desc, arr, rng):
        self._init._init_weight(desc, arr, rng)


register(Zero, "zeros")
register(One, "ones")
register(Constant)
register(Uniform)
register(Normal, "gaussian")
register(Xavier)
register(LSTMBias)
register(FusedRNN)
