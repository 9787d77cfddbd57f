"""Gluon ``Parameter`` / ``ParameterDict``: the port of
``mxnet_tpu/gluon/parameter.py``.

A parameter holds one torch tensor on one device: a leaf
``torch.nn.Parameter`` when it takes a gradient (``grad_req != "null"``),
a plain tensor for auxiliary state (BatchNorm moving statistics).  Shapes
with a 0 stay unknown until the first forward infers them (deferred
initialization).  Initial values are drawn on the host from the
``numpy.random.RandomState`` passed as ``rng`` (``initializer.py``), or
from numpy's global RNG when none is (the reference's source, seeded by
``mx.random.seed``), and copied to the device, so a draw does not depend
on the device; or, from a ``torch.Generator``, on that generator's
device.

Once initialized, the tensor is also registered on the ``nn.Module``
that owns the attribute (``_parameters`` or ``_buffers``), so
``parameters()`` and ``state_dict()`` see it.  The tensor's identity
never changes afterwards: ``set_data`` copies in place, and the trainer
moves the storage into its flat buckets with ``tensor.data = view``.

``data()`` / ``grad()`` return NDArrays, as the reference's do: ``data()``
one fixed NDArray over the tensor (writes through it copy in place; it
is the autograd variable with this parameter's ``grad_req``), ``grad()``
one over the tensor's ``.grad`` buffer (zeros until a backward writes
it).  :meth:`Parameter.tensor` is the one accessor of the torch tensor
itself, for the code that runs blocks on tensors (``parallel``,
``serving``, ``HybridBlock`` on tensor inputs).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd, initializer
from ..base import MXNetError, resolve_device
from ..context import current_device
from ..ndarray import NDArray
from ..precision import torch_dtype as _torch_dtype

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


class DeferredInitializationError(MXNetError):
    pass


def _host_dtype(dtype):
    """The numpy dtype values are drawn or staged in on the host: float32
    for bfloat16, which numpy lacks."""
    tdt = _torch_dtype(dtype)
    if tdt == torch.bfloat16:
        return np.dtype(np.float32)
    return np.dtype(str(tdt).replace("torch.", ""))


def _dtype_tag(tdt):
    """What ``Parameter.dtype`` holds for a torch dtype: the numpy dtype,
    or the name ``"bfloat16"`` (numpy has none)."""
    if tdt == torch.bfloat16:
        return "bfloat16"
    return np.dtype(str(tdt).replace("torch.", ""))


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self._data = None
        self._nd = None
        self._deferred_init = ()
        self._owners = []
        self.name = name
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.grad_req = grad_req if differentiable else "null"
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        # storage types are recorded, as in the reference; data and
        # gradient stay dense
        self._stype = stype
        self._grad_stype = grad_stype

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self._shape,
                                                      self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be write, add or null, not %r"
                             % (req,))
        self._grad_req = req
        if self._nd is not None and self._data.requires_grad:
            autograd._mark(self._nd, req)

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is None:
            self._shape = tuple(new_shape)
            return
        unknown_ok = len(self._shape) == len(new_shape) and all(
            s1 in (0, s2) for s1, s2 in zip(self._shape, new_shape))
        if not unknown_ok:
            raise AssertionError("cannot reset shape %s -> %s for %s"
                                 % (self._shape, new_shape, self.name))
        self._shape = tuple(new_shape)

    def _attach(self, module, attr):
        """Record ``module.attr`` as an owner (called by ``Block``)."""
        self._owners.append((module, attr))
        if self._data is not None:
            self._register(module, attr)

    def _register(self, module, attr):
        if self.grad_req != "null":
            module._parameters[attr] = self._data
        else:
            module._buffers[attr] = self._data

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, rng=None):
        """Initialize on ``ctx`` (default: :func:`current_device`, CUDA
        unless the caller asks for the CPU), drawing from ``rng`` (numpy's
        global RNG when None)."""
        default_init = default_init or initializer.Uniform()
        if self._data is not None and not force_reinit:
            return
        device = current_device() if ctx is None else ctx
        if isinstance(device, (list, tuple)):
            device = device[0]
        device = resolve_device(device)
        if self._shape is None or 0 in self._shape:
            if self.allow_deferred_init:
                self._deferred_init = (init, device, default_init, rng)
                return
            raise ValueError("cannot initialize %s: shape unknown %s"
                             % (self.name, self._shape))
        self._finish_init(init, device, default_init, rng)

    def _finish_init(self, init, device, default_init, rng):
        if isinstance(rng, torch.Generator):
            arr = torch.empty(self._shape, device=rng.device,
                              dtype=_torch_dtype(_host_dtype(self.dtype)))
        else:
            arr = np.empty(self._shape, dtype=_host_dtype(self.dtype))
        chosen = init or self.init or default_init
        initializer.create(chosen)(initializer.InitDesc(self.name), arr, rng)
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(arr)
        self._init_impl(arr.to(device=device, dtype=_torch_dtype(self.dtype)))

    def _init_impl(self, data):
        if self._data is not None:
            with torch.no_grad():
                self._data.copy_(data)
            self._deferred_init = ()
            return
        if self.grad_req != "null":
            data = torch.nn.Parameter(data, requires_grad=True)
        self._data = data
        self._nd = NDArray(data, fixed=True)
        if self.grad_req != "null":
            autograd._mark(self._nd, self.grad_req)
        self._deferred_init = ()
        for module, attr in self._owners:
            self._register(module, attr)

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, device, default_init, rng = self._deferred_init
        if self._shape is None or 0 in self._shape:
            raise DeferredInitializationError(
                "parameter %s has unknown shape %s" % (self.name,
                                                       self._shape))
        self._finish_init(init, device, default_init, rng)

    def _check_init(self):
        if self._data is None:
            if self._deferred_init:
                raise DeferredInitializationError(
                    "parameter %s deferred; run a forward pass first"
                    % self.name)
            raise RuntimeError("parameter %s not initialized; call "
                               "initialize()" % self.name)

    def tensor(self):
        """The parameter's torch tensor (the one registered on its
        module)."""
        self._check_init()
        return self._data

    def data(self, ctx=None):
        """The parameter's value as an NDArray over its tensor."""
        self._check_init()
        return self._nd

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        """The gradient buffer as an NDArray (allocated as zeros on first
        use)."""
        self._check_init()
        if self.grad_req == "null" or not self._data.requires_grad:
            raise RuntimeError("parameter %s has grad_req=null" % self.name)
        if self._data.grad is None:
            self._data.grad = torch.zeros_like(self._data)
        return NDArray(self._data.grad, fixed=True)

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        if self._data is not None and self._data.grad is not None:
            with torch.no_grad():
                self._data.grad.zero_()

    def set_data(self, data, device=None):
        """Write ``data`` (numpy or tensor) into the parameter in place; an
        uninitialized parameter adopts its shape, on ``device`` (default:
        its deferred-init device, else :func:`current_device`)."""
        if isinstance(data, NDArray):
            data = data._data
        if isinstance(data, torch.Tensor):
            t = data.detach().to(_torch_dtype(self.dtype))
        else:
            t = torch.from_numpy(np.array(data, dtype=_host_dtype(
                self.dtype))).to(_torch_dtype(self.dtype))
        if self._data is None:
            if device is None:
                device = self._deferred_init[1] if self._deferred_init \
                    else current_device()
            self.shape = tuple(t.shape)
            self._init_impl(t.to(resolve_device(device)).clone())
            return
        if tuple(t.shape) != tuple(self._data.shape):
            raise MXNetError("set_data: %s has shape %s, got %s"
                             % (self.name, tuple(self._data.shape),
                                tuple(t.shape)))
        with torch.no_grad():
            self._data.copy_(t)

    def cast(self, dtype):
        """Change the parameter's dtype in place (float32, float64,
        float16 or bfloat16, as ``"bfloat16"`` / ``torch.bfloat16``); the
        tensor keeps its identity and drops its gradient
        (``gluon/parameter.py:155-162``)."""
        tdt = _torch_dtype(dtype)
        if tdt not in (torch.float32, torch.float64, torch.float16,
                       torch.bfloat16):
            raise ValueError("cast to %s: a parameter is float32, float64, "
                             "float16 or bfloat16" % (dtype,))
        self.dtype = _dtype_tag(tdt)
        if self._data is not None:
            with torch.no_grad():
                self._data.data = self._data.data.to(tdt)
            self._data.grad = None


class Constant(Parameter):
    """A parameter that is never updated: ``grad_req="null"``, initialized
    to ``value`` (reference ``gluon/parameter.py:179-192``)."""

    def __init__(self, name, value):
        from ..ndarray import NDArray, array
        if not isinstance(value, NDArray):
            value = array(value, ctx="cpu")
        self.value = value
        host = value.asnumpy()

        class _Init(initializer.Initializer):
            def _init_weight(self_, _, arr, rng):
                initializer._set(arr, host)

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_Init())


class ParameterDict:
    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        return "ParameterDict(%s)" % ", ".join(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        else:
            for k, v in kwargs.items():
                if k == "shape" and v is not None and param.shape is not None:
                    param.shape = v
                elif getattr(param, k, None) is None and v is not None:
                    setattr(param, k, v)
        return param

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError("duplicate parameter %s" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, rng=None):
        init = init or initializer.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit, rng=rng)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)
