"""Gluon ``Block`` / ``HybridBlock`` as ``torch.nn.Module``: the port of
``mxnet_tpu/gluon/block.py``.

Naming follows the reference exactly (``name_scope``, per-scope hint
counters, empty-prefix blocks transparent), so ``collect_params()`` keys
are the reference's up to the process-wide counter of the outermost
block (``resnetv10_`` in one process may be ``resnetv13_`` in another).

A block is an ``nn.Module``: children assigned as attributes or added
with ``register_child`` are its submodules.  A block runs on torch
tensors or on NDArrays, and the two keep their own training flag:

- Called on tensors (``parallel.DataParallelTrainer``, serving), a block
  reads ``nn.Module``'s ``train()`` / ``eval()`` mode.  A new block is in
  inference mode, as a reference block called outside
  ``autograd.record(train_mode=True)`` is; the trainer switches to
  training mode for its step.
- Called on NDArrays (the reference's imperative loop), a
  ``HybridBlock`` returns NDArrays.  It runs its tensor forward under
  ``torch.set_grad_enabled(autograd.is_recording())`` — so it lands on
  the tape only inside ``autograd.record()`` — and every block under it
  reads ``autograd.is_training()`` as its training flag
  (:meth:`Block._train_flag`), as the reference's forward passes it
  (``mxnet_tpu/gluon/block.py:382,388``): BatchNorm's moving statistics
  update exactly when that flag is on, under ``record(train_mode=False)``
  and ``pause(train_mode=True)`` as elsewhere.

``hybrid_forward(F, x, **params)`` gets ``F``, every registered op's
torch function by name (``ops.registry.namespace()``), and the
parameters' tensors.

Parameters with a 0 in their shape are initialized at the first forward
(``infer_param_shapes``).  ``hybridize()`` compiles nothing — PyTorch
runs eagerly — but keeps the reference's recompile contract meaningful:
the outermost hybridized block records each (input shapes/dtypes,
training flag) signature it is called with, and ``jit_cache_keys()``
returns them, as the reference's ``CachedOp`` cache keys do.

:func:`compute_dtype` is how a mixed-precision trainer runs a block in
bfloat16 over f32 parameters (the reference casts every float parameter
at the step's forward boundary, ``parallel/trainer.py:1328-1369``): inside
the scope ``HybridBlock.forward`` hands ``hybrid_forward`` casts of its
trainable float parameters, so the gradients flow back through the casts
into the f32 tensors.  Auxiliary state (``grad_req="null"``: BatchNorm's
moving statistics) is handed over as it is; the op casts it for its
forward and writes its update back into the f32 tensors
(``ops/nn.py``).  Not ``torch.autocast``, whose per-op lists keep some
ops in f32.
"""
from __future__ import annotations

import contextlib
import re
import threading

import torch

from .. import autograd
from ..ndarray import NDArray
from ..ops import registry as _registry
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "compute_dtype", "run_on_tensors"]

_compute = threading.local()
# the training flag of blocks called on NDArrays (None: nn.Module's mode)
_nd_training = threading.local()


@contextlib.contextmanager
def compute_dtype(dtype):
    """Run the blocks called in this thread inside the scope with their
    trainable float parameters cast to ``dtype`` (module docstring);
    ``None`` or float32 casts nothing."""
    prev = getattr(_compute, "dtype", None)
    _compute.dtype = None if dtype in (None, torch.float32) else dtype
    try:
        yield
    finally:
        _compute.dtype = prev


def _for_compute(param, dtype):
    """The tensor ``hybrid_forward`` gets for ``param``."""
    t = param.tensor()
    if dtype is None or param.grad_req == "null" \
            or not t.is_floating_point() or t.dtype == dtype:
        return t
    return t.to(dtype)


class _BlockScope:
    _current = threading.local()
    _global_counter = {}

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def current():
        return getattr(_BlockScope._current, "value", None)

    @staticmethod
    def create(prefix, params, hint):
        current = _BlockScope.current()
        if current is None:
            if prefix is None:
                count = _BlockScope._global_counter.get(hint, 0)
                _BlockScope._global_counter[hint] = count + 1
                prefix = "%s%d_" % (hint, count) if hint else ""
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        # empty-prefix blocks are naming-transparent: the parent scope
        # stays active so sibling counters continue
        if self._block._empty_prefix:
            return self
        self._old_scope = _BlockScope.current()
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


class Block(torch.nn.Module):
    """Base building block (reference: gluon/block.py:126)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = {}
        self._reg_params = {}
        self.training = False

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            existing = self.__dict__.get("_children")
            if existing is not None:
                existing[name] = value
        elif isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is not None:
                reg[name] = value
                value._attach(self, name)
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        name = name or str(len(self._children))
        self._children[name] = block
        self.add_module(name, block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, rng=None):
        """Initialize every parameter on ``ctx`` (default: CUDA unless the
        caller asks for the CPU), drawing from ``rng``: a
        ``numpy.random.RandomState``, a ``torch.Generator``, or numpy's
        global RNG when None (seeded by ``mx.random.seed``)."""
        from .. import initializer
        self.collect_params().initialize(init or initializer.Uniform(), ctx,
                                         verbose, force_reinit, rng=rng)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast every parameter in place (float32, float64, float16 or
        bfloat16)."""
        for child in self._children.values():
            child.cast(dtype)
        for param in self._reg_params.values():
            param.cast(dtype)

    def _train_flag(self):
        """The training flag this block runs with: ``autograd.is_training()``
        inside a call on NDArrays, else ``nn.Module``'s mode."""
        flag = getattr(_nd_training, "value", None)
        return self.training if flag is None else flag

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, format="mxtpu"):
        """Every initialized parameter under its attribute path
        (``features.0.weight``), in ``format`` ("mxtpu" or the reference's
        "mxnet" dmlc stream) — the bytes the reference writes for the same
        values."""
        from ..serialization import save_ndarrays
        params = self._collect_params_with_prefix()
        save_ndarrays(filename, {k: v.tensor() for k, v in params.items()
                                 if v._data is not None}, format=format)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        """Load a file of :meth:`save_parameters` (either format); a
        parameter not yet initialized is created on ``ctx`` (default: its
        deferred-init device, else the CUDA device)."""
        from ..serialization import load_ndarrays
        loaded = load_ndarrays(filename, ctx="cpu")
        params = self._collect_params_with_prefix()
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise IOError("missing parameter %r in %s"
                                  % (name, filename))
        for name, data in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise IOError("unknown parameter %r in %s"
                                  % (name, filename))
                continue
            params[name].set_data(data, device=ctx)

    def __call__(self, *args, **kwargs):
        if _has_ndarray(args):
            return _call_on_ndarrays(self, args, kwargs)
        return super().__call__(*args, **kwargs)

    def _apply(self, fn, *args, **kwargs):
        raise NotImplementedError(
            "a gluon block lives on the device it was initialized on: pass "
            "ctx= to initialize() (or device= to from_jax_params) instead "
            "of moving it with .to()/.cuda()")

    def forward(self, *args, **kwargs):
        raise NotImplementedError


def _has_ndarray(args):
    """Whether an NDArray is among ``args`` or inside a list or tuple of
    them (a recurrent cell's states)."""
    return any(isinstance(a, NDArray) or (isinstance(a, (list, tuple))
                                          and _has_ndarray(a))
               for a in args)


def _unwrap(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    return x


def _wrap(x):
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    if isinstance(x, (list, tuple)):
        return [_wrap(v) for v in x]
    return x


def run_on_tensors(fn, args, kwargs):
    """``fn`` on the tensors of NDArray arguments (lists and tuples of
    them too), recorded only while recording and with autograd's training
    flag (module docstring); its tensors come back as NDArrays, its lists
    and tuples as lists."""
    raw = _unwrap(args)
    kw = {k: _unwrap(v) for k, v in kwargs.items()}
    prev = getattr(_nd_training, "value", None)
    _nd_training.value = autograd.is_training()
    try:
        with torch.set_grad_enabled(autograd.is_recording()):
            out = fn(*raw, **kw)
    finally:
        _nd_training.value = prev
    return _wrap(out)


def _call_on_ndarrays(block, args, kwargs):
    """Run ``block`` on NDArray inputs (module docstring): a
    ``HybridBlock`` on their tensors (:func:`run_on_tensors`); a plain
    ``Block``'s ``forward`` on the NDArrays themselves."""
    if not isinstance(block, HybridBlock):
        return block.forward(*args, **kwargs)
    return run_on_tensors(
        lambda *a, **k: torch.nn.Module.__call__(block, *a, **k), args,
        kwargs)


_active_depth = threading.local()


class HybridBlock(Block):
    """Block whose ``hybrid_forward(F, x, **params)`` gets the operator
    namespace ``F`` (``ops.registry.namespace()``) and its parameters'
    tensors (reference: gluon/block.py:669)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._jit_keys = set()

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        self._active = active
        self._jit_keys = set()
        super().hybridize(active, **kwargs)

    def infer_param_shapes(self, *args):
        """Resolve deferred parameter shapes from input shapes; layers
        with deferred parameters override this."""

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def forward(self, *args, **kwargs):
        if any(p._deferred_init for p in self._reg_params.values()):
            self.infer_param_shapes(*args)
            for p in self._reg_params.values():
                if p._deferred_init:
                    p._finish_deferred_init()
        depth = getattr(_active_depth, "value", 0)
        if self._active and depth == 0:
            self._jit_keys.add((
                tuple((tuple(a.shape), str(a.dtype)) for a in args
                      if isinstance(a, torch.Tensor)),
                bool(self._train_flag()),
                tuple(sorted(kwargs.items())) if kwargs else ()))
        _active_depth.value = depth + (1 if self._active else 0)
        try:
            cdt = getattr(_compute, "dtype", None)
            pkw = {name: _for_compute(p, cdt)
                   for name, p in self._reg_params.items()}
            return self.hybrid_forward(_registry.namespace(), *args, **pkw,
                                       **kwargs)
        finally:
            _active_depth.value = depth

    def jit_cache_keys(self):
        """The signatures this block (and its hybridized children) were
        called with since ``hybridize()``; a stable set means no
        recompile in the reference's terms."""
        keys = {(self.name, k) for k in self._jit_keys}
        for child in self._children.values():
            if isinstance(child, HybridBlock):
                keys |= child.jit_cache_keys()
        return keys
