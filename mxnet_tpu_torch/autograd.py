"""Imperative autograd on torch's tape: the port of ``mxnet_tpu/autograd.py``.

MXNet's rules, kept on torch's autograd:

- Only NDArray ops run inside :func:`record` are differentiable.  An op
  runs under ``torch.set_grad_enabled(is_recording())``
  (``ndarray.invoke``), so outside the scope it builds no graph.
- A variable is an NDArray marked by ``attach_grad`` / :func:`mark_variables`
  (a ``Parameter``'s data is one): a leaf tensor with
  ``requires_grad``, its gradient buffer in the tensor's ``.grad``.
  :func:`backward` takes the gradients of the heads with respect to
  every live variable through ``torch.autograd.grad`` and writes them
  into those buffers: ``grad_req="write"`` overwrites, ``"add"``
  accumulates, as the reference's ``_write_leaf_grad`` does
  (``mxnet_tpu/autograd.py:231-256``).  A variable the heads do not reach
  keeps its buffer as it was.
- ``backward`` on a head that was not recorded raises; without
  ``retain_graph`` torch frees the graph, and a second ``backward``
  through it raises.
- :func:`grad` returns the gradients instead of writing them; with
  ``create_graph=True`` they are themselves recorded, so a second
  ``backward`` through them gives higher-order gradients.
- :class:`Function` is a ``torch.autograd.Function`` whose forward and
  backward are written over NDArrays.

``is_training()`` is the flag BatchNorm and Dropout read when a block is
called on NDArrays (``gluon/block.py``); ``record`` sets it to True by
default, ``pause`` to False.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = [
    "record", "pause", "train_mode", "predict_mode", "is_recording",
    "is_training", "set_recording", "set_training", "mark_variables",
    "backward", "grad", "get_symbol", "Function",
]

_state = threading.local()
# the live variables (NDArrays marked for gradients): id -> weak reference
# (not a WeakSet, whose lookups compare NDArrays with ``==``)
_VARIABLES = {}


def _variables():
    return [v for v in (r() for r in list(_VARIABLES.values()))
            if v is not None]


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    prev = _st().recording
    _st().recording = bool(is_record)
    return prev


def set_training(train_mode_):
    prev = _st().training
    _st().training = bool(train_mode_)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train_mode_):
        self._enter_record = is_record
        self._enter_train = train_mode_
        self._prev = None

    def __enter__(self):
        s = _st()
        self._prev = (s.recording, s.training)
        if self._enter_record is not None:
            s.recording = self._enter_record
        if self._enter_train is not None:
            s.training = self._enter_train
        return self

    def __exit__(self, *exc):
        s = _st()
        s.recording, s.training = self._prev


def record(train_mode=True):
    """Scope whose NDArray ops are recorded for gradients."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def _mark(arr, grad_req):
    """Make ``arr`` a variable with gradient buffer semantics
    ``grad_req`` ("null" unmarks it)."""
    arr._grad_req = grad_req
    key = id(arr)
    if grad_req == "null":
        _VARIABLES.pop(key, None)
        return
    t = arr._data
    if not (t.is_leaf and t.requires_grad):
        if arr._fixed:
            raise MXNetError("a parameter's array is marked by its "
                             "Parameter, not by attach_grad")
        t = t.detach().requires_grad_(True)
        arr._data = t
    _VARIABLES[key] = weakref.ref(arr, lambda _, k=key: _VARIABLES.pop(k,
                                                                      None))


def mark_variables(variables, gradients, grad_reqs="write"):
    """Mark NDArrays as variables whose gradients go into ``gradients``
    (each one's buffer becomes the tensor of the matching NDArray)."""
    if not isinstance(variables, (list, tuple)):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        _mark(v, req)
        if req != "null":
            v._data.grad = g._data


def _heads(heads, head_grads):
    from .ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    outs, grads = [], []
    for h, hg in zip(heads, head_grads):
        if not h._data.requires_grad:
            raise MXNetError(
                "cannot run backward on an array computed outside "
                "autograd.record() (no gradient graph attached)")
        outs.append(h._data)
        if hg is None:
            grads.append(torch.ones_like(h._data))
        else:
            grads.append(hg._data if isinstance(hg, NDArray)
                         else torch.as_tensor(hg, dtype=h._data.dtype,
                                              device=h._data.device))
    return outs, grads


def backward(heads, head_grads=None, retain_graph=False, train_mode=True,
             create_graph=False):
    """Gradients of ``heads`` with respect to every live variable, written
    into the variables' buffers by their ``grad_req``."""
    outs, grads = _heads(heads, head_grads)
    leaves = [v for v in _variables()
              if v._grad_req != "null" and v._data.requires_grad]
    if not leaves:
        return
    got = torch.autograd.grad(outs, [v._data for v in leaves], grads,
                              retain_graph=retain_graph or create_graph,
                              create_graph=create_graph, allow_unused=True)
    with torch.no_grad():
        for v, g in zip(leaves, got):
            if g is None:
                continue
            t = v._data
            if t.grad is None:
                t.grad = torch.zeros_like(t)
            if v._grad_req == "add":
                t.grad.add_(g)
            else:
                t.grad.copy_(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables`` (NDArrays
    that took part in the recorded graph), returned instead of written;
    recorded themselves when ``create_graph``."""
    from .ndarray import NDArray
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    outs, grads = _heads(heads, head_grads)
    keep = True if retain_graph is None else retain_graph
    got = torch.autograd.grad(outs, [v._data for v in variables], grads,
                              retain_graph=keep or create_graph,
                              create_graph=create_graph, allow_unused=True)
    if any(g is None for g in got):
        raise ValueError("some variables do not participate in the graph")
    res = [NDArray(g if create_graph else g.detach()) for g in got]
    return res[0] if single else res


def get_symbol(x):
    """The recorded graph as a Symbol: neither package exports the tape;
    this raises as the reference's does."""
    raise NotImplementedError("use mxnet_tpu_torch.symbol to build "
                              "symbolic graphs")


class Function:
    """A differentiable function with explicit ``forward(*inputs)`` and
    ``backward(*output_grads)`` over NDArrays, run as a
    ``torch.autograd.Function`` while recording."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        fn = self
        single = []

        class _Apply(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *xs):
                with pause():
                    out = fn.forward(*[NDArray(x) for x in xs])
                single.append(not isinstance(out, (list, tuple)))
                outs = [out] if single[0] else list(out)
                return tuple(o._data.clone() for o in outs)

            @staticmethod
            def backward(ctx, *gs):
                with pause():
                    got = fn.backward(*[NDArray(g) for g in gs])
                got = got if isinstance(got, (list, tuple)) else [got]
                return tuple(g._data if isinstance(g, NDArray) else g
                             for g in got)

        outs = _Apply.apply(*[i._data for i in inputs])
        nds = [NDArray(o) for o in outs]
        return nds[0] if single[0] else nds
