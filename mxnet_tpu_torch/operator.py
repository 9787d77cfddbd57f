"""Custom operators written in Python, the port of
``mxnet_tpu/operator.py``: ``CustomOp`` / ``CustomOpProp``,
``register`` and ``get_all_registered_operators``, run by ``nd.Custom``
(the reference wires it into ``nd`` only, and so does the port).

``nd.Custom(*data, op_type=name, **params)`` builds the registered
prop with its parameters as strings, infers the output shapes and
dtypes, and runs the op's ``forward(is_train, req, in_data, out_data,
aux)`` on NDArrays on the inputs' device, with recording paused.  While
``autograd.record()`` is on and an input is a variable (or depends on
one), the call runs as a ``torch.autograd.Function`` whose backward
calls the op's ``backward(req, out_grad, in_data, out_data, in_grad,
aux)`` with zeroed ``in_grad`` arrays; the op writes through
:meth:`CustomOp.assign` (``"write"`` / ``"inplace"`` replace, ``"add"``
accumulates, ``"null"`` skips), as the reference's protocol has it.
"""
from __future__ import annotations

import torch

from . import autograd
from .base import MXNetError
from .ndarray import NDArray

__all__ = ["CustomOp", "CustomOpProp", "register",
           "get_all_registered_operators"]

_REGISTRY = {}


def _as_tensor(src, like):
    if isinstance(src, NDArray):
        return src._data
    return torch.as_tensor(src, dtype=like._data.dtype,
                           device=like._data.device)


class CustomOp:
    """Base class of an operator's implementation."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as ``req`` asks."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst._set_data(_as_tensor(src, dst))
        elif req == "add":
            dst._set_data(dst._data + _as_tensor(src, dst))
        else:
            raise ValueError("unknown req %r" % req)


class CustomOpProp:
    """Describes an operator: its arguments, outputs, shapes and types."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps


def register(reg_name):
    """Class decorator registering a ``CustomOpProp`` under a name."""

    def deco(prop_cls):
        _REGISTRY[reg_name] = prop_cls
        return prop_cls

    return deco


def get_all_registered_operators():
    return sorted(_REGISTRY)


def _invoke_custom(op_type, inputs, kwargs):
    """Run the registered op ``op_type`` on NDArrays (module docstring)."""
    from . import ndarray as nd
    if op_type not in _REGISTRY:
        raise MXNetError("custom op %r not registered (have %r)"
                         % (op_type, get_all_registered_operators()))
    prop = _REGISTRY[op_type](**{k: str(v) for k, v in kwargs.items()})
    args = prop.list_arguments()
    if len(inputs) != len(args):
        raise MXNetError("%s expects %d inputs (%r), got %d"
                         % (op_type, len(args), args, len(inputs)))
    device = inputs[0].context
    in_shapes, out_shapes, _ = prop.infer_shape(
        [list(a.shape) for a in inputs])
    in_types, out_types, _ = prop.infer_type([a.dtype for a in inputs])
    op = prop.create_operator(device, in_shapes, in_types)
    is_train = autograd.is_training()

    def run_forward(tensors):
        in_data = [NDArray(t.detach()) for t in tensors]
        out_data = [nd.zeros(tuple(s), ctx=device, dtype=t)
                    for s, t in zip(out_shapes, out_types)]
        with autograd.pause(train_mode=is_train):
            op.forward(is_train, ["write"] * len(out_data), in_data,
                       out_data, [])
        return in_data, out_data

    raw = [a._data for a in inputs]
    if not (autograd.is_recording() and any(t.requires_grad for t in raw)):
        out_data = run_forward(raw)[1]
        return out_data[0] if len(out_data) == 1 else out_data

    class _Custom(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *tensors):
            ctx.io = run_forward(tensors)
            return tuple(o._data.clone() for o in ctx.io[1])

        @staticmethod
        def backward(ctx, *grads):
            in_data, out_data = ctx.io
            in_grad = [nd.zeros(a.shape, ctx=device, dtype=a.dtype)
                       for a in in_data]
            with autograd.pause(train_mode=is_train):
                op.backward(["write"] * len(in_grad),
                            [NDArray(g) for g in grads], in_data, out_data,
                            in_grad, [])
            return tuple(g._data for g in in_grad)

    outs = [NDArray(t) for t in _Custom.apply(*raw)]
    return outs[0] if len(outs) == 1 else outs


def _custom_entry(*args, **kwargs):
    """``nd.Custom(*data, op_type='name', **params)``."""
    from . import ndarray as nd
    op_type = kwargs.pop("op_type", None)
    if op_type is None:
        raise MXNetError("Custom requires op_type=")
    kwargs.pop("name", None)
    inputs = [a if isinstance(a, NDArray) else nd.array(a) for a in args]
    return _invoke_custom(op_type, inputs, kwargs)
