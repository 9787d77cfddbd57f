"""Executor: a bound symbol, the port of ``mxnet_tpu/executor.py``.

One device, forward only.  Binding places every argument and auxiliary
array on the device (CUDA unless ``ctx`` names the CPU) and orders the
graph once (``symbol.graph_plan``); :meth:`Executor.forward` runs it
eagerly, op by op, freeing each intermediate after its last consumer.
Where the reference compiles one XLA program per input signature, the
port records the signatures it has executed (argument and auxiliary
shapes and dtypes, and the train flag) in :meth:`jit_cache_keys`, so the
serving layer's contract — no new signature after warm-up — reads the
same.  A random op draws from the seeded generator of the bound device
(``_rng``), in graph order, as the reference's executor draws from its
key.  ``backward`` is ROADMAP.md queue A, item 4; device lists (a mesh)
and ``group2ctx`` are items 6-7.
"""
from __future__ import annotations

import torch

from .base import MXNetError, resolve_device
from .context import current_context
from .ndarray import NDArray
from .ndarray.ndarray import torch_dtype
from .symbol.symbol import graph_plan

__all__ = ["Executor"]


def _device_of(ctx):
    if isinstance(ctx, (list, tuple)):
        raise NotImplementedError(
            "binding over a device list (a mesh) is ROADMAP.md queue A, "
            "items 6-7; pass one device")
    return current_context() if ctx is None else resolve_device(ctx)


def _tensor(x, device, dtype=None):
    if isinstance(x, NDArray):
        x = x._data
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return x.to(device=device, dtype=dtype)


class Executor:
    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="null", aux_states=None, group2ctx=None):
        if group2ctx:
            raise NotImplementedError(
                "group2ctx placement is ROADMAP.md queue A, items 6-7")
        if args_grad is not None:
            raise NotImplementedError(
                "gradient arrays (Executor.backward) are ROADMAP.md queue A, "
                "item 4")
        self._symbol = symbol
        self._device = _device_of(ctx)
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        if args is None:
            raise MXNetError("bind requires args")
        arg_dict = dict(args) if isinstance(args, dict) \
            else dict(zip(self._arg_names, args))
        missing = [n for n in self._arg_names if n not in arg_dict]
        if missing:
            raise MXNetError("missing arguments: %r" % (missing,))
        self.arg_dict = {n: NDArray(_tensor(arg_dict[n], self._device))
                         for n in self._arg_names}
        aux_states = aux_states or {}
        if not isinstance(aux_states, dict):
            aux_states = dict(zip(self._aux_names, aux_states))
        self.aux_dict = {n: NDArray(_tensor(aux_states[n], self._device))
                         for n in self._aux_names}
        self._steps, self._heads = graph_plan(symbol)
        self.outputs = []
        self._jit_cache_keys = set()

    @classmethod
    def simple_bind(cls, symbol, ctx=None, grad_req="null", type_dict=None,
                    shapes=None, group2ctx=None, lint=False):
        """Allocate zero arguments (ones for ``*_var`` aux states) from the
        inferred shapes, in ``type_dict``'s dtypes (float32 otherwise)."""
        if lint:
            raise NotImplementedError(
                "simple_bind(lint=True) runs mxlint: ROADMAP.md queue A, "
                "item 13")
        shapes = shapes or {}
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        if arg_shapes is None:
            raise MXNetError(
                "simple_bind: cannot infer all shapes from %r" % (shapes,))
        device = _device_of(ctx)
        type_dict = type_dict or {}
        args = {n: torch.zeros(s, device=device,
                               dtype=torch_dtype(type_dict.get(n, "float32")))
                for n, s in zip(symbol.list_arguments(), arg_shapes)}
        aux = {n: (torch.ones if n.endswith("_var") else torch.zeros)(
            s, device=device) for n, s in zip(symbol.list_auxiliary_states(),
                                             aux_shapes)}
        return cls(symbol, device, args=args, grad_req=grad_req,
                   aux_states=aux, group2ctx=group2ctx)

    def forward(self, is_train=False, **kwargs):
        """Run the graph on the bound arrays, with ``kwargs`` fed into the
        named arguments first.  A float-bound slot fed uint8 or another
        float width is cast on the device after the transfer, so a feed
        never changes the executed signature (the reference's rule)."""
        for n, v in kwargs.items():
            if n not in self.arg_dict:
                raise MXNetError("unknown argument %r" % n)
            raw = _tensor(v, self._device)
            bound = self.arg_dict[n]._data.dtype
            if raw.dtype != bound and bound.is_floating_point and (
                    raw.dtype == torch.uint8 or raw.dtype.is_floating_point):
                raw = raw.to(bound)
            self.arg_dict[n]._set_data(raw)
        args = {n: a._data for n, a in self.arg_dict.items()}
        aux = {n: a._data for n, a in self.aux_dict.items()}
        self._jit_cache_keys.add((
            bool(is_train),
            tuple(sorted((n, tuple(v.shape), str(v.dtype))
                         for n, v in args.items())),
            tuple(sorted((n, tuple(v.shape), str(v.dtype))
                         for n, v in aux.items()))))
        env = {}
        with torch.no_grad():
            for node, op, params, ins, release in self._steps:
                if op is None:
                    env[(id(node), 0)] = (aux if node._is_aux
                                          else args)[node.name]
                else:
                    if op.needs_train:
                        params = dict(params, _train=bool(is_train))
                    if not ins and "ctx" in op.fn_params:
                        params = dict(params, ctx=self._device)
                    outs = op.fn(*(env[k] for k in ins), **params)
                    if not isinstance(outs, tuple):
                        outs = (outs,)
                    for i, o in enumerate(outs):
                        env[(id(node), i)] = o
                for key in release:
                    env.pop(key, None)
        self.outputs = [NDArray(env[k]) for k in self._heads]
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        raise NotImplementedError(
            "Executor.backward is ROADMAP.md queue A, item 4")

    def jit_cache_keys(self):
        """Signatures executed so far: a stable set across a load window
        proves there was no new one (the serving contract)."""
        return set(self._jit_cache_keys)

    def __repr__(self):
        return "<Executor %s on %s>" % (self._symbol.name or "group",
                                        self._device)
