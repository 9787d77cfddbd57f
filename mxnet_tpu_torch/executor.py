"""Executor: a bound symbol, the port of ``mxnet_tpu/executor.py``.

One device.  Binding places every argument and auxiliary array on the
device (CUDA unless ``ctx`` names the CPU) and orders the graph once
(``symbol.graph_plan``); :meth:`Executor.forward` runs it eagerly, op by
op, freeing each intermediate after its last consumer.  Where the
reference compiles one XLA program per input signature, the port records
the signatures it has executed (argument and auxiliary shapes and
dtypes, and the train flag) in :meth:`jit_cache_keys`, so the serving
layer's contract — no new signature after warm-up — reads the same.  A
random op draws from the seeded generator of the bound device (``_rng``),
in graph order, as the reference's executor draws from its key.

Gradients (``grad_req`` ``"write"`` / ``"add"`` / ``"null"`` per
argument, as a str, a list or a dict).  A training forward
(``is_train=True``) of an executor with any argument to differentiate
runs with autograd on: those arguments enter as leaf tensors that
require grad, and the graph is kept until :meth:`backward`, which takes
``torch.autograd.grad`` of the heads (``out_grads``, or ones) and writes
each argument's gradient into ``grad_dict``.  Every other forward runs
under ``torch.no_grad()`` (the serving path).  As in the reference:

- a gradient autograd reports unused (``BatchNorm(fix_gamma=True)``'s
  gamma, anything behind ``BlockGrad``) is written as zeros;
- ``"add"`` accumulates across backward calls;
- the moving statistics update once per training forward, never in
  backward, and a random op's draw is the forward's (the graph holds
  it);
- a backward with no kept graph (after an inference forward, or a second
  backward) runs the training forward again on copies of the auxiliary
  states, as the reference's backward rematerializes it, and so updates
  no moving statistic (a random op there draws anew).

Device lists (a mesh) and ``group2ctx`` are ROADMAP.md queue A, items
6-7.
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


def _as_nd(x, device):
    """An NDArray on ``device``: ``x`` itself when it is one (moved there
    if it lies elsewhere, as the reference places the arrays it is
    given), else a new one."""
    if not isinstance(x, NDArray):
        return NDArray(_tensor(x, device))
    t = x._data.to(device)
    if t is not x._data:
        x._set_data(t)
    return x


def run_plan(steps, heads, args, aux, is_train, device):
    """Run a ``graph_plan`` on the tensors ``args`` / ``aux`` (by name);
    returns the head tensors.  Autograd records whatever the caller's
    grad mode records."""
    env = {}
    for node, op, params, ins, release in steps:
        if op is None:
            env[(id(node), 0)] = (aux if node._is_aux else args)[node.name]
        else:
            if op.needs_train:
                params = dict(params, _train=bool(is_train))
            if not ins and "ctx" in op.fn_params:
                params = dict(params, ctx=device)
            outs = op.fn(*(env[k] for k in ins), **params)
            if not isinstance(outs, tuple):
                outs = (outs,)
            for i, o in enumerate(outs):
                env[(id(node), i)] = o
        for key in release:
            env.pop(key, None)
    return [env[k] for k in heads]


def _grad_reqs(grad_req, names):
    if isinstance(grad_req, str):
        reqs = {n: grad_req for n in names}
    elif isinstance(grad_req, (list, tuple)):
        reqs = dict(zip(names, grad_req))
    else:
        reqs = {n: grad_req.get(n, "null") for n in names}
    for n, r in reqs.items():
        if r not in ("write", "add", "null", "inplace"):
            raise MXNetError("grad_req %r of %r is not write, add or null"
                             % (r, n))
    return {n: reqs.get(n, "null") for n in names}


class Executor:
    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None, data_names=None,
                 group2ctx=None):
        if group2ctx:
            raise NotImplementedError(
                "group2ctx placement is ROADMAP.md queue A, items 6-7")
        self._symbol = symbol
        self._device = _device_of(ctx)
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = list(data_names) if data_names else []
        if args is None:
            raise MXNetError("bind requires args")
        arg_dict = dict(args) if isinstance(args, dict) \
            else dict(zip(self._arg_names, args))
        missing = [n for n in self._arg_names if n not in arg_dict]
        if missing:
            raise MXNetError("missing arguments: %r" % (missing,))
        self.arg_dict = {n: _as_nd(arg_dict[n], self._device)
                         for n in self._arg_names}
        self.arg_arrays = [self.arg_dict[n] for n in self._arg_names]
        aux_states = aux_states or {}
        if not isinstance(aux_states, dict):
            aux_states = dict(zip(self._aux_names, aux_states))
        self.aux_dict = {n: _as_nd(aux_states[n], self._device)
                         for n in self._aux_names}
        self.aux_arrays = [self.aux_dict[n] for n in self._aux_names]

        self._grad_req = _grad_reqs(grad_req, self._arg_names)
        self._wrt = [n for n in self._arg_names
                     if self._grad_req[n] != "null"]
        if args_grad is None:
            args_grad = {n: torch.zeros_like(self.arg_dict[n]._data)
                         for n in self._wrt}
        elif not isinstance(args_grad, dict):
            args_grad = dict(zip(self._arg_names, args_grad))
        self.grad_dict = {n: _as_nd(g, self._device)
                          for n, g in args_grad.items()
                          if g is not None and n in self._wrt}
        self.grad_arrays = [self.grad_dict.get(n) for n in self._arg_names]

        self._steps, self._heads = graph_plan(symbol)
        self.outputs = []
        self._graph = None
        self._forwarded = False
        self._jit_cache_keys = set()

    @classmethod
    def simple_bind(cls, symbol, ctx=None, grad_req="write", type_dict=None,
                    shapes=None, data_names=None, group2ctx=None,
                    lint=False):
        """Allocate zero arguments (ones for ``*_var`` aux states, zeros
        for the other aux states; float32 as in the reference) from the
        inferred shapes, in ``type_dict``'s dtypes (float32 otherwise),
        and zero gradient arrays for every argument whose ``grad_req`` is
        not ``"null"``."""
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
        arg_names = symbol.list_arguments()
        args = {n: torch.zeros(s, device=device,
                               dtype=torch_dtype(type_dict.get(n, "float32")))
                for n, s in zip(arg_names, arg_shapes)}
        aux = {n: (torch.ones if n.endswith("_var") else torch.zeros)(
            s, device=device) for n, s in zip(symbol.list_auxiliary_states(),
                                             aux_shapes)}
        if data_names is None:
            data_names = [n for n in shapes if n in arg_names]
        return cls(symbol, device, args=args, grad_req=grad_req,
                   aux_states=aux, data_names=data_names,
                   group2ctx=group2ctx)

    # ------------------------------------------------------------------
    def _feed(self, kwargs):
        """Write ``kwargs`` into the named arguments.  A float-bound slot
        fed uint8 or another float width is cast on the device after the
        transfer, so a feed never changes the executed signature (the
        reference's rule)."""
        for n, v in kwargs.items():
            if n not in self.arg_dict:
                raise MXNetError("unknown argument %r" % n)
            raw = _tensor(v, self._device)
            bound = self.arg_dict[n]._data.dtype
            if raw.dtype != bound and bound.is_floating_point and (
                    raw.dtype == torch.uint8 or raw.dtype.is_floating_point):
                raw = raw.to(bound)
            self.arg_dict[n]._set_data(raw)

    def _record(self, args, aux):
        """The training forward with autograd on: ``(heads, leaves)``, the
        leaves the differentiated floating-point arguments."""
        leaves = {n: args[n].detach().requires_grad_(True)
                  for n in self._wrt if args[n].is_floating_point()}
        with torch.enable_grad():
            outs = run_plan(self._steps, self._heads, dict(args, **leaves),
                            aux, True, self._device)
        return outs, leaves

    def forward(self, is_train=False, **kwargs):
        """Run the graph on the bound arrays, with ``kwargs`` fed into the
        named arguments first; keeps the autograd graph for
        :meth:`backward` on a training forward with gradients to take."""
        self._graph = None
        self._feed(kwargs)
        args = {n: a._data for n, a in self.arg_dict.items()}
        aux = {n: a._data for n, a in self.aux_dict.items()}
        self._jit_cache_keys.add((
            bool(is_train),
            tuple(sorted((n, tuple(v.shape), str(v.dtype))
                         for n, v in args.items())),
            tuple(sorted((n, tuple(v.shape), str(v.dtype))
                         for n, v in aux.items()))))
        if is_train and self._wrt:
            self._graph = self._record(args, aux)
            self.outputs = [NDArray(o.detach()) for o in self._graph[0]]
        else:
            with torch.no_grad():
                outs = run_plan(self._steps, self._heads, args, aux,
                                is_train, self._device)
            self.outputs = [NDArray(o) for o in outs]
        self._forwarded = True
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the heads with respect to every argument whose
        ``grad_req`` is not ``"null"``, written into ``grad_dict``
        (``"write"`` replaces, ``"add"`` accumulates); ``out_grads`` None
        means ones for every head.  Returns the gradients in argument
        order."""
        if not self._forwarded:
            raise MXNetError("backward called before forward")
        if not self._wrt:
            return []
        graph, self._graph = self._graph, None
        if graph is None:
            aux = {n: a._data.clone() for n, a in self.aux_dict.items()}
            graph = self._record({n: a._data for n, a in
                                  self.arg_dict.items()}, aux)
        outs, leaves = graph
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            heads = [_tensor(g, self._device, o.dtype)
                     for g, o in zip(out_grads, outs)]
        pairs = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        names = list(leaves)
        grads = [None] * len(names)
        if pairs and names:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [leaves[n] for n in names],
                [h for _, h in pairs], allow_unused=True)
        got = dict(zip(names, grads))
        for n in self._wrt:
            g = got.get(n)
            if g is None:
                g = torch.zeros_like(self.arg_dict[n]._data)
            dst = self.grad_dict.get(n)
            if dst is None:
                self.grad_dict[n] = NDArray(g)
            elif self._grad_req[n] == "add":
                dst._set_data(dst._data + g)
            else:
                dst._set_data(g)
        self.grad_arrays = [self.grad_dict.get(n) for n in self._arg_names]
        return [self.grad_dict[n] for n in self._wrt]

    def jit_cache_keys(self):
        """Signatures executed so far: a stable set across a load window
        proves there was no new one (the serving contract)."""
        return set(self._jit_cache_keys)

    # ------------------------------------------------------------------
    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy values into the bound arrays, cast to their dtypes."""
        for table, given, what in ((self.arg_dict, arg_params, "argument"),
                                   (self.aux_dict, aux_params, "aux state")):
            for n, v in (given or {}).items():
                if n in table:
                    dst = table[n]
                    dst._set_data(_tensor(v, self._device,
                                          dst._data.dtype).clone())
                elif not allow_extra_params:
                    raise MXNetError("unknown %s %r" % (what, n))

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor at new data shapes on the same device, with the
        same ``grad_req``, sharing every other array's tensor where its
        shape is unchanged (reference: executor.h:120)."""
        shapes = {n: kwargs.get(n, self.arg_dict[n].shape)
                  for n in self._data_names} if self._data_names \
            else dict(kwargs)
        new = Executor.simple_bind(
            self._symbol, self._device, grad_req=dict(self._grad_req),
            type_dict={n: a.dtype for n, a in self.arg_dict.items()},
            shapes=shapes, data_names=self._data_names)
        for table, other in ((self.arg_dict, new.arg_dict),
                             (self.aux_dict, new.aux_dict)):
            for n, a in table.items():
                if n not in self._data_names and n in other and \
                        other[n].shape == a.shape:
                    other[n]._set_data(a._data)
        return new

    def __repr__(self):
        return "<Executor %s on %s>" % (self._symbol.name or "group",
                                        self._device)
