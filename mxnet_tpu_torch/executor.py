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

A device list (``ctx=[cpu(0), cpu(1)]``, the reference's data mesh)
binds its in-process ranks on the one device they name: under GSPMD the
reference's forward over the whole batch is the same numbers, as the
port's in-process data ranks (``parallel/mesh.py``) hold.  A list naming
distinct devices is the ranks of a multi-card process, ROADMAP.md queue
A, item A6(c).

``group2ctx`` (``executor.py:37-52,120-150``): a ``Context`` value means
replicated; a ``PartitionSpec`` (or tuple) shards every argument of its
``ctx_group`` over the axes of a port :class:`~.parallel.mesh.Mesh`
bound as ``ctx``.  The groups (``_group_specs``) and each argument's
group (``_arg_groups``) are recorded, and :meth:`Executor._sharding`
reads an argument's ``NamedSharding``: the group's spec fitted to the
argument's shape by :func:`_fit_spec` (an axis kept only where the
dimension divides), as the reference's GSPMD placement reads.  The
ranks of an in-process mesh run on its one device, so every array lives
whole there: placement changes no number, as it changes none under
GSPMD (the port's in-process ``param_spec_fn`` does the same,
``parallel/trainer.py``).  Over a process-group mesh a sharding value
raises: parameters sharded across processes are ROADMAP.md queue A,
item A7(b).
"""
from __future__ import annotations

import torch

from .base import MXNetError, as_torch_device, resolve_device
from .context import current_device
from .ndarray import NDArray
from .ndarray.ndarray import torch_dtype
from .symbol.symbol import graph_plan

__all__ = ["Executor"]


def _fit_spec(spec, shape, mesh):
    """Fit a group's PartitionSpec onto a tensor of ``shape``: keep an axis
    only where the dimension divides by its size (one group covers
    tensors of many shapes, as ``ctx_group`` did; reference
    ``executor.py:37-52``)."""
    from .parallel.mesh import PartitionSpec
    sizes = mesh.shape
    out = []
    for d, ax in enumerate(tuple(spec)[:len(shape)]):
        if ax is None:
            out.append(None)
            continue
        total = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            total *= sizes.get(a, 1)
        out.append(ax if shape[d] % total == 0 else None)
    return PartitionSpec(*out)


def _device_of(ctx):
    from .parallel.mesh import Mesh
    if isinstance(ctx, Mesh):
        ctx = list(ctx.devices.flat) if not ctx.process_group \
            else ctx.local_device
    if isinstance(ctx, (list, tuple)):
        devs = []
        for c in ctx:
            d = torch.device(as_torch_device(c))
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device()
                                 if torch.cuda.is_available() else 0)
            if d not in devs:
                devs.append(d)
        if len(devs) != 1:
            raise NotImplementedError(
                "binding over the distinct devices %s: the ranks of a "
                "multi-card process are ROADMAP.md queue A, item A6(c); a "
                "device list naming one device binds its ranks there"
                % [str(d) for d in devs])
        return resolve_device(devs[0])
    return current_device() if ctx is None else resolve_device(ctx)


def check_group2ctx(group2ctx, ctx=None):
    """The group -> ``PartitionSpec`` map of ``group2ctx`` (reference
    ``executor.py:125-137``): a spec (or tuple) as given, a ``Context``
    (or device) value replicated, resolved to check it.  A spec that
    shards a group over a process-group mesh raises (item A7(b))."""
    from .parallel.mesh import Mesh, PartitionSpec
    specs = {}
    for group, value in (group2ctx or {}).items():
        if isinstance(value, (list, tuple)) and not isinstance(
                value, PartitionSpec):
            value = PartitionSpec(*value)
        if isinstance(value, PartitionSpec):
            if any(a is not None for a in value) and isinstance(
                    ctx, Mesh) and ctx.process_group:
                raise NotImplementedError(
                    "group2ctx[%r] = %r shards the group over a mesh of "
                    "one rank per process: parameters sharded across "
                    "processes are ROADMAP.md queue A, item A7(b)"
                    % (group, value))
            specs[group] = value
            continue
        resolve_device(value)
        specs[group] = PartitionSpec()
    return specs


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
        from .parallel.mesh import Mesh
        self._group_specs = check_group2ctx(group2ctx, ctx)
        self._symbol = symbol
        self._device = _device_of(ctx)
        self._mesh = ctx if isinstance(ctx, Mesh) else None
        self._arg_groups = {
            node.name: node.attrs["ctx_group"] for node in symbol._nodes()
            if node.op is None
            and node.attrs.get("ctx_group") in self._group_specs}
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

    def _sharding(self, name):
        """The ``NamedSharding`` of argument (or auxiliary state) ``name``
        over the bound mesh (None without one): its group's spec fitted
        to its shape, the batch over ``data`` for a data or label
        argument, else replicated (reference ``executor.py:190-200``)."""
        from .parallel.mesh import NamedSharding, PartitionSpec
        if self._mesh is None:
            return None
        if name in self._arg_groups:
            arr = self.arg_dict.get(name, self.aux_dict.get(name))
            spec = self._group_specs[self._arg_groups[name]]
            if arr is not None:
                spec = _fit_spec(spec, tuple(arr.shape), self._mesh)
            return NamedSharding(self._mesh, spec)
        if (name in self._data_names or name.endswith("_label")) \
                and "data" in self._mesh.axis_names:
            return NamedSharding(self._mesh, PartitionSpec("data"))
        return NamedSharding(self._mesh, PartitionSpec())

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
        from .parallel.mesh import Mesh
        return cls(symbol, ctx if isinstance(ctx, Mesh) else device,
                   args=args, grad_req=grad_req, aux_states=aux,
                   data_names=data_names, group2ctx=group2ctx)

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
