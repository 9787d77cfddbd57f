"""Symbol: declarative graph composition, the port of
``mxnet_tpu/symbol/symbol.py``.

The graph is the reference's: a DAG of :class:`_Node` (``op is None`` for
a variable) whose entries are ``(node, output index)``, composed through
the op registry, named by :class:`NameManager`, serialized in the
reference's JSON schema (``nodes`` / ``arg_nodes`` / ``heads``), so a
graph written by either package loads in the other.

Where the reference infers shapes with ``jax.eval_shape`` per node, the
port runs each op on ``meta`` tensors (shapes and dtypes, no data), with
the same local rules for the parameter shapes an op derives from its data
input.  :func:`graph_plan` orders the nodes for the eager executor
(``executor.py``), which takes the gradients too (``Executor.backward``;
``Symbol.grad`` raises, as the reference's does).  The arithmetic and
comparison operators, the method sugar (``sym.reshape(...)``) and
composition by call build the reference's nodes.  The static-analysis
reports (``lint``, ``cost_report``, ``fusion_report``, ``shard_report``)
and ``group2ctx`` placement are not ported: they raise, naming their
ROADMAP.md item.
"""
from __future__ import annotations

import json

import numpy as _np
import torch

from ..ndarray.ndarray import torch_dtype
from ..ops import registry as _reg

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "NameManager", "AttrScope", "graph_plan"]


class NameManager:
    """Default names ``conv0``, ``conv1``, ... per op family (reference:
    python/mxnet/name.py NameManager)."""
    _current = None

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name is not None:
            return name
        hint = hint.lower().lstrip("_")
        i = self._counter.get(hint, 0)
        self._counter[hint] = i + 1
        return "%s%d" % (hint, i)


NameManager._current = NameManager()


class AttrScope:
    """Scoped symbol attributes (reference: python/mxnet/attribute.py)."""
    _current = None

    def __init__(self, **attrs):
        self._attrs = {k: str(v) for k, v in attrs.items()}
        self._old = None

    def get(self, user_attrs):
        out = dict(self._attrs)
        if user_attrs:
            out.update(user_attrs)
        return out

    def __enter__(self):
        self._old = AttrScope._current
        merged = dict(self._old._attrs) if self._old else {}
        merged.update(self._attrs)
        self._attrs = merged
        AttrScope._current = self
        return self

    def __exit__(self, *a):
        AttrScope._current = self._old


AttrScope._current = AttrScope()


class _Node:
    """One graph node.  ``op is None`` -> variable (nnvm "null" op)."""
    __slots__ = ("op", "name", "attrs", "inputs", "_is_aux")

    def __init__(self, op, name, attrs=None, inputs=(), is_aux=False):
        self.op = op
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        self.inputs = list(inputs)   # list of (node, out_index)
        self._is_aux = is_aux

    def __repr__(self):
        return "_Node(%s, %s)" % (self.op or "null", self.name)


def _topo(heads):
    """Post-order DFS over the nodes reachable from head entries."""
    seen = set()
    order = []
    stack = [e[0] for e in heads]
    path = []
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        path.append((node, False))
        while path:
            n, expanded = path.pop()
            if id(n) in seen:
                continue
            if expanded:
                seen.add(id(n))
                order.append(n)
            else:
                path.append((n, True))
                for (child, _) in reversed(n.inputs):
                    if id(child) not in seen:
                        path.append((child, False))
    return order


# parameter shapes an op derives from its data input's shape (the
# reference runs a bidirectional fixpoint; forward + these local rules
# cover every bind)
def _conv_param_shapes(attrs, dshape):
    kernel = attrs.get("kernel", ())
    num_filter = int(attrs.get("num_filter"))
    num_group = int(attrs.get("num_group", 1))
    if attrs.get("layout") in ("NWC", "NHWC", "NDHWC"):
        w = (num_filter,) + tuple(kernel) + (dshape[-1] // num_group,)
    else:
        w = (num_filter, dshape[1] // num_group) + tuple(kernel)
    shapes = {"weight": w}
    if not attrs.get("no_bias", False):
        shapes["bias"] = (num_filter,)
    return shapes


def _fc_param_shapes(attrs, dshape):
    num_hidden = int(attrs.get("num_hidden"))
    in_dim = 1
    if attrs.get("flatten", True):
        for d in dshape[1:]:
            in_dim *= d
    else:
        in_dim = dshape[-1]
    shapes = {"weight": (num_hidden, in_dim)}
    if not attrs.get("no_bias", False):
        shapes["bias"] = (num_hidden,)
    return shapes


def _bn_param_shapes(attrs, dshape):
    c = dshape[int(attrs.get("axis", 1))]
    return {"gamma": (c,), "beta": (c,), "moving_mean": (c,),
            "moving_var": (c,)}


def _softmax_label_shape(attrs, dshape):
    if _reg.canonicalize(attrs.get("multi_output", False)):
        return (dshape[0],) + tuple(dshape[2:])
    return tuple(dshape[:-1])


def _rnn_param_shapes(attrs, dshape):
    """The flat parameter vector and both states of the ``RNN`` op for
    data of shape (seq_len, batch, input_size)."""
    from ..ops import rnn as _rnn_ops
    state = _rnn_ops.rnn_state_shape(attrs, dshape)
    return {"parameters": (_rnn_ops.rnn_param_size(
        int(attrs["state_size"]), dshape[2], int(attrs.get("num_layers", 1)),
        attrs.get("mode", "lstm"), attrs.get("bidirectional", False)),),
        "state": state, "state_cell": state}


_LABEL_SHAPE_RULES = {"SoftmaxOutput": _softmax_label_shape}
_PARAM_SHAPE_RULES = {
    "Convolution": _conv_param_shapes,
    "FullyConnected": _fc_param_shapes,
    "BatchNorm": _bn_param_shapes,
    "RNN": _rnn_param_shapes,
}

# attrs consumed by the executor (placement / learning-rate metadata),
# never forwarded to op functions
_EXECUTOR_ATTRS = frozenset({
    "ctx_group", "lr_mult", "wd_mult", "force_mirroring", "mirror_stage",
})


def _attr_params(op, attrs):
    params = {k: _reg.canonicalize(v) for k, v in attrs.items()
              if not k.startswith("__") and k not in _EXECUTOR_ATTRS}
    if op is not None and op.needs_train:
        params["_train"] = False
    return params


def _not_ported(what, item):
    raise NotImplementedError("%s is not ported yet: ROADMAP.md queue A, "
                              "item %s" % (what, item))


class Symbol:
    """Immutable handle to a list of output entries of a graph."""
    __slots__ = ("_outputs",)

    def __init__(self, outputs):
        self._outputs = list(outputs)

    # -- introspection -----------------------------------------------------
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def _nodes(self):
        return _topo(self._outputs)

    def list_arguments(self):
        return [n.name for n in self._nodes()
                if n.op is None and not n._is_aux]

    def list_auxiliary_states(self):
        return [n.name for n in self._nodes() if n.op is None and n._is_aux]

    def list_outputs(self):
        out = []
        for node, idx in self._outputs:
            if node.op is None:
                out.append(node.name)
                continue
            op = _reg.get(node.op)
            n = op.n_outputs(_attr_params(op, node.attrs))
            out.append("%s_output" % node.name if n == 1
                       else "%s_output%d" % (node.name, idx))
        return out

    def get_internals(self):
        entries = []
        for n in self._nodes():
            if n.op is None:
                entries.append((n, 0))
            else:
                op = _reg.get(n.op)
                for i in range(op.n_outputs(_attr_params(op, n.attrs))):
                    entries.append((n, i))
        return Symbol(entries)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            matches = [i for i, n in enumerate(names)
                       if n == index or n.rsplit("_output", 1)[0] == index]
            if len(matches) != 1:
                raise ValueError("cannot resolve output %r (candidates %r)"
                                 % (index, names))
            index = matches[0]
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def attr_dict(self):
        out = {}
        for n in self._nodes():
            if n.attrs:
                out[n.name] = {k: str(v) for k, v in n.attrs.items()
                               if not k.startswith("__param")}
        return out

    def __repr__(self):
        name = self.name
        return "<Symbol %s>" % (name if name else
                                ", ".join(self.list_outputs()))

    def list_inputs(self):
        return [n.name for n in self._nodes() if n.op is None]

    def get_children(self):
        kids = []
        for node, _ in self._outputs:
            kids.extend(node.inputs)
        return Symbol(kids) if kids else None

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        return (Symbol([e]) for e in self._outputs)

    def attr(self, key):
        if len(self._outputs) == 1:
            return self._outputs[0][0].attrs.get(key)
        return None

    def _set_attr(self, **kwargs):
        for node, _ in self._outputs:
            node.attrs.update({k: str(v) for k, v in kwargs.items()})

    # -- composition -------------------------------------------------------
    def __call__(self, *args, **kwargs):
        """Compose: a copy of this graph with the named free variables
        replaced by other symbols (reference: Symbol.__call__)."""
        if args:
            raise TypeError("composition supports keyword arguments only")
        mapping = {}
        for name, s in kwargs.items():
            if not isinstance(s, Symbol):
                raise TypeError("can only compose with Symbols")
            mapping[name] = s._outputs[0]
        memo = {}

        def clone(node):
            if id(node) in memo:
                return memo[id(node)]
            if node.op is None and node.name in mapping:
                sub = mapping[node.name][0]
                memo[id(node)] = sub
                return sub
            new = _Node(node.op, node.name, node.attrs,
                        [(clone(c), i) for c, i in node.inputs], node._is_aux)
            memo[id(node)] = new
            return new

        return Symbol([(clone(n), i) for n, i in self._outputs])

    # -- arithmetic sugar: the reference's ops, by name ---------------------
    def __add__(self, o):
        return _binary(self, o, "_plus", "_plus_scalar")

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        return _binary(self, o, "_minus", "_minus_scalar")

    def __rsub__(self, o):
        return _binary(self, o, None, "_rminus_scalar")

    def __mul__(self, o):
        return _binary(self, o, "_mul", "_mul_scalar")

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        return _binary(self, o, "_div", "_div_scalar")

    def __rtruediv__(self, o):
        return _binary(self, o, None, "_rdiv_scalar")

    def __pow__(self, o):
        return _binary(self, o, "_power", "_power_scalar")

    def __neg__(self):
        return _create("_neg", [self], {}, None)

    def __eq__(self, o):
        if isinstance(o, (Symbol, int, float)):
            return _binary(self, o, "_equal", "_equal_scalar")
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (Symbol, int, float)):
            return _binary(self, o, "_not_equal", "_not_equal_scalar")
        return NotImplemented

    def __gt__(self, o):
        return _binary(self, o, "_greater", "_greater_scalar")

    def __ge__(self, o):
        return _binary(self, o, "_greater_equal", "_greater_equal_scalar")

    def __lt__(self, o):
        return _binary(self, o, "_lesser", "_lesser_scalar")

    def __le__(self, o):
        return _binary(self, o, "_lesser_equal", "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def __getattr__(self, name):
        # method-style op calls (sym.reshape(...), sym.sum(...)), resolved
        # from the registry as the reference's generated methods are
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            op = _reg.get(name)
        except KeyError:
            raise AttributeError("Symbol has no attribute %r" % name) \
                from None

        def method(*args, **kwargs):
            return _sym_invoke(op, name, (self,) + args, kwargs)
        return method

    # -- shape / type inference -------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from the input shapes
        (by name, or positionally in ``list_arguments`` order), or three
        Nones when some shape stays unknown."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """As :meth:`infer_shape`, with None for each shape left
        unknown."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        if args:
            kwargs = dict(zip(self.list_arguments(), args), **kwargs)
        known = {k: tuple(v) for k, v in kwargs.items() if v is not None}
        shapes, ok = _infer_entry_shapes(self._outputs, known, {})
        if not ok and not partial:
            return None, None, None

        def shape(key):
            s = shapes.get(key)
            return None if s is None else tuple(s.shape)

        arg_shapes, aux_shapes = [], []
        for n in self._nodes():
            if n.op is None:
                (aux_shapes if n._is_aux else arg_shapes).append(
                    shape((id(n), 0)))
        out_shapes = [shape((id(n), i)) for n, i in self._outputs]
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, **kwargs):
        """Dtype propagation by numpy ``result_type`` promotion per node
        (the reference's rule)."""
        dtypes = {k: _np.dtype(v) for k, v in kwargs.items() if v is not None}
        env = {}
        for n in self._nodes():
            if n.op is None:
                dt = dtypes.get(n.name)
                if dt is None and "__dtype__" in n.attrs:
                    dt = _np.dtype(n.attrs["__dtype__"])
                env[id(n)] = dt if dt is not None else _np.dtype(_np.float32)
                continue
            if n.op in ("Cast", "cast"):
                env[id(n)] = _np.dtype(_reg.canonicalize(
                    n.attrs.get("dtype", "float32")))
                continue
            ins = [env.get(id(c)) for c, _ in n.inputs]
            ins = [d for d in ins if d is not None]
            env[id(n)] = _np.dtype(_np.result_type(*ins)) if ins else \
                _np.dtype(_np.float32)
        args_t, aux_t = [], []
        for n in self._nodes():
            if n.op is None:
                (aux_t if n._is_aux else args_t).append(env.get(id(n)))
        outs_t = [env.get(id(e[0])) for e in self._outputs]
        return args_t, outs_t, aux_t

    # -- serialization (the reference's JSON schema) -----------------------
    def tojson(self):
        nodes = self._nodes()
        index = {id(n): i for i, n in enumerate(nodes)}
        jnodes, arg_nodes = [], []
        for i, n in enumerate(nodes):
            if n.op is None:
                arg_nodes.append(i)
            jnodes.append({
                "op": n.op if n.op else "null",
                "name": n.name,
                "attrs": {k: str(v) for k, v in n.attrs.items()},
                "inputs": [[index[id(c)], oi, 0] for c, oi in n.inputs],
            })
        heads = [[index[id(n)], oi, 0] for n, oi in self._outputs]
        return json.dumps({
            "nodes": jnodes, "arg_nodes": arg_nodes, "heads": heads,
            "attrs": {"mxnet_version": ["int", 10300],
                      "framework": ["str", "mxnet_tpu"]},
        }, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- evaluation / binding ----------------------------------------------
    def eval(self, ctx=None, **kwargs):
        return self.bind(ctx, kwargs).forward()

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from ..executor import Executor
        return Executor(self, ctx, args=args, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux_states,
                        group2ctx=group2ctx)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    shared_arg_names=None, shared_exec=None,
                    shared_buffer=None, lint=False, **kwargs):
        """Allocate the arrays from the inferred shapes and bind
        (reference: symbol.py:1289)."""
        from ..executor import Executor
        return Executor.simple_bind(self, ctx, grad_req=grad_req,
                                    type_dict=type_dict, shapes=kwargs,
                                    lint=lint)

    def grad(self, wrt):
        raise NotImplementedError(
            "symbolic grad graphs are implicit: bind() records the graph "
            "and Executor.backward takes its vjp")

    def lint(self, *args, **kwargs):
        _not_ported("Symbol.lint (mxlint)", 13)

    def cost_report(self, *args, **kwargs):
        _not_ported("Symbol.cost_report (mxcost)", 13)

    def fusion_report(self, *args, **kwargs):
        _not_ported("Symbol.fusion_report (mxfuse)", 13)

    def shard_report(self, *args, **kwargs):
        _not_ported("Symbol.shard_report (mxshard)", 13)


# ---------------------------------------------------------------------------
# shape propagation: each op on meta tensors
# ---------------------------------------------------------------------------
def _meta(shape, dtype=torch.float32):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _infer_entry_shapes(heads, known_shapes, known_dtypes):
    """Forward shape/dtype propagation.  Returns ({(node_id, out_idx):
    meta tensor}, fully_known)."""
    shapes = {}
    ok = True
    order = _topo(heads)
    for n in order:
        if n.op is None:
            shp = known_shapes.get(n.name)
            if shp is None and "__shape__" in n.attrs:
                shp = tuple(_reg.canonicalize(n.attrs["__shape__"]))
            if shp is None:
                continue
            shapes[(id(n), 0)] = _meta(
                shp, torch_dtype(known_dtypes.get(n.name, "float32")))
            continue
        op = _reg.get(n.op)
        params = _attr_params(op, n.attrs)
        rule = _PARAM_SHAPE_RULES.get(n.op)
        if rule is not None:
            d0 = shapes.get((id(n.inputs[0][0]), n.inputs[0][1]))
            if d0 is not None:
                try:
                    derived = rule(params, tuple(d0.shape))
                except (KeyError, TypeError, IndexError):
                    derived = {}
                for (child, _) in n.inputs[1:]:
                    if child.op is None and (id(child), 0) not in shapes:
                        suffix = child.name.rsplit("_", 1)[-1]
                        # match by arg suffix: conv0_weight -> weight
                        for pname, pshape in derived.items():
                            if suffix == pname or child.name.endswith(pname):
                                if pshape is not None:
                                    shapes[(id(child), 0)] = _meta(pshape)
                                break
        lrule = _LABEL_SHAPE_RULES.get(n.op)
        if lrule is not None and len(n.inputs) > 1:
            d0 = shapes.get((id(n.inputs[0][0]), n.inputs[0][1]))
            lab = n.inputs[1][0]
            if d0 is not None and lab.op is None \
                    and (id(lab), 0) not in shapes:
                shapes[(id(lab), 0)] = _meta(lrule(n.attrs, tuple(d0.shape)))
        ins = [shapes.get((id(c), oi)) for c, oi in n.inputs]
        if any(s is None for s in ins):
            ok = False
            continue
        if not ins and "ctx" in op.fn_params:
            params = dict(params, ctx=torch.device("meta"))
        try:
            with torch.no_grad():
                out = op.fn(*ins, **params)
        except Exception:  # an op that cannot take these shapes
            ok = False
            continue
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for i, o in enumerate(outs):
            shapes[(id(n), i)] = o
    for n in order:
        if n.op is None and (id(n), 0) not in shapes:
            ok = False
    return shapes, ok


# ---------------------------------------------------------------------------
# the executor's plan
# ---------------------------------------------------------------------------
def graph_plan(symbol):
    """The eager executor's program: ``(steps, heads)`` where each step is
    ``(node, op, params, input keys, keys to release after it)`` in
    topological order, params canonicalized once, and every entry
    released after its last consumer unless it is a head."""
    order = symbol._nodes()
    heads = [(id(n), oi) for n, oi in symbol._outputs]
    last = {}
    for i, n in enumerate(order):
        for c, oi in n.inputs:
            last[(id(c), oi)] = i
    keep = set(heads)
    release = {}
    for key, i in last.items():
        if key not in keep:
            release.setdefault(i, []).append(key)
    steps = []
    for i, n in enumerate(order):
        if n.op is None:
            steps.append((n, None, None, (), release.get(i, ())))
            continue
        op = _reg.get(n.op)
        params = {k: _reg.canonicalize(v) for k, v in n.attrs.items()
                  if not k.startswith("__") and k not in _EXECUTOR_ATTRS}
        steps.append((n, op, params,
                      tuple((id(c), oi) for c, oi in n.inputs),
                      release.get(i, ())))
    return steps, heads


# ---------------------------------------------------------------------------
# symbol-side op invocation (the generated sym.* functions)
# ---------------------------------------------------------------------------
def _sym_invoke(op, op_name, args, kwargs):
    name = kwargs.pop("name", None)
    attr = kwargs.pop("attr", None)
    name = NameManager._current.get(name, op_name)

    if op.arg_names == ["args"]:
        return _sym_invoke_variadic(op, op_name, name, attr, args, kwargs)
    params = {}
    names = list(op.arg_names) + [op.aux[i] for i in sorted(op.aux)]
    slots = {}
    for i, a in enumerate(args):
        if isinstance(a, Symbol):
            slots[names[i]] = a
        elif isinstance(a, str):
            raise TypeError("%s expects Symbol for argument %r, got str %r"
                            % (op_name, names[i], a))
        else:
            params[names[i]] = a
    for k, v in kwargs.items():
        if isinstance(v, Symbol):
            slots[k] = v
        else:
            params[k] = v
    aux_names = set(op.aux.values())
    entries = []
    no_bias = _reg.canonicalize(params.get("no_bias", False))
    optional = op.optional(_reg.canonicalize_kwargs(params))
    scope_attrs = AttrScope._current.get({})
    for an in names:
        if an in slots:
            entries.append(slots[an]._outputs[0])
            continue
        if an in optional or (an == "bias" and no_bias):
            continue
        # auto-created parameter / label / aux variable <name>_<argname>
        vnode = _Node(None, "%s_%s" % (name, an), dict(scope_attrs),
                      is_aux=an in aux_names and an != names[0])
        entries.append((vnode, 0))

    attrs = AttrScope._current.get(attr or {})
    for k, v in params.items():
        if v is not None:
            attrs[k] = v
    node = _Node(op_name, name, attrs, entries)
    n_out = op.n_outputs(_attr_params(op, attrs))
    return Symbol([(node, i) for i in range(n_out)])


def _sym_invoke_variadic(op, op_name, name, attr, args, kwargs):
    """A node of an op over any number of inputs (``Concat``, ``stack``,
    ``add_n``): every Symbol given, in order, lists flattened."""
    flat = []
    for a in args:
        flat.extend(a if isinstance(a, (list, tuple)) else [a])
    for a in flat:
        if not isinstance(a, Symbol):
            raise TypeError("%s expects Symbols, got %r" % (op_name, type(a)))
    params = {}
    for k, v in kwargs.items():
        if isinstance(v, Symbol):
            flat.append(v)
        else:
            params[k] = v
    attrs = AttrScope._current.get(attr or {})
    for k, v in params.items():
        if v is not None:
            attrs[k] = v
    node = _Node(op_name, name, attrs, [a._outputs[0] for a in flat])
    n_out = op.n_outputs(_attr_params(op, attrs))
    return Symbol([(node, i) for i in range(n_out)])


def _binary(lhs, rhs, op_name, scalar_op_name):
    if isinstance(rhs, Symbol):
        if op_name is None:
            raise TypeError("unsupported operand order")
        return _create(op_name, [lhs, rhs], {}, None)
    return _create(scalar_op_name, [lhs], {"scalar": float(rhs)}, None)


def _create(op_name, sym_args, params, name):
    kwargs = dict(params)
    if name is not None:
        kwargs["name"] = name
    return _sym_invoke(_reg.get(op_name), op_name, tuple(sym_args), kwargs)


# ---------------------------------------------------------------------------
# public constructors
# ---------------------------------------------------------------------------
def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    if not isinstance(name, str):
        raise TypeError("Variable name must be a string")
    attrs = AttrScope._current.get(attr or {})
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        attrs["__dtype__"] = _np.dtype(dtype).name
    if lr_mult is not None:
        attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attrs["__wd_mult__"] = str(wd_mult)
    if init is not None:
        attrs["__init__"] = init.dumps() if hasattr(init, "dumps") \
            else str(init)
    attrs.update({k: str(v) for k, v in kwargs.items()})
    return Symbol([(_Node(None, name, attrs), 0)])


var = Variable


def Group(symbols):
    entries = []
    for s in symbols:
        if not isinstance(s, Symbol):
            raise TypeError("Group expects Symbols")
        entries.extend(s._outputs)
    return Symbol(entries)


def load_json(json_str):
    """A Symbol from the reference's JSON schema (either package's
    ``tojson``)."""
    g = json.loads(json_str)
    nodes = []
    aux_names = set()
    for jn in g["nodes"]:
        if jn["op"] != "null":
            op = _reg.get(jn["op"])
            for pos, _ in op.aux.items():
                if pos < len(jn["inputs"]):
                    aux_names.add(jn["inputs"][pos][0])
    for i, jn in enumerate(g["nodes"]):
        attrs = jn.get("attrs") or jn.get("param") or {}
        node = _Node(None if jn["op"] == "null" else jn["op"],
                     jn["name"], attrs,
                     [(nodes[ci], oi) for ci, oi, _ in jn["inputs"]],
                     is_aux=i in aux_names)
        nodes.append(node)
    return Symbol([(nodes[ni], oi) for ni, oi, _ in g["heads"]])


def load(fname):
    """A Symbol from a JSON file written by either package's ``save``."""
    with open(fname) as f:
        return load_json(f.read())
