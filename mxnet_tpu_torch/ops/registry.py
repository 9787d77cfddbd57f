"""Operator registry: the port of ``mxnet_tpu/ops/registry.py``.

An op is a plain torch function ``fn(*tensors, **params) -> tensor | tuple``
registered under the reference's operator name, with the metadata the
symbolic front end reads (the nnvm op attributes of the reference):

- ``arg_names``: ordered tensor-input names (``list_arguments``, binding);
- ``aux``: input index -> auxiliary-state name (BatchNorm moving stats);
- ``num_outputs``: int or ``callable(params) -> int``;
- ``optional_args``: tensor slots the symbolic front end does not
  auto-create when absent (a tuple, or ``callable(params) -> names``);
- ``needs_train``: the op takes a ``_train`` flag;
- ``mutates``: input index -> output index written back into that input
  by ``nd`` (the optimizer updates' state, the reference's
  ``FMutateInputs``).

Attributes stored as strings (``"(1, 1)"``, ``"True"``, as a graph loaded
from JSON carries them) are read back by :func:`canonicalize`.  The
reference's gradient and registry-lint metadata are left out: an op's
gradient is torch's autograd of its function (or the ``autograd.Function``
it defines), in the imperative path and in ``Executor.backward`` alike.
"""
from __future__ import annotations

import ast
import inspect

__all__ = ["Op", "register", "get", "list_ops", "canonicalize",
           "canonicalize_kwargs", "load_all", "namespace"]

_OPS = {}


class Op:
    __slots__ = ("name", "fn", "arg_names", "aux", "num_outputs",
                 "needs_train", "optional_args", "fn_params", "doc",
                 "mutates")

    def __init__(self, name, fn, arg_names=None, aux=None, num_outputs=1,
                 needs_train=False, optional_args=(), doc=None,
                 mutates=None):
        self.name = name
        self.fn = fn
        self.arg_names = list(arg_names) if arg_names is not None \
            else ["data"]
        self.mutates = dict(mutates) if mutates else {}
        self.aux = dict(aux) if aux else {}
        self.num_outputs = num_outputs
        self.needs_train = needs_train
        self.optional_args = optional_args
        # positional parameter names of fn, so scalar positional call args
        # (nd.Reshape(x, (2, -1))) map onto the right keyword
        self.fn_params = [
            p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_OR_KEYWORD, p.POSITIONAL_ONLY)]
        self.doc = doc or fn.__doc__ or ""

    def optional(self, params):
        if callable(self.optional_args):
            return set(self.optional_args(params))
        return set(self.optional_args)

    def n_outputs(self, params):
        if callable(self.num_outputs):
            return self.num_outputs(params)
        return self.num_outputs

    def __repr__(self):
        return "Op(%s)" % self.name


def register(name, *, arg_names=None, aux=None, num_outputs=1, aliases=(),
             needs_train=False, optional_args=(), doc=None, mutates=None):
    """Decorator registering a torch function as operator ``name``."""

    def deco(fn):
        op = Op(name, fn, arg_names, aux, num_outputs, needs_train,
                optional_args, doc, mutates)
        for n in (name,) + tuple(aliases):
            _OPS[n] = op
        return fn

    return deco


def get(name):
    try:
        return _OPS[name]
    except KeyError:
        raise KeyError("operator %r is not registered in the port (have %d "
                       "ops; the rest of the op set is ROADMAP.md queue A, "
                       "items 10 (contrib, linalg, control flow and "
                       "image ops) and 8 (flash_attention))"
                       % (name, len(_OPS))) from None


def list_ops():
    return sorted(_OPS)


_BOOL = {"true": True, "false": False, "True": True, "False": False}


def canonicalize(value):
    """A string attribute as the value it spells (``"(2, 2)"`` -> tuple,
    ``"True"`` -> True, ``"0.5"`` -> float); other strings and non-strings
    pass through."""
    if isinstance(value, str):
        if value in _BOOL:
            return _BOOL[value]
        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return value
    return value


def canonicalize_kwargs(kwargs):
    return {k: canonicalize(v) for k, v in kwargs.items()}


# the modules whose imports fill the table
_OP_MODULES = ("nn", "elemwise", "reduce", "matrix", "indexing", "init",
               "random", "optimizer_ops", "quantization", "pallas_kernels",
               "rnn", "contrib", "sparse_ops")


def load_all():
    """Import every op module of the port (each registers its ops on
    import); the ``nd`` and ``sym`` namespaces are generated after it."""
    import importlib
    for m in _OP_MODULES:
        importlib.import_module("." + m, __package__)


_NAMESPACE = []


def namespace():
    """Every registered op's torch function as an attribute, under each of
    its names: the ``F`` a port ``HybridBlock`` receives in
    ``hybrid_forward``, as a reference block receives ``nd``."""
    if not _NAMESPACE:
        import types
        load_all()
        ns = types.SimpleNamespace(**{n: op.fn for n, op in _OPS.items()})
        _NAMESPACE.append(ns)
    return _NAMESPACE[0]
