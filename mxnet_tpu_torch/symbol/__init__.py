"""``sym`` — symbolic graph composition, the port of
``mxnet_tpu/symbol/__init__.py``.  The op functions are generated from
the same registry as ``nd``; ``sym.contrib.<op>`` holds the
``_contrib_*`` ops without their prefix, and ``sym.random.<name>`` the
``_random_*`` ops without theirs (``mxnet_tpu/symbol/__init__.py:31-53``);
``zeros`` is the reference's creation helper (``:56-57``), the recurrent
cells' begin states."""
from __future__ import annotations

import sys as _sys
import types as _types

from ..ops import registry as _reg
from .symbol import (Symbol, Variable, var, Group, load, load_json,
                     AttrScope, NameManager, _sym_invoke)

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "AttrScope", "NameManager", "contrib", "random", "zeros"]

_reg.load_all()


def _make_sym_func(op, name):
    def fn(*args, **kwargs):
        return _sym_invoke(op, name, args, kwargs)
    fn.__name__ = name
    fn.__qualname__ = name
    fn.__doc__ = op.doc or ("%s symbol." % name)
    return fn


contrib = _types.ModuleType(__name__ + ".contrib")
_sys.modules[contrib.__name__] = contrib
random = _types.ModuleType(__name__ + ".random")
_sys.modules[random.__name__] = random
_this = _sys.modules[__name__]
for _name in _reg.list_ops():
    if _name.startswith("_contrib_"):
        setattr(contrib, _name[len("_contrib_"):],
                _make_sym_func(_reg.get(_name), _name))
    elif _name.startswith("_random_"):
        setattr(random, _name[len("_random_"):],
                _make_sym_func(_reg.get(_name), _name))
    elif not _name.startswith("_") and not hasattr(_this, _name):
        setattr(_this, _name, _make_sym_func(_reg.get(_name), _name))


def zeros(shape, dtype=None, **kwargs):
    """A ``_zeros`` node (a 0 in ``shape``: a batch dimension that a
    recurrent cell's unroll anchors to its input)."""
    return _sym_invoke(_reg.get("_zeros"), "_zeros", (),
                       dict(kwargs, shape=shape, dtype=dtype or "float32"))

