"""``sym`` — symbolic graph composition, the port of
``mxnet_tpu/symbol/__init__.py``.  The op functions are generated from
the same registry as ``nd``; ``sym.contrib.<op>`` holds the
``_contrib_*`` ops without their prefix."""
from __future__ import annotations

import sys as _sys
import types as _types

from ..ops import registry as _reg
from .symbol import (Symbol, Variable, var, Group, load_json, AttrScope,
                     NameManager, _sym_invoke)

__all__ = ["Symbol", "Variable", "var", "Group", "load_json", "AttrScope",
           "NameManager", "contrib"]

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
_this = _sys.modules[__name__]
for _name in _reg.list_ops():
    if _name.startswith("_contrib_"):
        setattr(contrib, _name[len("_contrib_"):],
                _make_sym_func(_reg.get(_name), _name))
    elif not _name.startswith("_") and not hasattr(_this, _name):
        setattr(_this, _name, _make_sym_func(_reg.get(_name), _name))
