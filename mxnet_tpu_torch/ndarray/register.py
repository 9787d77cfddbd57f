"""Generates the ``nd.*`` function namespace from the op registry: the
port of ``mxnet_tpu/ndarray/register.py``."""
from __future__ import annotations

from ..ops import registry as _reg
from .ndarray import NDArray, _device, invoke


def _make_op_func(op, name):
    takes_ctx = "ctx" in op.fn_params

    def fn(*args, **kwargs):
        ctx = None if takes_ctx else kwargs.pop("ctx", None)
        out = invoke(op, args, kwargs)
        if ctx is not None and isinstance(out, NDArray):
            out = NDArray(out._data.to(_device(ctx)))
        return out

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__doc__ = op.doc or ("%s operator." % name)
    return fn


def populate(target_module, contrib_module):
    """One function per registered op: public names on ``target_module``,
    ``_contrib_*`` ones on ``contrib_module`` without the prefix."""
    for name in _reg.list_ops():
        if name.startswith("_contrib_"):
            setattr(contrib_module, name[len("_contrib_"):],
                    _make_op_func(_reg.get(name), name))
        elif not name.startswith("_") and not hasattr(target_module, name):
            setattr(target_module, name, _make_op_func(_reg.get(name), name))
