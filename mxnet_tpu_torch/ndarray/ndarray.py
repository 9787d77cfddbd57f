"""NDArray: the port of ``mxnet_tpu/ndarray/ndarray.py``.

An :class:`NDArray` is a handle to one torch tensor on one device.  It
carries the surface the symbolic path uses: ``shape``, ``dtype`` (a numpy
dtype, as in the reference), ``context`` (a ``torch.device``),
``asnumpy``, ``astype``, ``copy`` and ``as_in_context``.
:func:`invoke` runs a registered op on NDArrays, as the generated
``nd.<op>`` functions do.  There is no autograd here: recording and
``backward`` are ROADMAP.md queue A, item 1 (``autograd.py``).

:func:`array` creates on the CUDA device unless ``ctx`` (or
``context.use``) names the CPU, and raises without a card.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, resolve_device
from ..context import current_context
from ..ops import registry as _reg

__all__ = ["NDArray", "array", "invoke", "torch_dtype", "np_dtype"]

_TO_NUMPY = {torch.float32: _np.float32, torch.float64: _np.float64,
             torch.float16: _np.float16, torch.int8: _np.int8,
             torch.uint8: _np.uint8, torch.int32: _np.int32,
             torch.int64: _np.int64, torch.bool: _np.bool_}


def np_dtype(dtype):
    """The numpy dtype of a numpy/torch dtype or its name."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _TO_NUMPY:
            raise MXNetError("no numpy dtype for %s" % dtype)
        return _np.dtype(_TO_NUMPY[dtype])
    return _np.dtype(dtype)


def torch_dtype(dtype):
    """The torch dtype of a numpy/torch dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    return torch.from_numpy(_np.zeros(0, dtype=_np.dtype(dtype))).dtype


def _device(ctx):
    return current_context() if ctx is None else resolve_device(ctx)


class NDArray:
    __slots__ = ("_data", "__weakref__")

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise TypeError("NDArray wraps a torch.Tensor, got %r"
                            % type(data))
        self._data = data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def context(self):
        return self._data.device

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape),
            self.context)

    def asnumpy(self):
        """Blocking copy to the host."""
        return self._data.detach().cpu().numpy()

    def _set_data(self, new_data):
        """Rebind the handle to a new tensor (in-place mutation analogue)."""
        self._data = new_data

    def astype(self, dtype, copy=True):
        out = self._data.to(torch_dtype(dtype))
        return NDArray(out.clone() if copy and out is self._data else out)

    def copy(self):
        return NDArray(self._data.clone())

    def as_in_context(self, ctx):
        return NDArray(self._data.to(_device(ctx)))


def invoke(op, args, kwargs):
    """Run registered op ``op`` on NDArray (or numpy) inputs; scalar
    positionals map onto the op's parameter names, as the reference's
    generated signatures do.  Returns one NDArray or a list."""
    params = _reg.canonicalize_kwargs(kwargs)
    params.pop("name", None)
    tensor_types = (NDArray, torch.Tensor, _np.ndarray)
    inputs = []
    for i, a in enumerate(args):
        if isinstance(a, tensor_types) or a is None:
            inputs.append(a)
        elif i < len(op.fn_params):
            params.setdefault(op.fn_params[i], a)
        else:
            inputs.append(a)
    names = list(op.arg_names) + [op.aux[i] for i in sorted(op.aux)]
    for name in names[len(inputs):]:
        if isinstance(params.get(name), tensor_types):
            inputs.append(params.pop(name))
        elif name in params and params[name] is None:
            params.pop(name)
    device = next((a._data.device for a in inputs if isinstance(a, NDArray)),
                  None)
    raw = []
    for a in inputs:
        if a is None:
            continue
        if isinstance(a, NDArray):
            raw.append(a._data)
        else:
            t = torch.as_tensor(a)
            raw.append(t.to(device) if device is not None else t)
    if op.needs_train:
        params["_train"] = False
    outs = op.fn(*raw, **params)
    outs = outs if isinstance(outs, tuple) else (outs,)
    out_nds = [NDArray(o) for o in outs[:op.n_outputs(params)]]
    return out_nds[0] if len(out_nds) == 1 else out_nds


def array(source_array, ctx=None, dtype=None):
    """An NDArray on ``ctx`` (the CUDA device by default).  ``dtype``
    defaults to the source's for an NDArray and to float32 otherwise, as
    in the reference."""
    dev = _device(ctx)
    if isinstance(source_array, NDArray):
        data = source_array._data
        if dtype is not None:
            data = data.to(torch_dtype(dtype))
        return NDArray(data.to(dev, copy=True))
    if isinstance(source_array, torch.Tensor):
        data = source_array.to(torch_dtype(dtype or "float32"))
        return NDArray(data.to(dev, copy=True))
    host = _np.asarray(source_array).astype(
        np_dtype(dtype) if dtype is not None else _np.float32)
    return NDArray(torch.from_numpy(_np.ascontiguousarray(host)).to(dev))
