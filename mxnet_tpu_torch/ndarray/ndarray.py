"""NDArray: the port of ``mxnet_tpu/ndarray/ndarray.py``.

An :class:`NDArray` is a handle to one torch tensor on one device, with
the reference's surface: arithmetic (in-place and reflected forms),
comparisons, ``__getitem__`` / ``__setitem__``, reductions, the shape
methods, ``copyto`` / ``as_in_context`` / ``detach`` / ``asscalar`` /
``wait_to_read``, and ``attach_grad`` / ``grad`` / ``backward``
(``autograd.py``).  :func:`invoke` runs a registered op on NDArrays, as
the generated ``nd.<op>`` functions do; while ``autograd.record()`` is
on, the op lands on torch's autograd tape, and outside it the op builds
no graph.

Writes follow the reference's handle semantics: an in-place operator or
``x[...] = v`` rebinds the handle to a new tensor, so a value the tape
saved is never overwritten (torch's version counter never trips).  The
exception is a *fixed* array — a ``Parameter``'s data and the gradient
buffers — whose tensor is registered on a module or bucketed by a
trainer: a write there copies into the tensor in place.  An op's output
that would be a view of a fixed array's storage is copied, so it keeps
its value across the next update, as the reference's values do.

:func:`array` creates on the CUDA device unless ``ctx`` (or
``context.use``) names the CPU, and raises without a card.  bfloat16
has no numpy dtype: such an array's ``dtype`` is the name
``"bfloat16"`` and ``asnumpy`` widens it to float32.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import autograd
from ..base import MXNetError, resolve_device
from ..context import Context, current_device
from ..ops import registry as _reg

__all__ = ["NDArray", "array", "empty", "concatenate", "invoke",
           "imperative_invoke", "torch_dtype", "np_dtype"]

_TO_NUMPY = {torch.float32: _np.float32, torch.float64: _np.float64,
             torch.float16: _np.float16, torch.int8: _np.int8,
             torch.uint8: _np.uint8, torch.int32: _np.int32,
             torch.int64: _np.int64, torch.bool: _np.bool_}


def np_dtype(dtype):
    """The numpy dtype of a numpy/torch dtype or its name; bfloat16 (which
    numpy lacks) is the name ``"bfloat16"``."""
    if dtype in (torch.bfloat16, "bfloat16"):
        return "bfloat16"
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


# eager monitor taps: fn(op_name, [NDArray outputs]) after every invoke
# (monitor.Monitor.install_eager)
_MONITOR_TAPS = []


def _device(ctx):
    return current_device() if ctx is None else resolve_device(ctx)


def _host(t):
    """A host numpy copy of tensor ``t`` (bfloat16 widened to float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy() if t.device.type == "cpu" \
        else t.cpu().numpy()


class NDArray:
    __slots__ = ("_data", "_fixed", "_grad_req", "__weakref__")

    def __init__(self, data, fixed=False):
        if not isinstance(data, torch.Tensor):
            raise TypeError("NDArray wraps a torch.Tensor, got %r"
                            % type(data))
        self._data = data
        self._fixed = fixed
        self._grad_req = "null"

    # -- basic properties --------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def stype(self):
        return "default"

    @property
    def context(self):
        """The array's :class:`~mxnet_tpu_torch.context.Context`
        (``._data.device`` is its ``torch.device``)."""
        return Context(self._data.device)

    ctx = context

    def __len__(self):
        return self._data.shape[0]

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape),
            self.context)

    # -- data access -------------------------------------------------------
    def asnumpy(self):
        """Blocking copy to the host."""
        return _host(self._data)

    def asscalar(self):
        if self.size != 1:
            raise ValueError("asscalar of an array of %d elements"
                             % self.size)
        return self.asnumpy().reshape(-1)[0].item()

    item = asscalar

    def wait_to_read(self):
        if self._data.device.type == "cuda":
            torch.cuda.current_stream(self._data.device).synchronize()

    def _set_data(self, new_data):
        """Write ``new_data`` into this handle: in place for a fixed array,
        else by rebinding (a variable stays one, with its buffer)."""
        if self._fixed:
            if new_data is not self._data:
                with torch.no_grad():
                    self._data.copy_(new_data)
            return
        if self._grad_req != "null":
            old = self._data
            new_data = new_data.detach().requires_grad_(True)
            new_data.grad = old.grad
        self._data = new_data

    def astype(self, dtype, copy=True):
        out = self._data.to(torch_dtype(dtype))
        if copy and out is self._data:
            out = out.clone()
        return NDArray(out)

    def copy(self):
        return NDArray(self._data.detach().clone())

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._set_data(self._data.detach().to(
                other._data.device, copy=True))
            return other
        return NDArray(self._data.detach().to(_device(other), copy=True))

    def as_in_context(self, ctx):
        dev = _device(ctx)
        if dev == self._data.device:
            return self
        return NDArray(self._data.to(dev))

    as_in_ctx = as_in_context

    def detach(self):
        t = self._data.detach()
        return NDArray(t.clone() if self._fixed else t)

    def tostype(self, stype):
        """This array in storage type ``stype`` (``"default"``,
        ``"row_sparse"`` or ``"csr"``; ``sparse.cast_storage``)."""
        if stype == self.stype:
            return self
        from . import sparse
        return sparse.cast_storage(self, stype)

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a variable with a zeroed gradient buffer; the
        buffer is dense whatever ``stype`` asks, as in the reference."""
        autograd._mark(self, grad_req)
        if grad_req != "null":
            self._data.grad = torch.zeros_like(self._data)

    @property
    def grad(self):
        if self._grad_req == "null" or self._data.grad is None:
            return None
        return NDArray(self._data.grad, fixed=True)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    # -- shape ops ---------------------------------------------------------
    def _r(self, name, *args, **kw):
        return invoke(_reg.get(name), (self,) + args, kw)

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape"):
            shape = tuple(kwargs["shape"])
        return self._r("Reshape", shape=shape,
                       reverse=kwargs.get("reverse", False))

    def reshape_like(self, other):
        return self._r("reshape_like", other)

    def expand_dims(self, axis):
        return self._r("expand_dims", axis=axis)

    def flatten(self):
        return self._r("Flatten")

    def squeeze(self, axis=None):
        return self._r("squeeze", axis=axis)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return self._r("transpose", axes=axes or None)

    @property
    def T(self):
        return self.transpose()

    def swapaxes(self, dim1, dim2):
        return self._r("swapaxes", dim1=dim1, dim2=dim2)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return self._r("SliceChannel", num_outputs=num_outputs, axis=axis,
                       squeeze_axis=squeeze_axis)

    def slice(self, begin, end, step=()):
        return self._r("slice", begin=begin, end=end, step=step)

    def slice_axis(self, axis, begin, end):
        return self._r("slice_axis", axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return self._r("take", indices, axis=axis, mode=mode)

    def one_hot(self, depth, **kw):
        return self._r("one_hot", depth=depth, **kw)

    def tile(self, reps):
        return self._r("tile", reps=reps)

    def broadcast_to(self, shape):
        return self._r("broadcast_to", shape=shape)

    def broadcast_like(self, other):
        return self._r("broadcast_like", other)

    def pad(self, mode, pad_width, constant_value=0.0):
        return self._r("Pad", mode=mode, pad_width=pad_width,
                       constant_value=constant_value)

    # -- reductions and math ------------------------------------------------
    def sum(self, axis=None, keepdims=False):
        return self._r("sum", axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._r("mean", axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._r("prod", axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return self._r("max", axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return self._r("min", axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return self._r("norm", ord=ord, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._r("argmax", axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._r("argmin", axis=axis, keepdims=keepdims)

    def clip(self, a_min, a_max):
        return self._r("clip", a_min=a_min, a_max=a_max)

    def abs(self):
        return self._r("abs")

    def sqrt(self):
        return self._r("sqrt")

    def square(self):
        return self._r("square")

    def exp(self):
        return self._r("exp")

    def log(self):
        return self._r("log")

    def sign(self):
        return self._r("sign")

    def round(self):
        return self._r("round")

    def sigmoid(self):
        return self._r("sigmoid")

    def relu(self):
        return self._r("relu")

    def tanh(self):
        return self._r("tanh")

    def dot(self, other, transpose_a=False, transpose_b=False):
        return self._r("dot", other, transpose_a=transpose_a,
                       transpose_b=transpose_b)

    # -- python operators --------------------------------------------------
    def _binop(self, name, sname, other):
        if isinstance(other, NDArray):
            return invoke(_reg.get(name), (self, other), {})
        return invoke(_reg.get(sname), (self,), {"scalar": float(other)})

    def _rop(self, name, sname, other):
        if isinstance(other, NDArray):
            return invoke(_reg.get(name), (other, self), {})
        return invoke(_reg.get(sname), (self,), {"scalar": float(other)})

    def __add__(self, o):
        return self._binop("broadcast_add", "_plus_scalar", o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop("broadcast_sub", "_minus_scalar", o)

    def __rsub__(self, o):
        return self._rop("broadcast_sub", "_rminus_scalar", o)

    def __mul__(self, o):
        return self._binop("broadcast_mul", "_mul_scalar", o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop("broadcast_div", "_div_scalar", o)

    def __rtruediv__(self, o):
        return self._rop("broadcast_div", "_rdiv_scalar", o)

    def __mod__(self, o):
        return self._binop("broadcast_mod", "_mod_scalar", o)

    def __rmod__(self, o):
        return self._rop("broadcast_mod", "_rmod_scalar", o)

    def __pow__(self, o):
        return self._binop("broadcast_power", "_power_scalar", o)

    def __rpow__(self, o):
        return self._rop("broadcast_power", "_rpower_scalar", o)

    def __neg__(self):
        return self._r("negative")

    def __abs__(self):
        return self._r("abs")

    def __eq__(self, o):
        if o is None:
            return False
        return self._binop("broadcast_equal", "_equal_scalar", o)

    def __ne__(self, o):
        if o is None:
            return True
        return self._binop("broadcast_not_equal", "_not_equal_scalar", o)

    def __gt__(self, o):
        return self._binop("broadcast_greater", "_greater_scalar", o)

    def __ge__(self, o):
        return self._binop("broadcast_greater_equal",
                           "_greater_equal_scalar", o)

    def __lt__(self, o):
        return self._binop("broadcast_lesser", "_lesser_scalar", o)

    def __le__(self, o):
        return self._binop("broadcast_lesser_equal", "_lesser_equal_scalar",
                           o)

    __hash__ = object.__hash__

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __iadd__(self, o):
        self._set_data((self + o)._data)
        return self

    def __isub__(self, o):
        self._set_data((self - o)._data)
        return self

    def __imul__(self, o):
        self._set_data((self * o)._data)
        return self

    def __itruediv__(self, o):
        self._set_data((self / o)._data)
        return self

    # -- indexing ----------------------------------------------------------
    def _key(self, key):
        if isinstance(key, NDArray):
            return key._data.to(device=self._data.device, dtype=torch.long)
        if isinstance(key, _np.ndarray):
            return torch.from_numpy(key.astype(_np.int64)).to(
                self._data.device)
        if isinstance(key, tuple):
            return tuple(self._key(k) for k in key)
        return key

    def __getitem__(self, key):
        with torch.set_grad_enabled(autograd.is_recording()):
            out = self._data[self._key(key)]
        return NDArray(out.clone() if self._fixed and out._is_view()
                       else out)

    def __setitem__(self, key, value):
        key = self._key(key)
        if isinstance(value, NDArray):
            value = value._data
        with torch.no_grad():
            value = torch.as_tensor(value, dtype=self._data.dtype,
                                    device=self._data.device)
            if self._fixed:
                self._data[key] = value
                return
            new = self._data.detach().clone()
            new[key] = value
        self._set_data(new)

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]


def _inputs(op, args, params):
    """The op's ordered tensor inputs; scalar positionals map onto its
    parameter names, as the reference's generated signatures do."""
    tensor_types = (NDArray, torch.Tensor, _np.ndarray)
    if op.arg_names == ["args"]:
        return list(args)
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
    return [a for a in inputs if a is not None]


def _tensor(a, device):
    """An op input as a tensor on ``device``; a numpy float64 input becomes
    float32, as the reference's ``jnp.asarray`` makes it."""
    if isinstance(a, NDArray):
        return a._data
    t = torch.as_tensor(a)
    if t.dtype == torch.float64 and not isinstance(a, torch.Tensor):
        t = t.float()
    return t.to(device)


def invoke(op, args, kwargs, out=None):
    """Run registered op ``op`` on NDArray (or numpy) inputs: recorded on
    torch's tape while ``autograd.record()`` is on, with ``_train`` from
    ``autograd.is_training()``.  Returns one NDArray or a list, or writes
    into ``out``."""
    params = _reg.canonicalize_kwargs(kwargs)
    params.pop("name", None)
    out = params.pop("out", out)
    inputs = _inputs(op, args, params)
    nds = [a for a in inputs if isinstance(a, NDArray)]
    if not inputs and "ctx" in op.fn_params:
        params["ctx"] = _device(params.get("ctx"))
    device = nds[0]._data.device if nds else current_device()
    raw = [_tensor(a, device) for a in inputs]
    if op.needs_train:
        params["_train"] = autograd.is_training()
    with torch.set_grad_enabled(autograd.is_recording()):
        outs = op.fn(*raw, **params)
    outs = outs if isinstance(outs, tuple) else (outs,)
    for in_idx, out_idx in op.mutates.items():
        if isinstance(inputs[in_idx], NDArray):
            inputs[in_idx]._set_data(outs[out_idx])
    fixed = any(a._fixed for a in nds)
    out_nds = [NDArray(o.clone() if fixed and o._is_view() else o)
               for o in outs[:op.n_outputs(params)]]
    for tap in _MONITOR_TAPS:
        tap(op.name, out_nds)
    if out is not None:
        dst = out if isinstance(out, (list, tuple)) else [out]
        for d, s in zip(dst, out_nds):
            d._set_data(s._data)
        return out
    return out_nds[0] if len(out_nds) == 1 else out_nds


def imperative_invoke(op_name, *args, **kwargs):
    """Invoke a registered op by name."""
    return invoke(_reg.get(op_name), args, kwargs)


def array(source_array, ctx=None, dtype=None):
    """An NDArray on ``ctx`` (the CUDA device by default).  ``dtype``
    defaults to the source's for an NDArray or a tensor and to float32
    otherwise, as in the reference."""
    dev = _device(ctx)
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if isinstance(source_array, torch.Tensor):
        data = source_array.detach()
        if dtype is not None:
            data = data.to(torch_dtype(dtype))
        return NDArray(data.to(dev, copy=True))
    bf16 = dtype is not None and torch_dtype(dtype) == torch.bfloat16
    host = _np.asarray(source_array).astype(
        _np.float32 if bf16 or dtype is None else np_dtype(dtype),
        order="C")
    t = torch.from_numpy(host)
    return NDArray((t.to(torch.bfloat16) if bf16 else t).to(dev))


def empty(shape, ctx=None, dtype=None):
    """A zero-filled array (the reference's ``empty`` fills zeros too)."""
    shape = shape if isinstance(shape, (list, tuple)) else (shape,)
    return NDArray(torch.zeros(tuple(shape),
                               dtype=torch_dtype(dtype or "float32"),
                               device=_device(ctx)))


def concatenate(arrays, axis=0, always_copy=True):
    return invoke(_reg.get("Concat"), tuple(arrays), {"dim": axis})
