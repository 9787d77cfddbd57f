"""Indexing operators: the port of ``mxnet_tpu/ops/indexing.py`` and of
the reference's ``_getitem`` (``mxnet_tpu/ndarray/ndarray.py:430``).
``sparse_retain`` here is the dense form (the other rows zeroed); the
row-sparse one is ``_sparse_retain`` (``ops/sparse_ops.py``).  Indices
are read as integers (float indices are truncated, as the reference's
``astype(int32)`` does); ``clip`` mode clamps them into range, ``wrap``
takes them modulo the axis.  Where ``scatter_nd`` / ``_scatter_set_nd``
meet one index twice, MXNet leaves the result undefined: one of the
values written there lands."""
from __future__ import annotations

import torch

from ..precision import torch_dtype
from .registry import register

__all__ = ["embedding", "take", "pick", "one_hot", "where", "batch_take",
           "gather_nd", "scatter_nd", "scatter_set_nd", "sequence_mask",
           "sequence_last", "sequence_reverse", "sparse_retain_dense",
           "getitem"]


def _long(t, device):
    return t.to(device=device, dtype=torch.long)


@register("Embedding", arg_names=["data", "weight"])
def embedding(data, weight, input_dim=None, output_dim=None, dtype="float32",
              sparse_grad=False):
    """Rows of the ``(input_dim, output_dim)`` weight by integer index."""
    return weight[_long(data, weight.device)]


@register("take", arg_names=["a", "indices"])
def take(a, indices, axis=0, mode="clip"):
    """Slices of ``a`` along ``axis`` by integer index."""
    idx = _long(indices, a.device)
    n = a.shape[axis]
    idx = torch.remainder(idx, n) if mode == "wrap" \
        else torch.clamp(idx, 0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    shape = a.shape[:axis % a.dim()] + idx.shape \
        + a.shape[axis % a.dim() + 1:]
    return out.reshape(shape)


@register("pick", arg_names=["data", "index"])
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """One element per row along ``axis`` by integer index, clamped into
    range."""
    axis = axis % data.dim()
    idx = _long(index, data.device)
    idx = torch.remainder(idx, data.shape[axis]) if mode == "wrap" \
        else torch.clamp(idx, 0, data.shape[axis] - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


@register("one_hot")
def one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    """Integer indices as one-hot rows of ``depth``; an index out of
    [0, depth) gives a row of ``off_value``."""
    idx = indices.long()
    hot = (idx.unsqueeze(-1) == torch.arange(int(depth), device=idx.device))
    out = torch.where(hot, on_value, off_value)
    return out.to(torch_dtype(dtype))


@register("where", arg_names=["condition", "x", "y"])
def where(condition, x, y):
    """x where condition is non-zero, else y."""
    return torch.where(condition.to(torch.bool), x, y)


@register("batch_take", arg_names=["a", "indices"])
def batch_take(a, indices):
    """``out[i] = a[i, indices[i]]``, indices clamped into range."""
    idx = torch.clamp(_long(indices, a.device), 0, a.shape[1] - 1)
    return a.gather(1, idx.reshape(-1, 1))[:, 0]


def _nd_index(indices, device):
    """The leading-axis index tuple of an (M, ...) index tensor."""
    return tuple(_long(indices, device))


@register("gather_nd", arg_names=["data", "indices"])
def gather_nd(data, indices):
    """Slices of ``data`` addressed by the index tuples along
    ``indices``' first axis."""
    return data[_nd_index(indices, data.device)]


@register("scatter_nd", arg_names=["data", "indices"])
def scatter_nd(data, indices, shape=()):
    """``data`` written into zeros of ``shape`` at the index tuples."""
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    out[_nd_index(indices, data.device)] = data
    return out


@register("_scatter_set_nd", arg_names=["lhs", "rhs", "indices"])
def scatter_set_nd(lhs, rhs, indices, shape=()):
    """A copy of ``lhs`` with ``rhs`` written at the index tuples (the
    indexed assignment behind ``NDArray.__setitem__``)."""
    out = lhs.clone()
    out[_nd_index(indices, lhs.device)] = rhs.to(lhs.dtype)
    return out


def _seq_len_optional(params):
    """The ``sequence_length`` input exists only under
    ``use_sequence_length=True``."""
    if params.get("use_sequence_length", False):
        return ()
    return ("sequence_length",)


def _steps_mask(data, sequence_length, axis):
    """(seq, batch) True where the step is inside its sequence, shaped to
    broadcast against ``data`` (time on ``axis`` 0 or 1)."""
    pos = torch.arange(data.shape[axis], device=data.device)
    mask = pos[:, None] < _long(sequence_length, data.device)[None, :]
    if axis == 1:
        mask = mask.T
    return mask.reshape(mask.shape + (1,) * (data.dim() - 2))


@register("SequenceMask", arg_names=["data", "sequence_length"],
          optional_args=_seq_len_optional)
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """Steps past each sequence's length set to ``value``."""
    if not use_sequence_length or sequence_length is None:
        return data
    return torch.where(_steps_mask(data, sequence_length, axis), data,
                       torch.full((), value, dtype=data.dtype,
                                  device=data.device))


@register("SequenceLast", arg_names=["data", "sequence_length"],
          optional_args=_seq_len_optional)
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    """Each sequence's last valid step."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    idx = _long(sequence_length, data.device) - 1
    if axis == 0:
        idx = idx.reshape((1, -1) + (1,) * (data.dim() - 2))
    else:
        idx = idx.reshape((-1, 1) + (1,) * (data.dim() - 2))
    idx = idx.expand(*[1 if i == axis else s
                       for i, s in enumerate(data.shape)])
    return data.gather(axis, idx).squeeze(axis)


@register("SequenceReverse", arg_names=["data", "sequence_length"],
          optional_args=_seq_len_optional)
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """The time axis (0) reversed within each sequence's length; steps
    past it stay in place."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (0,))
    pos = torch.arange(data.shape[0], device=data.device)[:, None]
    sl = _long(sequence_length, data.device)[None, :]
    src = torch.where(pos < sl, sl - 1 - pos, pos)
    src = src.reshape(src.shape + (1,) * (data.dim() - 2)).expand(
        data.shape)
    return data.gather(0, src)


@register("sparse_retain", arg_names=["data", "indices"])
def sparse_retain_dense(data, indices):
    """``data`` with every row not in ``indices`` zeroed (reference:
    src/operator/tensor/sparse_retain.cc, on a dense array)."""
    mask = torch.zeros(data.shape[0], dtype=torch.bool,
                       device=data.device).index_fill_(
                           0, _long(indices, data.device), True)
    return torch.where(mask.reshape((-1,) + (1,) * (data.dim() - 1)), data,
                       0)


@register("_getitem")
def getitem(data, _key=None):
    """``data[_key]``: the indexing behind ``NDArray.__getitem__``."""
    return data[_key]
