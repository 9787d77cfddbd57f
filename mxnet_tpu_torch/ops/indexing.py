"""Indexing operators: the port of the part of ``mxnet_tpu/ops/indexing.py``
the NDArray methods, the ported layers, losses and metrics reach
(``Embedding``, ``take``, ``pick``, ``one_hot``, ``where``; the rest is
ROADMAP.md queue A, item 1(b)).  Indices are read as integers
(float indices are truncated, as the reference's ``astype(int32)``
does); ``clip`` mode clamps them into range, ``wrap`` takes them modulo
the axis."""
from __future__ import annotations

import torch

from ..precision import torch_dtype
from .registry import register

__all__ = ["embedding", "take", "pick", "one_hot", "where"]


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
