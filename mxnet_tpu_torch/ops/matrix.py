"""Shape and matrix operators: the part of ``mxnet_tpu/ops/matrix.py`` the
NDArray methods and the ported layers reach (``Reshape`` with the
reference's special codes, transposes, slices, ``split``, ``Concat``,
broadcasts, ``dot``); the rest is ROADMAP.md queue A, item 1(b)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from .registry import register

__all__ = ["reshape", "reshape_like", "transpose", "expand_dims", "squeeze",
           "swapaxes", "tile", "pad", "concat", "split", "slice_op",
           "slice_axis", "broadcast_to", "broadcast_like", "dot",
           "zeros_like", "ones_like"]


@register("Reshape", aliases=("reshape",))
def reshape(data, shape=None, reverse=False):
    """MXNet reshape with special codes 0 (keep), -1 (infer), -2 (copy
    rest), -3 (merge two), -4 (split) — reference matrix_op.cc
    ReshapeShape."""
    if shape is None:
        return data
    src = list(data.shape)
    shape = list(shape)
    if reverse:
        src = src[::-1]
        shape = shape[::-1]
    out = []
    i = j = 0
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            a, b = shape[j + 1], shape[j + 2]
            if a == -1:
                a = src[i] // b
            elif b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(s)
            i += 1
        j += 1
    if reverse:
        out = out[::-1]
    return data.reshape(tuple(out))


@register("reshape_like", arg_names=["lhs", "rhs"])
def reshape_like(lhs, rhs):
    """lhs in rhs's shape."""
    return lhs.reshape(rhs.shape)


@register("transpose")
def transpose(data, axes=None):
    """Permute axes; reverse them when ``axes`` is empty."""
    if axes is None or axes == ():
        axes = tuple(reversed(range(data.dim())))
    return data.permute(*axes)


@register("expand_dims")
def expand_dims(data, axis=0):
    """A size-1 axis inserted at ``axis``."""
    return data.unsqueeze(axis)


@register("squeeze")
def squeeze(data, axis=None):
    """Size-1 axes dropped: all, or those in ``axis``."""
    if axis is None:
        return data.squeeze()
    return data.squeeze(axis if isinstance(axis, int) else tuple(axis))


@register("swapaxes", aliases=("SwapAxis",))
def swapaxes(data, dim1=0, dim2=0):
    """Axes dim1 and dim2 exchanged."""
    return data.transpose(dim1, dim2)


@register("tile")
def tile(data, reps=()):
    """The whole tensor repeated ``reps`` times per axis."""
    return torch.tile(data, tuple(reps))


_PAD_MODES = {"constant": "constant", "edge": "replicate",
              "reflect": "reflect"}


@register("Pad", aliases=("pad",))
def pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """``pad_width`` holds (before, after) per axis, every axis listed;
    edge and reflect pad the spatial axes only, as the reference's do."""
    if mode not in _PAD_MODES:
        raise ValueError("unknown pad mode %r" % mode)
    pairs = [(pad_width[2 * i], pad_width[2 * i + 1])
             for i in range(len(pad_width) // 2)]
    first = 0 if mode == "constant" else 2
    pads = []
    for b, a in reversed(pairs[first:]):
        pads += [int(b), int(a)]
    if mode == "constant":
        return TF.pad(data, pads, value=constant_value)
    return TF.pad(data, pads, mode=_PAD_MODES[mode])


@register("Concat", arg_names=["args"], aliases=("concat",))
def concat(*args, dim=1, num_args=None):
    """Inputs joined along ``dim``."""
    return torch.cat(args, dim=dim)


@register("SliceChannel", aliases=("split",),
          num_outputs=lambda p: int(p["num_outputs"]))
def split(data, num_outputs=1, axis=1, squeeze_axis=False):
    """``num_outputs`` equal parts along ``axis``."""
    n = int(num_outputs)
    if data.shape[axis] % n:
        raise ValueError("split: axis %d of size %d is not divisible by %d"
                         % (axis, data.shape[axis], n))
    parts = torch.split(data, data.shape[axis] // n, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return parts[0] if n == 1 else tuple(parts)


@register("slice", aliases=("crop",))
def slice_op(data, begin=(), end=(), step=()):
    """begin/end/step per leading axis; ``None`` keeps the bound open."""
    idx = []
    for a in range(data.dim()):
        b = begin[a] if a < len(begin) else None
        e = end[a] if a < len(end) else None
        s = step[a] if step and a < len(step) and step[a] else None
        if s is not None and s < 0:
            raise NotImplementedError(
                "slice with a negative step is ROADMAP.md queue A, item 1(b)")
        idx.append(slice(b, e, s))
    return data[tuple(idx)]


@register("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None):
    """[begin, end) along one axis."""
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


@register("broadcast_to")
def broadcast_to(data, shape=()):
    """Broadcast to ``shape``; a 0 entry keeps the source's size."""
    lead = len(shape) - data.dim()
    tgt = [s if s != 0 else data.shape[i - lead]
           for i, s in enumerate(shape)]
    return data.expand(*tgt)


@register("broadcast_like", arg_names=["lhs", "rhs"])
def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    """lhs broadcast to rhs's shape, or on the paired axes only."""
    if lhs_axes is None:
        return lhs.expand(*rhs.shape)
    shape = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        shape[la] = rhs.shape[ra]
    return lhs.expand(*shape)


@register("dot", arg_names=["lhs", "rhs"])
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """The last axis of lhs contracted with the first of rhs (a full
    transpose first where asked), as the reference's ``dot``."""
    if transpose_a:
        lhs = lhs.permute(*reversed(range(lhs.dim())))
    if transpose_b:
        rhs = rhs.permute(*reversed(range(rhs.dim())))
    if lhs.dim() == 1 and rhs.dim() == 1:
        return torch.dot(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=1)


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)
