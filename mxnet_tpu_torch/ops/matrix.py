"""Shape and matrix operators: the port of ``mxnet_tpu/ops/matrix.py``
(``Reshape`` with the reference's special codes, transposes, slices with
any step, ``split``, ``Concat`` / ``stack``, broadcasts, ``dot`` /
``batch_dot``, ``depth_to_space`` and its inverse, ``diag``, the
index (un)ravelling and the slice assignments)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from .registry import register

__all__ = ["reshape", "reshape_like", "transpose", "expand_dims", "squeeze",
           "swapaxes", "tile", "pad", "concat", "split", "slice_op",
           "slice_axis", "broadcast_to", "broadcast_like", "dot",
           "zeros_like", "ones_like", "flip", "repeat", "stack",
           "slice_like", "broadcast_axis", "batch_dot", "depth_to_space",
           "space_to_depth", "diag", "shape_array", "size_array",
           "ravel_multi_index", "unravel_index", "slice_assign",
           "slice_assign_scalar"]


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


def _steps(data, begin, end, step):
    """One python ``slice`` per axis from MXNet's begin/end/step (``None``
    keeps a bound open; a 0 or missing step is 1)."""
    out = []
    for a in range(data.dim()):
        b = begin[a] if a < len(begin) else None
        e = end[a] if a < len(end) else None
        s = step[a] if step and a < len(step) and step[a] else None
        out.append(slice(b, e, s))
    return out


def _axis_index(sl, n, device):
    """The indices a python slice picks from an axis of size ``n``."""
    return torch.arange(*sl.indices(n), device=device)


@register("slice", aliases=("crop",))
def slice_op(data, begin=(), end=(), step=()):
    """begin/end/step per leading axis; ``None`` keeps the bound open and
    a negative step walks backwards, as numpy's slices do."""
    out = data
    idx = []
    for a, sl in enumerate(_steps(data, begin, end, step)):
        if sl.step is not None and sl.step < 0:
            out = out.index_select(a, _axis_index(sl, data.shape[a],
                                                  data.device))
            sl = slice(None)
        idx.append(sl)
    return out[tuple(idx)]


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


@register("flip", aliases=("reverse",))
def flip(data, axis=None):
    """Reversed along ``axis`` (an int or a tuple; every axis when
    None)."""
    if axis is None:
        dims = tuple(range(data.dim()))
    elif isinstance(axis, int):
        dims = (axis,)
    else:
        dims = tuple(axis)
    return torch.flip(data, dims)


@register("repeat")
def repeat(data, repeats=1, axis=None):
    """Each element ``repeats`` times along ``axis`` (of the flattened
    data when None)."""
    return torch.repeat_interleave(data, int(repeats), dim=axis)


@register("stack", arg_names=["args"])
def stack(*args, axis=0, num_args=None):
    """Inputs stacked along a new ``axis``."""
    return torch.stack(args, dim=axis)


@register("slice_like", arg_names=["data", "shape_like"])
def slice_like(data, shape_like, axes=()):
    """``data`` cut to ``shape_like``'s extent on ``axes`` (every axis
    when empty)."""
    idx = [slice(None)] * data.dim()
    for ax in (axes or range(data.dim())):
        idx[ax] = slice(0, shape_like.shape[ax])
    return data[tuple(idx)]


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, axis=(), size=()):
    """Size-1 axes broadcast to ``size``."""
    if isinstance(axis, int):
        axis, size = (axis,), (size,)
    shape = list(data.shape)
    for a, n in zip(axis, size):
        shape[a] = n
    return data.expand(*shape)


@register("batch_dot", arg_names=["lhs", "rhs"])
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Matrix products over the leading batch axes."""
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


@register("depth_to_space")
def depth_to_space(data, block_size=1):
    """Channel blocks moved into ``block_size`` x ``block_size`` spatial
    blocks (NCHW; the reference's (b, b, C') channel order)."""
    n, c, h, w = data.shape
    b = int(block_size)
    x = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(data, block_size=1):
    """Spatial blocks folded into channels: the inverse of
    ``depth_to_space``."""
    n, c, h, w = data.shape
    b = int(block_size)
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("diag")
def diag(data, k=0):
    """The ``k``-th diagonal of the last two axes, or the matrix with a
    1-D input on its ``k``-th diagonal."""
    if data.dim() == 1:
        return torch.diag(data, int(k))
    return torch.diagonal(data, offset=int(k), dim1=-2, dim2=-1)


@register("shape_array")
def shape_array(data):
    """The shape as a 1-D int32 tensor."""
    return torch.tensor(tuple(data.shape), dtype=torch.int32,
                        device=data.device)


@register("size_array")
def size_array(data):
    """The element count as a 1-element int32 tensor."""
    return torch.tensor([data.numel()], dtype=torch.int32,
                        device=data.device)


def _strides(shape, like):
    st = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        st[i] = st[i + 1] * int(shape[i + 1])
    return torch.tensor(st, dtype=like.dtype, device=like.device)


@register("_ravel_multi_index", aliases=("ravel_multi_index",))
def ravel_multi_index(data, shape=()):
    """(ndim, N) coordinate rows -> flat indices into ``shape``, in the
    data's dtype (reference: src/operator/tensor/ravel.cc:32)."""
    s = _strides(shape, data).reshape((-1,) + (1,) * (data.dim() - 1))
    return (data * s).sum(dim=0)


@register("_unravel_index", aliases=("unravel_index",))
def unravel_index(data, shape=()):
    """Flat indices -> (ndim, N) coordinate rows of ``shape``, in the
    data's dtype (reference: ravel.cc:56)."""
    st = [int(v) for v in _strides(shape, data).tolist()]
    return torch.stack([torch.remainder(
        torch.div(data, s, rounding_mode="floor"), int(d))
        for d, s in zip(shape, st)], dim=0)


def _assign_index(data, begin, end, step):
    """Broadcast index tensors of the begin/end/step region."""
    picks = [_axis_index(sl, n, data.device)
             for sl, n in zip(_steps(data, begin, end, step), data.shape)]
    nd = len(picks)
    return tuple(p.reshape((1,) * a + (-1,) + (1,) * (nd - a - 1))
                 for a, p in enumerate(picks))


@register("_slice_assign", arg_names=["lhs", "rhs"])
def slice_assign(lhs, rhs, begin=(), end=(), step=()):
    """A copy of ``lhs`` with ``rhs`` written into the region (reference:
    src/operator/tensor/matrix_op.cc _slice_assign)."""
    out = lhs.clone()
    out[_assign_index(lhs, begin, end, step)] = rhs.to(lhs.dtype)
    return out


@register("_slice_assign_scalar")
def slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=()):
    """A copy of ``data`` with the region filled by ``scalar``."""
    out = data.clone()
    out[_assign_index(data, begin, end, step)] = scalar
    return out
