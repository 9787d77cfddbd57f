"""``Reshape`` with the reference's special codes: the part of
``mxnet_tpu/ops/matrix.py`` (``:17-53``) this port runs."""
from __future__ import annotations

from .registry import register

__all__ = ["reshape"]


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
