"""The neural-network operators the Gluon layers of the port call, under the
reference's operator names: the part of ``mxnet_tpu/ops/nn.py`` (and of
its ``reduce``/``indexing`` ops) that the ResNet training slice runs.

A ``HybridBlock`` of the port receives this module as ``F`` in
``hybrid_forward``, as a block of the reference receives ``nd``.  The
JAX package leaves these ops to XLA; here they are PyTorch calls (cuDNN /
cuBLAS on the card).  Layout is channels-first (``NCHW`` data, ``OIHW``
weights); the channels-last layouts raise ``NotImplementedError``
(ROADMAP.md queue A, item 1).

``BatchNorm`` follows the reference's numerics, not torch's defaults:
the batch statistics are the biased variance in f32 (f64 for f64 data)
(``mxnet_tpu/ops/nn.py:290-302``) and the moving update is
``momentum*moving + (1-momentum)*batch`` (``:280-287``), written into the
moving-stat tensors in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

__all__ = ["FullyConnected", "Convolution", "Pooling", "BatchNorm",
           "Activation", "Flatten", "log_softmax", "pick", "mean"]

_CHANNELS_LAST = ("NWC", "NHWC", "NDHWC")


def _tup(v, n):
    if v is None or v == ():
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _channels_first(op, layout):
    if layout in _CHANNELS_LAST:
        raise NotImplementedError(
            "%s layout=%r: the port runs channels-first only so far; the "
            "channels-last layouts are ROADMAP.md queue A, item 1" % (op,
                                                                     layout))


def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True):
    """``data @ weight.T + bias``; weight is ``(num_hidden, input_dim)``,
    input above 2-D is flattened to ``(N, -1)`` when ``flatten``."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return TF.linear(data, weight, None if no_bias else bias)


def Convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, workspace=1024,
                no_bias=False, cudnn_tune=None, cudnn_off=False, layout=None):
    """Convolution with ``(num_filter, C/group, *kernel)`` weights."""
    _channels_first("Convolution", layout)
    nsp = len(kernel) if kernel else data.dim() - 2
    conv = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}[nsp]
    return conv(data, weight, None if no_bias else bias,
                stride=_tup(stride, nsp),
                padding=_tup(pad, nsp) if pad else (0,) * nsp,
                dilation=_tup(dilate, nsp), groups=int(num_group))


def Pooling(data, kernel=(), pool_type="max", global_pool=False,
            cudnn_off=False, pooling_convention="valid", stride=(), pad=(),
            count_include_pad=True, layout=None):
    """max / avg pooling; the ``"full"`` convention rounds the output
    size up (torch's ``ceil_mode``)."""
    _channels_first("Pooling", layout)
    nsp = data.dim() - 2
    if global_pool:
        dims = tuple(range(2, 2 + nsp))
        if pool_type == "max":
            return data.amax(dim=dims, keepdim=True)
        return data.mean(dim=dims, keepdim=True)
    kernel = _tup(kernel, nsp)
    stride = _tup(stride, nsp) if stride else (1,) * nsp
    pad = _tup(pad, nsp) if pad else (0,) * nsp
    ceil = pooling_convention == "full"
    if pool_type == "max":
        pool = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}[nsp]
        return pool(data, kernel, stride, pad, ceil_mode=ceil)
    if pool_type == "avg":
        pool = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}[nsp]
        return pool(data, kernel, stride, pad, ceil_mode=ceil,
                    count_include_pad=bool(count_include_pad))
    raise ValueError("unknown pool_type %r" % pool_type)


def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, cudnn_off=False, _train=False):
    """Batch statistics when training (and the moving stats updated in
    place), the moving statistics otherwise."""
    if axis % data.dim() != 1:
        raise NotImplementedError(
            "BatchNorm axis=%d: the port normalizes the channel axis 1 "
            "(NCHW) only so far (ROADMAP.md queue A, item 1)" % axis)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if _train and not use_global_stats:
        out = TF.batch_norm(data, None, None, g, beta, training=True,
                            eps=float(eps))
        with torch.no_grad():
            red = [0] + list(range(2, data.dim()))
            stat = data.detach().to(torch.promote_types(data.dtype,
                                                         torch.float32))
            var, mean = torch.var_mean(stat, dim=red, unbiased=False)
            moving_mean.copy_(momentum * moving_mean + (1 - momentum) * mean)
            moving_var.copy_(momentum * moving_var + (1 - momentum) * var)
        return out
    return TF.batch_norm(data, moving_mean, moving_var, g, beta,
                         training=False, eps=float(eps))


def Activation(data, act_type="relu"):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return TF.softplus(data)
    if act_type == "softsign":
        return TF.softsign(data)
    raise ValueError("unknown act_type %r" % act_type)


def Flatten(data):
    return data.reshape(data.shape[0], -1)


def log_softmax(data, axis=-1):
    return torch.log_softmax(data, dim=axis)


def pick(data, index, axis=-1, keepdims=False):
    """``data`` indexed along ``axis`` by ``index`` (one index per row)."""
    axis = axis % data.dim()
    idx = index.to(device=data.device, dtype=torch.long).unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


def mean(data, axis=None, keepdims=False, exclude=False):
    """Mean over ``axis`` (all axes when None); ``exclude=True`` reduces
    over every axis except ``axis``."""
    if axis is None:
        return data.mean()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(a % data.dim() for a in axes)
    if exclude:
        axes = tuple(a for a in range(data.dim()) if a not in axes)
    if not axes:
        return data
    return data.mean(dim=axes, keepdim=keepdims)
