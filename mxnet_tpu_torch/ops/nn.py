"""The neural-network operators of the port, under the reference's operator
names: the part of ``mxnet_tpu/ops/nn.py`` that the ported paths run.

A ``HybridBlock`` of the port receives these functions (with every other
registered op) as ``F`` in ``hybrid_forward``, as a block of the
reference receives ``nd``; the symbolic executor and ``nd`` reach the
same functions through the op registry (``ops/registry.py``).  The JAX
package leaves these ops to XLA; here they are PyTorch calls (cuDNN / cuBLAS on the card).  Both layouts of the
reference are taken: channels-first (``NCHW`` data, ``OIHW`` weights) and
channels-last (``NHWC`` data, ``OHWI`` weights, ``BatchNorm(axis=3)``),
the latter run as channels-first views of the same memory.

``BatchNorm`` follows the reference's numerics, not torch's defaults:
the batch statistics are the biased variance in f32 (f64 for f64 data)
(``mxnet_tpu/ops/nn.py:290-302``) and the moving update is
``momentum*moving + (1-momentum)*batch`` (``:280-287``), written into the
moving-stat tensors in place.  Under a mixed-precision step the data is
bfloat16 (or float16) while the moving statistics stay the f32 aux
tensors: the forward reads their casts, as the reference's reads the
cast aux; the batch statistics are f32 (the reference's ``E[x]`` and
biased variance, ``:290-302``): on the card the forward kernel's own saved
mean and inverse std, with no extra pass over the data, on the CPU (whose
kernel rounds them to the data's dtype) ``E[x]`` and ``relu(E[x^2] -
E[x]^2)`` over the data widened to f32; and the update
``momentum*cast(moving) + (1-momentum)*batch``
(a half-precision product plus an f32 term, so f32) lands back in the f32
tensors, as the reference's ``muts.astype(float32)`` leaves it
(``parallel/trainer.py:1366``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ..precision import torch_dtype
from .registry import register

__all__ = ["FullyConnected", "Convolution", "Pooling", "BatchNorm",
           "Activation", "Flatten", "SoftmaxOutput", "softmax",
           "log_softmax", "softmin", "softmax_cross_entropy", "LayerNorm",
           "InstanceNorm", "LeakyReLU", "Dropout"]

_CHANNELS_LAST = ("NWC", "NHWC", "NDHWC")


def _tup(v, n):
    if v is None or v == ():
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _first(x):
    """A channels-last tensor as its channels-first view."""
    return x.movedim(-1, 1)


def _last(x):
    """A channels-first tensor as its channels-last view."""
    return x.movedim(1, -1)


@register("FullyConnected", arg_names=["data", "weight", "bias"])
def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True):
    """``data @ weight.T + bias``; weight is ``(num_hidden, input_dim)``,
    input above 2-D is flattened to ``(N, -1)`` when ``flatten``."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return TF.linear(data, weight, None if no_bias else bias)


@register("Convolution", arg_names=["data", "weight", "bias"])
def Convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, workspace=1024,
                no_bias=False, cudnn_tune=None, cudnn_off=False, layout=None):
    """Convolution with ``(num_filter, C/group, *kernel)`` weights, or
    ``(num_filter, *kernel, C/group)`` for the channels-last layouts."""
    nsp = len(kernel) if kernel else data.dim() - 2
    if layout in _CHANNELS_LAST:
        return _last(Convolution(
            _first(data), _first(weight), bias, kernel=kernel, stride=stride,
            dilate=dilate, pad=pad, num_filter=num_filter,
            num_group=num_group, no_bias=no_bias))
    conv = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}[nsp]
    return conv(data, weight, None if no_bias else bias,
                stride=_tup(stride, nsp),
                padding=_tup(pad, nsp) if pad else (0,) * nsp,
                dilation=_tup(dilate, nsp), groups=int(num_group))


def full_pad(sizes, kernel, stride, pad):
    """Extra high-side padding of the ``"full"`` convention, per spatial
    dim: the reference's output size ``ceil((n + 2p - k) / s) + 1`` (no
    clamp) and the shortfall padded on the high side
    (``mxnet_tpu/ops/nn.py:226-232``)."""
    extra = []
    for n, k, s, p in zip(sizes, kernel, stride, pad):
        out = -(-(n + 2 * p - k) // s) + 1
        extra.append(max(0, (out - 1) * s + k - (n + 2 * p)))
    return extra


def _padded(data, pad, extra, value):
    """``data`` (N, C, *spatial) padded by ``pad`` on both sides and
    ``extra`` more on the high side."""
    pads = []
    for p, e in zip(reversed(pad), reversed(extra)):
        pads += [p, p + e]
    return TF.pad(data, pads, value=value)


@register("Pooling")
def Pooling(data, kernel=(), pool_type="max", global_pool=False,
            cudnn_off=False, pooling_convention="valid", stride=(), pad=(),
            count_include_pad=True, layout=None):
    """max / avg pooling.  The ``"full"`` convention is the reference's,
    not torch's ``ceil_mode``: the high side is padded explicitly by the
    shortfall, so the output size has no clamp and avg pooling with
    ``count_include_pad`` divides by the whole window."""
    if layout in _CHANNELS_LAST:
        return _last(Pooling(
            _first(data), kernel=kernel, pool_type=pool_type,
            global_pool=global_pool, pooling_convention=pooling_convention,
            stride=stride, pad=pad, count_include_pad=count_include_pad))
    nsp = data.dim() - 2
    if global_pool:
        dims = tuple(range(2, 2 + nsp))
        if pool_type == "max":
            return data.amax(dim=dims, keepdim=True)
        return data.mean(dim=dims, keepdim=True)
    kernel = _tup(kernel, nsp)
    stride = _tup(stride, nsp) if stride else (1,) * nsp
    pad = _tup(pad, nsp) if pad else (0,) * nsp
    extra = full_pad(data.shape[2:], kernel, stride, pad) \
        if pooling_convention == "full" else [0] * nsp
    if pool_type == "max":
        pool = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}[nsp]
        if any(extra):
            low = float("-inf") if data.is_floating_point() \
                else torch.iinfo(data.dtype).min
            return pool(_padded(data, pad, extra, low), kernel, stride)
        return pool(data, kernel, stride, pad)
    if pool_type == "avg":
        pool = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}[nsp]
        if not any(extra):
            return pool(data, kernel, stride, pad,
                        count_include_pad=bool(count_include_pad))
        summed = pool(_padded(data, pad, extra, 0.0), kernel, stride)
        if count_include_pad:
            return summed
        # the window's mean over its real elements: both pools divide
        # by the window size, so the ratio is sum / count
        ones = torch.ones_like(data[:1, :1])
        return summed / pool(_padded(ones, pad, extra, 0.0), kernel, stride)
    raise ValueError("unknown pool_type %r" % pool_type)


@register("BatchNorm", arg_names=["data", "gamma", "beta"],
          aux={3: "moving_mean", 4: "moving_var"},
          num_outputs=lambda p: 3 if p.get("output_mean_var") else 1,
          needs_train=True)
def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, cudnn_off=False, _train=False):
    """Batch statistics when training (and the moving stats updated in
    place), the moving statistics otherwise; ``axis`` is the channel
    axis (3 for NHWC)."""
    if output_mean_var:
        raise NotImplementedError(
            "BatchNorm(output_mean_var=True) is ROADMAP.md queue A, item 1")
    axis = axis % data.dim()
    if axis != 1:
        return BatchNorm(data.movedim(axis, 1), gamma, beta, moving_mean,
                         moving_var, eps=eps, momentum=momentum,
                         fix_gamma=fix_gamma,
                         use_global_stats=use_global_stats, axis=1,
                         _train=_train).movedim(1, axis)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    half = (data.dtype in (torch.bfloat16, torch.float16)
            and moving_mean.dtype == torch.float32)
    if half:
        return _batch_norm_half(data, g, beta, moving_mean, moving_var,
                                float(eps), momentum,
                                _train and not use_global_stats)
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


def _batch_norm_half(data, g, beta, moving_mean, moving_var, eps, momentum,
                     train):
    """BatchNorm on half-precision data over f32 moving statistics (the
    module docstring's mixed-precision spelling); channels on axis 1."""
    dt = data.dtype
    mm_c, mv_c = moving_mean.to(dt), moving_var.to(dt)
    if not train:
        return TF.batch_norm(data, mm_c, mv_c, g, beta, training=False,
                             eps=eps)
    out, mean, invstd = torch.native_batch_norm(data, g, beta, None, None,
                                                True, 0.0, eps)
    with torch.no_grad():
        if mean.dtype == torch.float32:
            var = torch.relu(1.0 / (invstd * invstd) - eps)
        else:
            red = [0] + list(range(2, data.dim()))
            x32 = data.detach().float()
            mean = x32.mean(dim=red)
            var = torch.relu((x32 * x32).mean(dim=red) - mean * mean)
        mom = torch.full((), momentum, dtype=dt, device=data.device)
        moving_mean.copy_(mom * mm_c + (1 - momentum) * mean)
        moving_var.copy_(mom * mv_c + (1 - momentum) * var)
    return out


@register("Activation")
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


@register("Flatten", aliases=("flatten",))
def Flatten(data):
    return data.reshape(data.shape[0], -1)


@register("SoftmaxOutput", arg_names=["data", "label"], aliases=("Softmax",))
def SoftmaxOutput(data, label, grad_scale=1.0, ignore_label=-1.0,
                  multi_output=False, use_ignore=False, preserve_shape=False,
                  normalization="null", out_grad=False, smooth_alpha=0.0):
    """The forward of the reference's classification head: a softmax over
    the last axis (axis 1 with ``multi_output``); the label only shapes
    its backward, which the forward-only executor never runs."""
    return torch.softmax(data, dim=1 if multi_output else -1)


def _softmax_io(data, dtype):
    """Half-precision softmax accumulates in f32 and returns the input's
    dtype unless ``dtype`` names another (reference: ops/nn.py
    ``_softmax_io``)."""
    out = torch_dtype(dtype) if dtype is not None else data.dtype
    if data.dtype in (torch.float16, torch.bfloat16):
        data = data.float()
    return data, out


@register("softmax")
def softmax(data, axis=-1, temperature=None, dtype=None):
    data, out = _softmax_io(data, dtype)
    x = data / temperature if temperature else data
    return torch.softmax(x, dim=axis).to(out)


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None, dtype=None):
    data, out = _softmax_io(data, dtype)
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=axis).to(out)


@register("softmin")
def softmin(data, axis=-1, temperature=None, dtype=None):
    data, out = _softmax_io(data, dtype)
    return torch.softmax(-data, dim=axis).to(out)


@register("softmax_cross_entropy", arg_names=["data", "label"])
def softmax_cross_entropy(data, label):
    """The summed cross-entropy of integer labels (reference:
    src/operator/loss_binary_op.cc)."""
    lp = torch.log_softmax(data, dim=-1)
    return -lp.gather(-1, label.long()[:, None]).sum()


@register("LayerNorm", arg_names=["data", "gamma", "beta"])
def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Normalized over ``axis`` in f32 (reference: ops/nn.py:393; the
    fused kernel B4 is the TransformerLM's, not this op's)."""
    axis = axis % data.dim()
    x32 = data.float()
    var, mean = torch.var_mean(x32, dim=axis, keepdim=True, unbiased=False)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    out = out * gamma.float().reshape(shape) + beta.float().reshape(shape)
    return out.to(data.dtype)


@register("InstanceNorm", arg_names=["data", "gamma", "beta"])
def InstanceNorm(data, gamma, beta, eps=1e-3):
    """Normalized over the spatial axes per (N, C), in f32."""
    red = tuple(range(2, data.dim()))
    x32 = data.float()
    var, mean = torch.var_mean(x32, dim=red, keepdim=True, unbiased=False)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    out = out * gamma.reshape(shape) + beta.reshape(shape)
    return out.to(data.dtype)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register("LeakyReLU", arg_names=["data", "gamma"], needs_train=True)
def LeakyReLU(data, gamma=None, act_type="leaky", slope=0.25,
              lower_bound=0.125, upper_bound=0.334, _train=False,
              generator=None):
    """leaky / prelu / elu / selu / gelu (the tanh form, as
    ``jax.nn.gelu``'s default is) / rrelu, whose training slopes are
    drawn from ``generator`` (reference: src/operator/leaky_relu.cc)."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "prelu":
        g = gamma
        if g.dim() == 1 and g.dim() < data.dim():
            g = g.reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.where(data > 0, data, g * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(
            data > 0, data, _SELU_ALPHA * torch.expm1(data))
    if act_type == "gelu":
        return TF.gelu(data, approximate="tanh")
    if act_type == "rrelu":
        if _train:
            u = torch.rand(data.shape, generator=generator,
                           device=data.device, dtype=data.dtype)
            s = lower_bound + (upper_bound - lower_bound) * u
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(data > 0, data, s * data)
    raise ValueError("unknown act_type %r" % act_type)


@register("Dropout", needs_train=True)
def Dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False,
            _train=False, generator=None):
    """Inverted dropout: each kept element scaled by 1/(1-p), the mask
    shared along ``axes`` and drawn from ``generator`` (torch's default
    generator of the device when None); the identity outside training
    unless ``mode="always"`` (reference: src/operator/nn/dropout.cc)."""
    if (not _train and mode != "always") or p == 0:
        return data
    shape = [1 if i in axes else s for i, s in enumerate(data.shape)]
    keep = torch.rand(shape, generator=generator, device=data.device) \
        < 1.0 - p
    return torch.where(keep, data / (1.0 - p), torch.zeros_like(data))
