"""The neural-network operators of the port, under the reference's operator
names: the port of ``mxnet_tpu/ops/nn.py``.

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

__all__ = ["FullyConnected", "Convolution", "Deconvolution", "Pooling",
           "BatchNorm", "Activation", "Flatten", "SoftmaxOutput", "softmax",
           "log_softmax", "softmin", "softmax_cross_entropy", "LayerNorm",
           "InstanceNorm", "LeakyReLU", "Dropout", "L2Normalization", "LRN",
           "SoftmaxActivation", "LinearRegressionOutput",
           "MAERegressionOutput", "LogisticRegressionOutput", "MakeLoss",
           "SVMOutput", "UpSampling", "Crop", "GridGenerator",
           "BilinearSampler", "SpatialTransformer", "ROIPooling",
           "Correlation"]

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


def _deconv_optional(params):
    """The symbolic front end makes no bias input unless ``no_bias`` is
    False (the reference's default is True)."""
    return ("bias",) if params.get("no_bias", True) else ()


@register("Deconvolution", arg_names=["data", "weight", "bias"],
          optional_args=_deconv_optional)
def Deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), target_shape=(), num_filter=0, num_group=1,
                  workspace=512, no_bias=True, cudnn_tune=None,
                  cudnn_off=False, layout=None):
    """Transposed convolution with ``(C_in, C_out/group, *kernel)`` weights
    in every layout (the channels-last layouts change the data's only,
    ``mxnet_tpu/ops/nn.py:128-131``).  The output is the reference's
    input-dilated convolution: ``(n - 1) * stride + (k - 1) * dilate + 1
    - 2 * pad + adj`` per spatial dim, taken from torch's unpadded
    transposed convolution by cropping ``pad`` on the low side and
    ``pad - adj`` on the high side (zeros where that is negative), so any
    ``adj`` works, not only ``adj < stride``.  ``target_shape`` is taken
    and ignored, as the reference's is."""
    nsp = len(kernel)
    if layout in _CHANNELS_LAST:
        return _last(Deconvolution(
            _first(data), weight, bias, kernel=kernel, stride=stride,
            dilate=dilate, pad=pad, adj=adj, num_filter=num_filter,
            num_group=num_group, no_bias=no_bias))
    pad = _tup(pad, nsp) if pad else (0,) * nsp
    adj = _tup(adj, nsp) if adj else (0,) * nsp
    deconv = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
              3: TF.conv_transpose3d}[nsp]
    out = deconv(data, weight, None, stride=_tup(stride, nsp),
                 groups=int(num_group), dilation=_tup(dilate, nsp))
    for i, (p, a) in enumerate(zip(pad, adj)):
        size = out.shape[2 + i] - 2 * p + a
        out = out.narrow(2 + i, p, min(size, out.shape[2 + i] - p))
        if out.shape[2 + i] < size:
            tail = [0, 0] * (nsp - 1 - i) + [0, size - out.shape[2 + i]]
            out = TF.pad(out, tail)
    if bias is not None and not no_bias:
        out = out + bias.reshape((1, -1) + (1,) * nsp)
    return out


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
    """max / avg / sum / lp (p = 2) pooling.  The ``"full"`` convention
    is the reference's, not torch's ``ceil_mode``: the high side is
    padded explicitly by the shortfall, so the output size has no clamp
    and avg pooling with ``count_include_pad`` divides by the whole
    window."""
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
        if pool_type == "sum":
            return data.sum(dim=dims, keepdim=True)
        if pool_type == "lp":
            return torch.pow(torch.square(data.abs()).sum(dim=dims,
                                                          keepdim=True), 0.5)
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
    if pool_type in ("sum", "lp"):
        # lp is the reference's p = 2: sqrt of the window's sum of squares
        x = data if pool_type == "sum" else torch.square(data.abs())
        summed = _window_sum(_padded(x, pad, extra, 0.0), kernel, stride)
        return summed if pool_type == "sum" else torch.pow(summed, 0.5)
    raise ValueError("unknown pool_type %r" % pool_type)


def _window_sum(x, kernel, stride):
    """The sum over each pooling window (an average pool with divisor 1;
    1-D windows as 2-D ones of height 1)."""
    if len(kernel) == 1:
        return TF.avg_pool2d(x.unsqueeze(2), (1,) + tuple(kernel),
                             (1,) + tuple(stride),
                             divisor_override=1).squeeze(2)
    pool = TF.avg_pool2d if len(kernel) == 2 else TF.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


@register("BatchNorm", arg_names=["data", "gamma", "beta"],
          aux={3: "moving_mean", 4: "moving_var"},
          num_outputs=lambda p: 3 if p.get("output_mean_var") else 1,
          needs_train=True)
def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, cudnn_off=False, _train=False):
    """Batch statistics when training (and the moving stats updated in
    place), the moving statistics otherwise; ``axis`` is the channel
    axis (3 for NHWC).  ``output_mean_var`` also returns the statistics
    used, in float32 or wider (the batch's mean and biased variance, or
    the moving ones), as the reference's does."""
    axis = axis % data.dim()
    if output_mean_var:
        out = BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                        momentum=momentum, fix_gamma=fix_gamma,
                        use_global_stats=use_global_stats, axis=axis,
                        _train=_train)
        if _train and not use_global_stats:
            red = [i for i in range(data.dim()) if i != axis]
            var, mean = torch.var_mean(
                data.to(torch.promote_types(data.dtype, torch.float32)),
                dim=red, unbiased=False)
            return out, mean, var
        wide = torch.promote_types(moving_mean.dtype, torch.float32)
        return out, moving_mean.to(wide), moving_var.to(wide)
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


def _one_hot_along(lab, nclass, axis, dtype):
    """One-hot rows of ``lab`` with the class axis at ``axis`` (-1 or 1),
    zeros for a label outside [0, nclass), as ``jax.nn.one_hot``."""
    if axis == -1:
        classes = torch.arange(nclass, device=lab.device)
        return (lab.unsqueeze(-1) == classes).to(dtype)
    classes = torch.arange(nclass, device=lab.device).reshape(
        (1, nclass) + (1,) * (lab.dim() - 1))
    return (lab.unsqueeze(1) == classes).to(dtype)


class _SoftmaxOutputFn(torch.autograd.Function):
    """softmax forward; the backward ignores the head gradient and returns
    ``(softmax - one_hot(label)) * scale`` (reference:
    ``_softmax_output_core``, ``mxnet_tpu/ops/nn.py:548-584``)."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                multi_output, valid, smooth_alpha):
        out = torch.softmax(data, dim=1 if multi_output else -1)
        ctx.save_for_backward(out, label)
        ctx.cfg = (grad_scale, ignore_label, use_ignore, multi_output, valid,
                   smooth_alpha)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, multi_output, valid, alpha = \
            ctx.cfg
        axis = 1 if multi_output else -1
        nclass = out.shape[axis]
        lab = label.long()
        onehot = _one_hot_along(lab, nclass, axis, out.dtype)
        if alpha:
            onehot = onehot * (1 - alpha) \
                + alpha / (nclass - 1) * (1 - onehot)
        grad = out - onehot
        scale = grad_scale
        if use_ignore:
            keep = (lab != int(ignore_label)).to(out.dtype)
            grad = grad * keep.unsqueeze(axis)
            if valid:
                scale = scale * lab.numel() / torch.clamp(keep.sum(), min=1.0)
        elif valid:
            scale = scale / lab.numel() * out.shape[0]
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return (grad * scale, dlabel) + (None,) * 6


@register("SoftmaxOutput", arg_names=["data", "label"], aliases=("Softmax",))
def SoftmaxOutput(data, label, grad_scale=1.0, ignore_label=-1.0,
                  multi_output=False, use_ignore=False, preserve_shape=False,
                  normalization="null", out_grad=False, smooth_alpha=0.0):
    """The reference's classification head: a softmax over the last axis
    (axis 1 with ``multi_output``) whose backward, whatever the head
    gradient, is ``(softmax - one_hot(label)) * grad_scale``, with the
    ignored labels' rows zeroed under ``use_ignore``, the scale divided by
    the valid count under ``normalization="valid"``, and the one-hot
    smoothed by ``smooth_alpha``."""
    return _SoftmaxOutputFn.apply(data, label, grad_scale, ignore_label,
                                  bool(use_ignore), bool(multi_output),
                                  normalization == "valid", smooth_alpha)


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


def _gen(generator, data):
    """``generator``, or the seeded generator of ``data``'s device."""
    if generator is not None:
        return generator
    from .. import _rng
    return _rng.next_generator(data.device)


@register("LeakyReLU", arg_names=["data", "gamma"], needs_train=True)
def LeakyReLU(data, gamma=None, act_type="leaky", slope=0.25,
              lower_bound=0.125, upper_bound=0.334, _train=False,
              generator=None):
    """leaky / prelu / elu / selu / gelu (the tanh form, as
    ``jax.nn.gelu``'s default is) / rrelu, whose training slopes are
    drawn from ``generator`` (the seeded generator of the data's device,
    ``_rng``, when None; reference: src/operator/leaky_relu.cc)."""
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
            u = torch.rand(data.shape, generator=_gen(generator, data),
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
    shared along ``axes`` and drawn from ``generator`` (the seeded
    generator of the data's device, ``_rng``, when None); the identity
    outside training unless ``mode="always"`` (reference:
    src/operator/nn/dropout.cc)."""
    if (not _train and mode != "always") or p == 0:
        return data
    shape = [1 if i in axes else s for i, s in enumerate(data.shape)]
    keep = torch.rand(shape, generator=_gen(generator, data),
                      device=data.device) \
        < 1.0 - p
    return torch.where(keep, data / (1.0 - p), torch.zeros_like(data))


# -- the rest of the reference's ops/nn.py ---------------------------------
@register("L2Normalization")
def L2Normalization(data, eps=1e-10, mode="instance"):
    """``data / sqrt(sum(data^2) + eps)`` over every axis but the batch
    (instance), the channel axis (channel) or the spatial axes (spatial)
    (reference: src/operator/l2_normalization.cc)."""
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    elif mode == "spatial":
        red = tuple(range(2, data.dim()))
    else:
        raise ValueError("unknown mode %r" % mode)
    return data / torch.sqrt(torch.sum(torch.square(data), dim=red,
                                       keepdim=True) + eps)


@register("LRN")
def LRN(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across channels: ``data / (knorm +
    alpha / nsize * sum of squares over nsize channels)^beta`` (reference:
    src/operator/nn/lrn.cc; the sum over the zero-padded window in the
    reference's order)."""
    sq = torch.square(data)
    half = int(nsize) // 2
    pad = [0, 0] * (data.dim() - 2) + [half, half]
    sqp = TF.pad(sq, pad)
    acc = sqp.narrow(1, 0, data.shape[1])
    for i in range(1, int(nsize)):
        acc = acc + sqp.narrow(1, i, data.shape[1])
    return data / torch.pow(knorm + alpha / nsize * acc, beta)


@register("SoftmaxActivation")
def SoftmaxActivation(data, mode="instance"):
    """softmax over the channel axis (channel) or over each flattened
    instance (reference: src/operator/nn/softmax_activation.cc)."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1) \
        .reshape(data.shape)


class _RegressionFn(torch.autograd.Function):
    """``transform(data)`` forward; the backward ignores the head gradient
    and returns ``grad_fn(out, label) * grad_scale / (outputs per
    sample)`` (reference: ``_regression_output``,
    ``mxnet_tpu/ops/nn.py:598-618``)."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.cfg = (kind, grad_scale)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        kind, grad_scale = ctx.cfg
        diff = out - label.reshape(out.shape).to(out.dtype)
        if kind == "mae":
            diff = torch.sign(diff)
        per_sample = out.numel() // out.shape[0]
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return diff * grad_scale / per_sample, dlabel, None, None


@register("LinearRegressionOutput", arg_names=["data", "label"])
def LinearRegressionOutput(data, label, grad_scale=1.0):
    """L2 regression head: identity forward, ``data - label`` backward."""
    return _RegressionFn.apply(data, label, "linear", grad_scale)


@register("MAERegressionOutput", arg_names=["data", "label"])
def MAERegressionOutput(data, label, grad_scale=1.0):
    """L1 regression head: identity forward, ``sign(data - label)``
    backward."""
    return _RegressionFn.apply(data, label, "mae", grad_scale)


@register("LogisticRegressionOutput", arg_names=["data", "label"])
def LogisticRegressionOutput(data, label, grad_scale=1.0):
    """Logistic head: sigmoid forward, ``sigmoid(data) - label``
    backward."""
    return _RegressionFn.apply(data, label, "logistic", grad_scale)


class _MakeLossFn(torch.autograd.Function):
    """Identity forward; the backward is ``grad_scale`` everywhere,
    whatever the head gradient (reference: ``_make_loss_core``,
    ``mxnet_tpu/ops/nn.py:642``)."""

    @staticmethod
    def forward(ctx, data, scale):
        ctx.scale = scale
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.scale), None


@register("MakeLoss", aliases=("make_loss",))
def MakeLoss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """Marks ``data`` as a loss: its gradient is ``grad_scale`` (over the
    batch size under ``normalization="batch"``; reference:
    src/operator/make_loss.cc)."""
    scale = grad_scale
    if normalization == "batch":
        scale = grad_scale / data.shape[0]
    return _MakeLossFn.apply(data, scale)


class _SVMOutputFn(torch.autograd.Function):
    """Identity forward; the backward is the hinge (``use_linear``) or
    squared-hinge gradient of the scores against the label, times the
    regularization coefficient (reference: ``_svm_core``,
    ``mxnet_tpu/ops/nn.py:829``)."""

    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.cfg = (margin, reg, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.cfg
        lab = label.long()
        onehot = _one_hot_along(lab, data.shape[-1], -1, data.dtype)
        score_y = data.gather(-1, lab[:, None])
        m = data - score_y + margin
        if use_linear:
            viol = (m > 0).to(data.dtype) * (1 - onehot)
            grad = viol - onehot * viol.sum(-1, keepdim=True)
        else:
            grad = 2 * torch.clamp(m, min=0) * (1 - onehot)
            grad = grad - onehot * grad.sum(-1, keepdim=True)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return grad * reg, dlabel, None, None, None


@register("SVMOutput", arg_names=["data", "label"])
def SVMOutput(data, label, margin=1.0, regularization_coefficient=1.0,
              use_linear=False):
    """The SVM head: identity forward over the scores, the hinge gradient
    backward (reference: src/operator/svm_output.cc)."""
    return _SVMOutputFn.apply(data, label, margin,
                              regularization_coefficient, bool(use_linear))


@register("UpSampling", arg_names=["args"])
def UpSampling(*args, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=512):
    """Each input upsampled by ``scale``: nearest (each pixel repeated) or
    bilinear (half-pixel centres, as ``jax.image.resize``); several
    inputs concatenated on the channels or summed (reference:
    src/operator/upsampling.cc)."""
    s = int(scale)
    outs = []
    for data in args:
        if sample_type == "nearest":
            n, c, h, w = data.shape
            out = data[:, :, :, None, :, None].expand(
                n, c, h, s, w, s).reshape(n, c, h * s, w * s)
        else:
            out = TF.interpolate(data, scale_factor=s, mode="bilinear",
                                 align_corners=False)
        outs.append(out)
    if len(outs) == 1:
        return outs[0]
    if multi_input_mode == "sum":
        out = outs[0]
        for o in outs[1:]:
            out = out + o
        return out
    return torch.cat(outs, dim=1)


@register("Crop", arg_names=["args"])
def Crop(*args, num_args=1, offset=(0, 0), h_w=(0, 0), center_crop=False):
    """The ``h_w`` window (or the second input's spatial size) at
    ``offset``, or centred (reference: src/operator/crop.cc)."""
    data = args[0]
    if num_args == 2 or len(args) == 2:
        th, tw = args[1].shape[2], args[1].shape[3]
    else:
        th, tw = h_w
    if center_crop:
        oh, ow = (data.shape[2] - th) // 2, (data.shape[3] - tw) // 2
    else:
        oh, ow = offset
    return data[:, :, oh:oh + th, ow:ow + tw]


@register("GridGenerator", arg_names=["data"])
def GridGenerator(data, transform_type="affine", target_shape=(0, 0)):
    """The (N, 2, H, W) sampling grid in [-1, 1] coordinates (x, y): an
    affine map of the target's grid, or pixel offsets ``warp``ed into it
    (reference: src/operator/grid_generator.cc)."""
    if transform_type == "affine":
        n = data.shape[0]
        h, w = target_shape
        theta = data.reshape(n, 2, 3)
        ys = torch.linspace(-1, 1, h, device=data.device, dtype=data.dtype)
        xs = torch.linspace(-1, 1, w, device=data.device, dtype=data.dtype)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                            torch.ones_like(gx).reshape(-1)], dim=0)
        return torch.einsum("nij,jk->nik", theta, base).reshape(n, 2, h, w)
    if transform_type == "warp":
        n, _, h, w = data.shape
        gy, gx = torch.meshgrid(
            torch.arange(h, device=data.device, dtype=data.dtype),
            torch.arange(w, device=data.device, dtype=data.dtype),
            indexing="ij")
        x = (gx[None] + data[:, 0]) * 2.0 / max(w - 1, 1) - 1.0
        y = (gy[None] + data[:, 1]) * 2.0 / max(h - 1, 1) - 1.0
        return torch.stack([x, y], dim=1)
    raise ValueError("unknown transform_type %r" % transform_type)


def _bilinear_gather(data, x, y):
    """``data`` (N, C, H, W) sampled at pixel coordinates ``x``, ``y`` (N,
    Ho, Wo): the four neighbours' bilinear weights, a neighbour outside
    the image counting zero (the reference's ``_bilinear_gather``)."""
    n, c, h, w = data.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    batch = torch.arange(n, device=data.device)[:, None, None]
    out = 0
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        wgt = (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = torch.clamp(xi, 0, w - 1).long()
        yc = torch.clamp(yi, 0, h - 1).long()
        vals = data[batch, :, yc, xc]
        out = out + vals * (wgt * valid.to(wgt.dtype))[..., None]
    return out.movedim(-1, 1)


@register("BilinearSampler", arg_names=["data", "grid"])
def BilinearSampler(data, grid, cudnn_off=False):
    """``data`` sampled at ``grid`` (N, 2, Ho, Wo) of [-1, 1] coordinates,
    -1 and 1 the outer pixels' centres, zero outside (reference:
    src/operator/bilinear_sampler.cc)."""
    h, w = data.shape[2], data.shape[3]
    x = (grid[:, 0] + 1) * (w - 1) / 2.0
    y = (grid[:, 1] + 1) * (h - 1) / 2.0
    return _bilinear_gather(data, x, y)


@register("SpatialTransformer", arg_names=["data", "loc"])
def SpatialTransformer(data, loc, target_shape=(0, 0), transform_type="affine",
                       sampler_type="bilinear", cudnn_off=False):
    """An affine grid from ``loc``, then bilinear sampling (reference:
    src/operator/spatial_transformer.cc)."""
    return BilinearSampler(data, GridGenerator(loc, "affine", target_shape))


_ROI_SAMPLES = 4


@register("ROIPooling", arg_names=["data", "rois"])
def ROIPooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """Max over each bin of each ROI (``rois`` (R, 5): batch index, x1, y1,
    x2, y2).  The reference's formulation, kept to the bit: the ROI's
    corners scaled and rounded, then each bin max-pooled over a 4 x 4
    grid of samples at floored pixel positions (reference:
    ``mxnet_tpu/ops/nn.py:793``; src/operator/roi_pooling.cc)."""
    ph, pw = pooled_size
    ns = _ROI_SAMPLES
    bidx = rois[:, 0].long()
    x1 = torch.round(rois[:, 1] * spatial_scale)
    y1 = torch.round(rois[:, 2] * spatial_scale)
    x2 = torch.round(rois[:, 3] * spatial_scale)
    y2 = torch.round(rois[:, 4] * spatial_scale)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    sy = (torch.arange(ph * ns, device=data.device, dtype=rois.dtype) + 0.5)
    sx = (torch.arange(pw * ns, device=data.device, dtype=rois.dtype) + 0.5)
    iy = y1[:, None] + sy[None] * rh[:, None] / (ph * ns)
    ix = x1[:, None] + sx[None] * rw[:, None] / (pw * ns)
    yi = torch.clamp(torch.floor(iy), 0, data.shape[2] - 1).long()
    xi = torch.clamp(torch.floor(ix), 0, data.shape[3] - 1).long()
    patch = data[bidx[:, None, None], :, yi[:, :, None], xi[:, None, :]]
    r, c = patch.shape[0], patch.shape[-1]
    patch = patch.movedim(-1, 1).reshape(r, c, ph, ns, pw, ns)
    return patch.amax(dim=(3, 5))


@register("Correlation", arg_names=["data1", "data2"], num_outputs=2)
def Correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's correlation, as the reference computes it: for each
    displacement (dy, dx) in steps of ``stride2`` up to
    ``max_displacement``, the mean over channels of ``data1`` times (or
    the absolute difference from) ``data2`` shifted, with the zero-padded
    ``data2`` wrapping around (``jnp.roll``); the output is cropped to
    ``data1``'s size, and the second output is zeros like ``data1``
    (reference: ``mxnet_tpu/ops/nn.py:856``).  Where the padding covers
    the displacement nothing wraps, and each row of displacements is one
    batched product over a strided window of ``data2``."""
    n, c, h, w = data1.shape
    d, p, s2 = int(max_displacement), int(pad_size), int(stride2)
    b = TF.pad(data2, [p, p, p, p])
    steps = range(-d, d + 1, s2)
    outs = []
    if is_multiply and p >= d:
        span = w + steps[-1] - steps[0]
        for dy in steps:
            row = b.narrow(2, p + dy, h).narrow(3, p + steps[0], span)
            win = row.unfold(3, w, s2)              # (n, c, h, k, w)
            outs.append(torch.einsum("ncyx,ncykx->nkyx", data1, win) / c)
        return torch.cat(outs, dim=1), torch.zeros_like(data1)
    hp, wp = b.shape[2], b.shape[3]
    rows = torch.arange(p, p + h, device=data1.device)
    cols = torch.arange(p, p + w, device=data1.device)
    for dy in steps:
        by = b.index_select(2, torch.remainder(rows + dy, hp))
        for dx in steps:
            shifted = by.index_select(3, torch.remainder(cols + dx, wp))
            if is_multiply:
                outs.append(torch.mean(data1 * shifted, dim=1))
            else:
                outs.append(torch.mean(torch.abs(data1 - shifted), dim=1))
    return torch.stack(outs, dim=1), torch.zeros_like(data1)
