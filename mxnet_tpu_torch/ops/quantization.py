"""int8 quantization ops: the port of ``mxnet_tpu/ops/quantization.py``.

The ops keep the reference's ``(data, min, max)`` triple ABI, its
scale arithmetic and its rounding (``torch.round`` is round-half-even, as
``jnp.round`` is), so a graph calibrated by either package runs the same
integers in both.  Scalars take part as float32 tensors on the data's
device (:func:`_c`): they round as the reference's weak-typed scalars do,
and a division by one stays an IEEE division on the card (PyTorch turns
a division by a host scalar into a multiplication by its reciprocal).

The reference leaves its int8 convolutions and matmuls to XLA.  Here they
are :func:`int8_dot` (``torch._int_mm``, cuBLASLt's int8 GEMM, on the
card; an exact float64 matmul elsewhere) and :func:`int8_conv`, an
im2col of the channels-last input in front of it.  Both are exact:
integer sums of at most 2048 · 9 · 127² fit float64's 53 bits.

``MXTPU_INT8_FLOAT`` picks the float rail of ``dequantize`` and
``quantized_fc_pc`` (float32, bfloat16 or float16) and is read on every
call — the port runs eagerly, so a change takes effect at the next
forward, where the reference's jitted graphs keep the value they were
traced with.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as TF

from .nn import _CHANNELS_LAST, Pooling, _padded, _tup, full_pad
from .registry import register

__all__ = ["quantize", "quantize_v2", "dequantize", "requantize",
           "quantized_fully_connected", "quantized_conv",
           "quantized_pooling", "quantized_flatten", "quantized_fc_pc",
           "calib_minmax", "int8_dot", "int8_conv"]

_INT8_MAX = 127.0
_UINT8_MAX = 255.0
_INT32_MAX = 2.0 ** 31 - 1
_F32 = torch.float32
_INT8_FLOAT_CHOICES = ("float32", "bfloat16", "float16")


def _int8_float_env():
    """The MXTPU_INT8_FLOAT float-rail dtype, validated at each read."""
    v = os.environ.get("MXTPU_INT8_FLOAT", "float32")
    if v not in _INT8_FLOAT_CHOICES:
        raise ValueError("MXTPU_INT8_FLOAT=%r invalid; choose one of %s"
                         % (v, ", ".join(_INT8_FLOAT_CHOICES)))
    return v


def _c(value, like):
    """``value`` as a float32 0-d tensor on ``like``'s device (a fill on
    the device: no host copy, no sync)."""
    return torch.full((), float(value), dtype=_F32, device=like.device)


def _amax(lo, hi):
    return torch.maximum(lo.reshape(()).abs(), hi.reshape(()).abs())


def _over(num, den):
    """``where(den > 0, num / where(den > 0, den, 1), 0)`` in float32."""
    pos = den > 0
    safe = torch.where(pos, den, _c(1.0, den))
    return torch.where(pos, torch.div(_c(num, den), safe), _c(0.0, den))


# ---------------------------------------------------------------------------
# exact int8 GEMM and convolution (the reference's XLA int8 dot / conv)
# ---------------------------------------------------------------------------
def _round_up(v, m):
    return -(-v // m) * m


def int8_dot(a, b):
    """Exact int32 ``a @ b.T`` of int8 ``a`` (M, K) and ``b`` (N, K).

    On the card: ``torch._int_mm`` with the operands zero-padded to what
    it takes (M > 16, K and N multiples of 8), ``b`` passed as its
    column-major transpose.  Elsewhere: a float64 matmul, exact for these
    sums."""
    m, k = a.shape
    n = b.shape[0]
    if a.device.type != "cuda":
        return (a.to(torch.float64) @ b.to(torch.float64).t()).to(torch.int32)
    kp, np_, mp = _round_up(k, 8), _round_up(n, 8), max(m, 17)
    if kp != k:
        a = TF.pad(a, (0, kp - k))
        b = TF.pad(b, (0, kp - k))
    if np_ != n:
        b = TF.pad(b, (0, 0, 0, np_ - n))
    if mp != m:
        a = TF.pad(a, (0, 0, 0, mp - m))
    out = torch._int_mm(a.contiguous(), b.contiguous().t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def _as_nhwc(x, w, layout):
    if layout in _CHANNELS_LAST:
        return x, w
    return x.movedim(1, -1), w.movedim(1, -1)


def int8_conv(x, w, kernel=(), stride=(), dilate=(), pad=(), num_group=1,
              layout=None):
    """Exact int32 2-D convolution of int8 ``x`` by int8 ``w`` in either
    layout (``NHWC``/``OHWI`` or ``NCHW``/``OIHW``), as an im2col of the
    channels-last input (columns ordered (kh, kw, C) like ``OHWI``)
    followed by :func:`int8_dot`."""
    nsp = len(kernel) if kernel else x.dim() - 2
    if nsp != 2 or int(num_group) != 1:
        raise NotImplementedError(
            "int8 convolution takes 2-D, ungrouped kernels so far (got %d "
            "spatial dims, num_group=%s): ROADMAP.md queue A, item 11"
            % (nsp, num_group))
    stride = _tup(stride, 2) if stride else (1, 1)
    dilate = _tup(dilate, 2) if dilate else (1, 1)
    pad = _tup(pad, 2) if pad else (0, 0)
    x, w = _as_nhwc(x, w, layout)
    n, h, wd, c = x.shape
    o, kh, kw = w.shape[:3]
    if (kh, kw, pad) == (1, 1, (0, 0)):
        cols = x[:, ::stride[0], ::stride[1], :]
        ho, wo = cols.shape[1:3]
    else:
        xp = TF.pad(x, (0, 0, pad[1], pad[1], pad[0], pad[0]))
        ho = (h + 2 * pad[0] - dilate[0] * (kh - 1) - 1) // stride[0] + 1
        wo = (wd + 2 * pad[1] - dilate[1] * (kw - 1) - 1) // stride[1] + 1
        taps = [xp[:, i * dilate[0]:i * dilate[0] + (ho - 1) * stride[0] + 1:
                   stride[0],
                   j * dilate[1]:j * dilate[1] + (wo - 1) * stride[1] + 1:
                   stride[1], :]
                for i in range(kh) for j in range(kw)]
        cols = torch.cat(taps, dim=-1)
    acc = int8_dot(cols.reshape(-1, kh * kw * c), w.reshape(o, -1))
    acc = acc.reshape(n, ho, wo, o)
    return acc if layout in _CHANNELS_LAST else acc.movedim(-1, 1)


# ---------------------------------------------------------------------------
# quantize / dequantize / requantize
# ---------------------------------------------------------------------------
@register("_contrib_quantize", arg_names=["data", "min_range", "max_range"],
          num_outputs=3, aliases=("quantize",))
def quantize(data, min_range, max_range, out_type="uint8"):
    """Affine quantize to (u)int8 with an explicit range (reference:
    quantization/quantize.cc); a degenerate range quantizes to code 0."""
    mn = min_range.reshape(())
    mx = max_range.reshape(())
    if out_type == "uint8":
        scale = _over(_UINT8_MAX, mx - mn)
        q = torch.round((data - mn) * scale).clamp(0, 255).to(torch.uint8)
    else:
        scale = _over(_INT8_MAX, _amax(mn, mx))
        q = torch.round(data * scale).clamp(-127, 127).to(torch.int8)
    return q, mn.reshape(1), mx.reshape(1)


@register("_contrib_quantize_v2", arg_names=["data"], num_outputs=3,
          aliases=("quantize_v2",))
def quantize_v2(data, out_type="int8", min_calib_range=None,
                max_calib_range=None):
    """Quantize with the calibrated range, or the data's own min/max
    (reference: quantize_v2.cc)."""
    if min_calib_range is not None:
        mn = _c(min_calib_range, data)
        mx = _c(max_calib_range, data)
    else:
        mn = data.min().to(_F32)
        mx = data.max().to(_F32)
    return quantize(data, mn.reshape(1), mx.reshape(1), out_type=out_type)


@register("_contrib_dequantize", arg_names=["data", "min_range", "max_range"],
          aliases=("dequantize",))
def dequantize(data, min_range, max_range, out_type="float32"):
    """Back to the float rail (``MXTPU_INT8_FLOAT`` when ``out_type`` is
    the float32 default); an int32 accumulator maps its range onto
    ``2**31 - 1``."""
    fdt = getattr(torch, _int8_float_env() if out_type == "float32"
                  else out_type)
    mn = min_range.reshape(())
    mx = max_range.reshape(())
    if data.dtype == torch.uint8:
        scale = torch.div(mx - mn, _c(_UINT8_MAX, mn))
        return (data.to(_F32) * scale + mn).to(fdt)
    amax = _amax(mn, mx)
    top = _INT32_MAX if data.dtype == torch.int32 else _INT8_MAX
    return (data.to(_F32) * torch.div(amax, _c(top, amax))).to(fdt)


@register("_contrib_requantize",
          arg_names=["data", "min_range", "max_range"], num_outputs=3,
          aliases=("requantize",))
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None, out_type="int8"):
    """int32 accumulator -> int8 at the calibrated range (reference:
    requantize.cc)."""
    real = data.to(_F32) * torch.div(_amax(min_range, max_range),
                                     _c(_INT32_MAX, data))
    if min_calib_range is not None:
        mn = _c(min_calib_range, data)
        mx = _c(max_calib_range, data)
    else:
        mn = real.min()
        mx = real.max()
    scale = _over(_INT8_MAX, _amax(mn, mx))
    q = torch.round(real * scale).clamp(-127, 127).to(torch.int8)
    return q, mn.reshape(1), mx.reshape(1)


# ---------------------------------------------------------------------------
# quantized FC / conv / pooling / flatten
# ---------------------------------------------------------------------------
def _acc_range(acc, min_data, max_data, min_weight, max_weight, bias,
               min_bias, max_bias, no_bias, bshape):
    """The reference's int32 epilogue: the rounded bias in accumulator
    units and the ``(-out_max, out_max)`` range of the accumulator."""
    c127 = _c(_INT8_MAX, acc)
    out_scale = torch.div(_amax(min_data, max_data), c127) \
        * torch.div(_amax(min_weight, max_weight), c127)
    if bias is not None and not no_bias:
        b_real = bias.to(_F32) * torch.div(_amax(min_bias, max_bias), c127)
        acc = acc + torch.round(torch.div(b_real, out_scale)) \
            .to(torch.int32).reshape(bshape)
    out_max = out_scale * _c(_INT32_MAX, acc)
    return acc, -out_max.reshape(1), out_max.reshape(1)


def _qfc_optional(params):
    if params.get("no_bias", False):
        return ("bias", "min_bias", "max_bias")
    return ()


@register("_contrib_quantized_fully_connected",
          arg_names=["data", "weight", "min_data", "max_data",
                     "min_weight", "max_weight", "bias", "min_bias",
                     "max_bias"],
          num_outputs=3, aliases=("quantized_fully_connected",),
          optional_args=_qfc_optional)
def quantized_fully_connected(data, weight, min_data, max_data,
                              min_weight, max_weight, bias=None,
                              min_bias=None, max_bias=None,
                              num_hidden=0, no_bias=False, flatten=True):
    """int8 x int8 -> int32 FC (reference: quantized_fully_connected.cc)."""
    x = data.to(torch.int8)
    if flatten:
        x = x.reshape(x.shape[0], -1)
    lead = x.shape[:-1]
    acc = int8_dot(x.reshape(-1, x.shape[-1]), weight.to(torch.int8))
    acc = acc.reshape(lead + acc.shape[-1:])
    return _acc_range(acc, min_data, max_data, min_weight, max_weight, bias,
                      min_bias, max_bias, no_bias, (-1,))


def _qconv_optional(params):
    if params.get("no_bias", True):
        return ("bias", "min_bias", "max_bias")
    return ()


@register("_contrib_quantized_conv",
          arg_names=["data", "weight", "min_data", "max_data",
                     "min_weight", "max_weight", "bias", "min_bias",
                     "max_bias"],
          num_outputs=3, aliases=("quantized_conv",),
          optional_args=_qconv_optional)
def quantized_conv(data, weight, min_data, max_data, min_weight, max_weight,
                   bias=None, min_bias=None, max_bias=None, kernel=(),
                   stride=(), dilate=(), pad=(), num_filter=0, num_group=1,
                   no_bias=True, layout=None, workspace=1024,
                   cudnn_tune=None, cudnn_off=False):
    """int8 x int8 -> int32 convolution (reference: quantized_conv.cu);
    the output carries the int32 domain's range like the reference."""
    acc = int8_conv(data.to(torch.int8), weight.to(torch.int8), kernel,
                    stride, dilate, pad, num_group, layout)
    nsp = acc.dim() - 2
    bshape = (1,) * (nsp + 1) + (-1,) if layout in _CHANNELS_LAST \
        else (1, -1) + (1,) * nsp
    return _acc_range(acc, min_data, max_data, min_weight, max_weight, bias,
                      min_bias, max_bias, no_bias, bshape)


@register("_contrib_quantized_pooling",
          arg_names=["data", "min_data", "max_data"], num_outputs=3,
          aliases=("quantized_pooling",))
def quantized_pooling(data, min_data, max_data, kernel=(), pool_type="max",
                      global_pool=False, pooling_convention="valid",
                      stride=(), pad=(), count_include_pad=True,
                      layout=None, cudnn_off=False):
    """Pooling on int8 tensors (reference: quantized_pooling.cc): max pool
    compares the codes (through float32, exact for int8); avg pool sums
    exactly and rounds the mean back.  The range passes through.  A
    ``"full"`` window wholly in the padding gives the type's minimum, as
    the reference's integer max does."""
    if pool_type == "max":
        out = Pooling(data.to(_F32), kernel=kernel, pool_type="max",
                      global_pool=global_pool,
                      pooling_convention=pooling_convention, stride=stride,
                      pad=pad, layout=layout)
        out = out.clamp_min(torch.iinfo(data.dtype).min).to(data.dtype)
        return out, min_data.reshape(1), max_data.reshape(1)
    x = data.to(torch.float64)
    if layout in _CHANNELS_LAST:
        x = x.movedim(-1, 1)
    nsp = x.dim() - 2
    if global_pool:
        dims = tuple(range(2, 2 + nsp))
        acc = x.sum(dim=dims, keepdim=True)
        denom = int(np.prod(x.shape[2:]))
    else:
        if nsp not in (2, 3):
            raise NotImplementedError(
                "int8 %d-D windowed avg pooling: ROADMAP.md queue A, item 11"
                % nsp)
        kernel = _tup(kernel, nsp)
        stride = _tup(stride, nsp) if stride else (1,) * nsp
        pad = _tup(pad, nsp) if pad else (0,) * nsp
        extra = full_pad(x.shape[2:], kernel, stride, pad) \
            if pooling_convention == "full" else [0] * nsp
        pool = TF.avg_pool2d if nsp == 2 else TF.avg_pool3d
        # divisor 1: the window sums (zeros padded, the reference's "full"
        # shortfall on the high side), exact in float64
        acc = pool(_padded(x, pad, extra, 0.0), kernel, stride,
                   divisor_override=1)
        denom = int(np.prod(kernel))
    if layout in _CHANNELS_LAST:
        acc = acc.movedim(1, -1)
    acc = acc.to(torch.int32).to(_F32)
    out = torch.round(torch.div(acc, _c(denom, acc))).clamp(-127, 127)
    return out.to(data.dtype), min_data.reshape(1), max_data.reshape(1)


@register("_contrib_quantized_flatten",
          arg_names=["data", "min_data", "max_data"], num_outputs=3,
          aliases=("quantized_flatten",))
def quantized_flatten(data, min_data, max_data):
    """Flatten on the int8 tensor; the range rides through (reference:
    src/operator/quantization/quantized_flatten.cc:31)."""
    return (data.reshape(data.shape[0], -1), min_data.reshape(1),
            max_data.reshape(1))


def _qfcpc_optional(params):
    if params.get("no_bias", False):
        return ("bias",)
    return ()


@register("_contrib_quantized_fc_pc",
          arg_names=["data", "weight", "w_scale", "bias"],
          aliases=("quantized_fc_pc",), optional_args=_qfcpc_optional)
def quantized_fc_pc(data, weight, w_scale, bias=None, num_hidden=0,
                    in_amax=1.0, relu=False, no_bias=False, flatten=True):
    """Per-channel int8 FC with the dequantize epilogue: the float input is
    quantized against the calibrated ``in_amax``, the int8 weight codes
    carry one scale per output channel, and the output stays on the float
    rail (reference: ``quantized_fc_pc``)."""
    in_scale = float(in_amax) / _INT8_MAX
    if in_scale <= 0.0:
        in_scale = 1.0 / _INT8_MAX
    x = data.reshape(data.shape[0], -1) if flatten else data
    codes = torch.round(torch.div(x.to(_F32), _c(in_scale, x))) \
        .clamp(-127, 127).to(torch.int8)
    acc = int8_dot(codes, weight.to(torch.int8))
    out = acc.to(_F32) * (_c(in_scale, acc) * w_scale.to(_F32))[None, :]
    if bias is not None and not no_bias:
        out = out + bias.to(_F32)[None, :]
    if relu:
        out = torch.clamp_min(out, 0.0)
    return out.to(getattr(torch, _int8_float_env()))


def calib_minmax(arrays):
    """Min/max calibration over representative activations (reference:
    contrib/quantization.py _collect_layer_output_min_max)."""
    def host(a):
        return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)
    return (min(float(np.min(host(a))) for a in arrays),
            max(float(np.max(host(a))) for a in arrays))
