"""Gluon convolution, pooling and padding layers: the port of
``mxnet_tpu/gluon/nn/conv_layers.py``.

Every layout of the reference: channels-first (``NCW`` / ``NCHW`` /
``NCDHW`` data, ``(O, I/g, *k)`` weights) and channels-last (``NWC`` /
``NHWC`` / ``NDHWC`` data, ``(O, *k, I/g)`` weights, deferred
``in_channels`` read from the data's last axis).  Transposed layers keep
the ``(I, O/g, *k)`` weight in every layout (``:32-40``) and map
``output_padding`` onto the op's ``adj``.  The ops run channels-last data
as channels-first views of the same memory (``ops/nn.py``), so a
contiguous NHWC tensor reaches cuDNN with ``torch.channels_last``
strides and no copy.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]

_CHANNELS_LAST = ("NWC", "NHWC", "NDHWC")


def _pair(x, n):
    if isinstance(x, int):
        return (x,) * n
    return tuple(x)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            self._kernel = tuple(kernel_size)
            self._op_name = op_name
            self._kwargs = {
                "kernel": kernel_size, "stride": strides, "dilate": dilation,
                "pad": padding, "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout,
            }
            if adj is not None:
                self._kwargs["adj"] = adj
            self._channels_last = layout in _CHANNELS_LAST
            self.weight = self.params.get(
                "weight", shape=self._weight_shape(in_channels),
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer,
                                            allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                from .basic_layers import Activation
                self.act = Activation(activation, prefix=activation + "_")
                self.register_child(self.act, "act")
            else:
                self.act = None

    def _weight_shape(self, in_c):
        g = self._kwargs["num_group"]
        if self._op_name == "Deconvolution":
            return (in_c, self._channels // g) + self._kernel
        per_group = in_c // max(g, 1) if in_c else 0
        if self._channels_last:
            return (self._channels,) + self._kernel + (per_group,)
        return (self._channels, per_group) + self._kernel

    def infer_param_shapes(self, x, *args):
        if self.weight._deferred_init:
            self.weight.shape = self._weight_shape(
                x.shape[-1] if self._channels_last else x.shape[1])

    def hybrid_forward(self, F, x, weight, bias=None):
        out = getattr(F, self._op_name)(x, weight, bias, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 1), _pair(strides, 1),
                         _pair(padding, 1), _pair(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 2), _pair(strides, 2),
                         _pair(padding, 2), _pair(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 3), _pair(strides, 3),
                         _pair(padding, 3), _pair(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 1), _pair(strides, 1),
                         _pair(padding, 1), _pair(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_pair(output_padding, 1), **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 2), _pair(strides, 2),
                         _pair(padding, 2), _pair(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_pair(output_padding, 2), **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 3), _pair(strides, 3),
                         _pair(padding, 3), _pair(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_pair(output_padding, 3), **kwargs)


class _Pooling(HybridBlock):
    """``ceil_mode=True`` is the reference's ``pooling_convention="full"``
    (``ops.nn.Pooling``: the shortfall padded on the high side), not
    torch's ``ceil_mode``, whose last window may not start in the padding
    and whose avg divides by the in-bounds part of it."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", count_include_pad=None,
                 layout=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
        }
        if layout is not None:
            self._kwargs["layout"] = layout
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


def _window(n, pool_size, strides, padding):
    return (_pair(pool_size, n),
            _pair(strides, n) if strides is not None else None,
            _pair(padding, n))


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(*_window(1, pool_size, strides, padding), ceil_mode,
                         layout=layout, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(*_window(2, pool_size, strides, padding), ceil_mode,
                         layout=layout, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(*_window(3, pool_size, strides, padding), ceil_mode,
                         layout=layout, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(*_window(1, pool_size, strides, padding), ceil_mode,
                         pool_type="avg", count_include_pad=count_include_pad,
                         layout=layout, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(*_window(2, pool_size, strides, padding), ceil_mode,
                         pool_type="avg", count_include_pad=count_include_pad,
                         layout=layout, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(*_window(3, pool_size, strides, padding), ceil_mode,
                         pool_type="avg", count_include_pad=count_include_pad,
                         layout=layout, **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "max", layout=layout,
                         **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "max",
                         layout=layout, **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "max",
                         layout=layout, **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "avg", layout=layout,
                         **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg",
                         layout=layout, **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "avg",
                         layout=layout, **kwargs)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of the two spatial axes of NCHW data; an int
    pads all four sides (``pad_width`` as the op takes it otherwise)."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)
