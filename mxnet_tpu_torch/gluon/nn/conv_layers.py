"""Gluon convolution and pooling layers: the port of
``mxnet_tpu/gluon/nn/conv_layers.py`` (``Conv2D``, ``MaxPool2D``,
``AvgPool2D``, ``GlobalAvgPool2D``), channels-first: ``NCHW`` data and
``OIHW`` weights (``conv_layers.py:38-40``).  ``layout="NHWC"`` raises
``NotImplementedError`` (ROADMAP.md queue A, item 1), as do the 1-D/3-D
and transposed layers, which are not ported yet."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D"]


def _pair(x, n):
    if isinstance(x, int):
        return (x,) * n
    return tuple(x)


def _check_layout(layout):
    if layout != "NCHW":
        raise NotImplementedError(
            "layout=%r: the port runs NCHW only so far; NHWC is ROADMAP.md "
            "queue A, item 1" % (layout,))


class Conv2D(HybridBlock):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None):
        _check_layout(layout)
        super().__init__(prefix=prefix, params=params)
        kernel_size = _pair(kernel_size, 2)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            self._kernel = kernel_size
            self._kwargs = {
                "kernel": kernel_size, "stride": _pair(strides, 2),
                "dilate": _pair(dilation, 2), "pad": _pair(padding, 2),
                "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout,
            }
            wshape = (channels, in_channels // max(groups, 1) if in_channels
                      else 0) + kernel_size
            self.weight = self.params.get("weight", shape=wshape,
                                          init=weight_initializer,
                                          allow_deferred_init=True)
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

    def infer_param_shapes(self, x, *args):
        if self.weight._deferred_init:
            g = self._kwargs["num_group"]
            self.weight.shape = (self._channels, x.shape[1] // g) \
                + self._kernel

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", count_include_pad=None,
                 layout="NCHW", **kwargs):
        _check_layout(layout)
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
            "layout": layout,
        }
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size, 2),
                         _pair(strides, 2) if strides is not None else None,
                         _pair(padding, 2), ceil_mode, layout=layout,
                         **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_pair(pool_size, 2),
                         _pair(strides, 2) if strides is not None else None,
                         _pair(padding, 2), ceil_mode, pool_type="avg",
                         count_include_pad=count_include_pad, layout=layout,
                         **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg",
                         layout=layout, **kwargs)
