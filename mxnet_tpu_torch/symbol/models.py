"""Symbolic model builders: the port of ``mxnet_tpu/symbol/models.py``.

ResNet v1 as a Symbol graph (reference:
example/image-classification/symbols/resnet.py), node for node and name
for name the reference's, so both packages build the same JSON.
"""
from __future__ import annotations

__all__ = ["resnet_symbol"]


def _sym():
    from .. import symbol
    return symbol


_SPEC = {
    18: ("basic", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottleneck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottleneck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottleneck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}


def _conv_bn_act(sym, data, channels, kernel, stride, pad, name, act=True,
                 layout="NCHW"):
    out = sym.Convolution(data, kernel=kernel, stride=stride, pad=pad,
                          num_filter=channels, no_bias=True, layout=layout,
                          name=name + "_conv")
    out = sym.BatchNorm(out, fix_gamma=False, name=name + "_bn",
                        axis=3 if layout == "NHWC" else 1)
    if act:
        out = sym.Activation(out, act_type="relu", name=name + "_relu")
    return out


def _basic_block(sym, data, channels, stride, downsample, name,
                 layout="NCHW"):
    body = _conv_bn_act(sym, data, channels, (3, 3), (stride, stride),
                        (1, 1), name + "_a", layout=layout)
    body = _conv_bn_act(sym, body, channels, (3, 3), (1, 1), (1, 1),
                        name + "_b", act=False, layout=layout)
    shortcut = data
    if downsample:
        shortcut = _conv_bn_act(sym, data, channels, (1, 1),
                                (stride, stride), (0, 0), name + "_down",
                                act=False, layout=layout)
    return sym.Activation(body + shortcut, act_type="relu",
                          name=name + "_out")


def _bottleneck_block(sym, data, channels, stride, downsample, name,
                      layout="NCHW"):
    mid = channels // 4
    body = _conv_bn_act(sym, data, mid, (1, 1), (stride, stride), (0, 0),
                        name + "_a", layout=layout)
    body = _conv_bn_act(sym, body, mid, (3, 3), (1, 1), (1, 1), name + "_b",
                        layout=layout)
    body = _conv_bn_act(sym, body, channels, (1, 1), (1, 1), (0, 0),
                        name + "_c", act=False, layout=layout)
    shortcut = data
    if downsample:
        shortcut = _conv_bn_act(sym, data, channels, (1, 1),
                                (stride, stride), (0, 0), name + "_down",
                                act=False, layout=layout)
    return sym.Activation(body + shortcut, act_type="relu",
                          name=name + "_out")


def resnet_symbol(num_layers=50, num_classes=1000, thumbnail=False,
                  layout="NCHW"):
    """ResNet v1 as a Symbol graph; ``layout="NHWC"`` emits the
    channels-last graph with OHWI weights."""
    sym = _sym()
    if num_layers not in _SPEC:
        raise ValueError("unsupported depth %r" % (num_layers,))
    kind, layers, channels = _SPEC[num_layers]
    block = _basic_block if kind == "basic" else _bottleneck_block

    data = sym.Variable("data")
    if thumbnail:
        body = sym.Convolution(data, kernel=(3, 3), stride=(1, 1),
                               pad=(1, 1), num_filter=channels[0],
                               no_bias=True, layout=layout,
                               name="stem_conv")
    else:
        body = _conv_bn_act(sym, data, channels[0], (7, 7), (2, 2), (3, 3),
                            "stem", layout=layout)
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max", layout=layout, name="stem_pool")
    in_c = channels[0]
    for i, n in enumerate(layers):
        stride = 1 if i == 0 else 2
        body = block(sym, body, channels[i + 1], stride,
                     channels[i + 1] != in_c, "stage%d_unit1" % (i + 1),
                     layout=layout)
        for j in range(n - 1):
            body = block(sym, body, channels[i + 1], 1, False,
                         "stage%d_unit%d" % (i + 1, j + 2), layout=layout)
        in_c = channels[i + 1]
    pool = sym.Pooling(body, global_pool=True, pool_type="avg",
                       layout=layout, name="global_pool")
    flat = sym.Flatten(pool, name="flatten")
    fc = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc, name="softmax")
