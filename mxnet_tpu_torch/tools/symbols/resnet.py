"""Symbolic ResNet, the port of
``examples/image_classification/symbols/resnet.py``: the pre-activation
(v2) networks of 18-152 layers, node for node and name for name the
reference's (a ``bn_data`` BatchNorm with ``fix_gamma=True`` on the
input; at 32 pixels or fewer a 3x3 stem without pooling, else 7x7 / 2
with a max pool), ending in ``SoftmaxOutput`` named ``softmax``.
``get_symbol(num_classes, num_layers, "c,h,w")`` is the training
scripts' entry.
"""
from __future__ import annotations

from ... import symbol as sym

__all__ = ["residual_unit", "resnet", "get_symbol"]


def residual_unit(data, num_filter, stride, dim_match, name,
                  bottle_neck=True, bn_mom=0.9):
    if bottle_neck:
        bn1 = sym.BatchNorm(data, momentum=bn_mom, eps=2e-5,
                            name=name + "_bn1")
        act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
        conv1 = sym.Convolution(act1, num_filter=num_filter // 4,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, momentum=bn_mom, eps=2e-5,
                            name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(act2, num_filter=num_filter // 4,
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        bn3 = sym.BatchNorm(conv2, momentum=bn_mom, eps=2e-5,
                            name=name + "_bn3")
        act3 = sym.Activation(bn3, act_type="relu", name=name + "_relu3")
        conv3 = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1),
                                stride=(1, 1), pad=(0, 0), no_bias=True,
                                name=name + "_conv3")
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(act1, num_filter=num_filter,
                                       kernel=(1, 1), stride=stride,
                                       no_bias=True, name=name + "_sc")
        return conv3 + shortcut
    bn1 = sym.BatchNorm(data, momentum=bn_mom, eps=2e-5, name=name + "_bn1")
    act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                            stride=stride, pad=(1, 1), no_bias=True,
                            name=name + "_conv1")
    bn2 = sym.BatchNorm(conv1, momentum=bn_mom, eps=2e-5, name=name + "_bn2")
    act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
    conv2 = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3),
                            stride=(1, 1), pad=(1, 1), no_bias=True,
                            name=name + "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(act1, num_filter=num_filter,
                                   kernel=(1, 1), stride=stride,
                                   no_bias=True, name=name + "_sc")
    return conv2 + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, bn_mom=0.9):
    data = sym.Variable("data")
    data = sym.BatchNorm(data, fix_gamma=True, eps=2e-5, momentum=bn_mom,
                         name="bn_data")
    (_, height, _) = image_shape
    if height <= 32:
        body = sym.Convolution(data, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, name="conv0")
    else:
        body = sym.Convolution(data, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, name="conv0")
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, name="bn0")
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max")
    for i in range(num_stages):
        stride = (1, 1) if i == 0 else (2, 2)
        body = residual_unit(body, filter_list[i + 1], stride, False,
                             name="stage%d_unit1" % (i + 1),
                             bottle_neck=bottle_neck, bn_mom=bn_mom)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name="stage%d_unit%d" % (i + 1, j + 2),
                                 bottle_neck=bottle_neck, bn_mom=bn_mom)
    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name="bn1")
    relu1 = sym.Activation(bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
    flat = sym.Flatten(pool1)
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc1, name="softmax")


_CONFIGS = {
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
}


def get_symbol(num_classes, num_layers, image_shape, **kwargs):
    """``get_symbol(num_classes, num_layers, "c,h,w")``, the training
    scripts' contract."""
    if isinstance(image_shape, str):
        image_shape = tuple(int(x) for x in image_shape.split(","))
    units, bottle_neck = _CONFIGS[num_layers]
    filter_list = [64, 256, 512, 1024, 2048] if bottle_neck \
        else [64, 64, 128, 256, 512]
    return resnet(units, 4, filter_list, num_classes, image_shape,
                  bottle_neck=bottle_neck)
