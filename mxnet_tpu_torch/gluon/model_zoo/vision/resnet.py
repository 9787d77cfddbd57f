"""ResNet v1: the port of ``ResNetV1``, ``BasicBlockV1``, ``BottleneckV1``
and ``resnet18/34/50_v1`` from
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``.

The structure, and with it every module and parameter name, is the
reference's — including what differs from torchvision's ResNet: the
first conv and the two 1×1 convs of every ``BottleneckV1`` body have
``in_channels=0`` (initialized at the first forward) and those 1×1 body
convs carry a bias (``Conv2D`` defaults to ``use_bias=True``).
ResNet v2 and the deeper depths are ROADMAP.md queue A, item 1.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["ResNetV1", "BasicBlockV1", "BottleneckV1", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "get_resnet"]


def _conv3x3(channels, stride, in_channels, layout="NCHW"):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, layout=layout)


def _bn(layout="NCHW", **kwargs):
    return nn.BatchNorm(axis=-1 if layout == "NHWC" else 1, **kwargs)


class BasicBlockV1(HybridBlock):
    r"""BasicBlock from ResNet v1 (18/34-layer)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, layout))
        self.body.add(_bn(layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout))
        self.body.add(_bn(layout))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(_bn(layout))
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return F.Activation(residual + x, act_type="relu")


class BottleneckV1(HybridBlock):
    r"""Bottleneck from ResNet v1 (50/101/152-layer)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride,
                                layout=layout))
        self.body.add(_bn(layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4, layout))
        self.body.add(_bn(layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                layout=layout))
        self.body.add(_bn(layout))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(_bn(layout))
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class ResNetV1(HybridBlock):
    r"""ResNet v1 model (reference vision/resnet.py ResNetV1)."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        self._layout = layout
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, layout))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False, layout=layout))
                self.features.add(_bn(layout))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i]))
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0):
        layer = nn.HybridSequential(prefix="stage%d_" % stage_index)
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, layout=self._layout,
                            prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                layout=self._layout, prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


# depth -> (block-kind, per-stage layer counts, per-stage channels)
resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
}
resnet_block_versions = {"basic_block": BasicBlockV1,
                         "bottle_neck": BottleneckV1}


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    if version != 1:
        raise NotImplementedError("ResNet v%d is not ported yet (ROADMAP.md "
                                  "queue A, item 1)" % version)
    if num_layers not in resnet_spec:
        raise NotImplementedError(
            "resnet%d_v1 is not ported yet (ROADMAP.md queue A, item 1); "
            "ported depths: %s" % (num_layers, sorted(resnet_spec)))
    if pretrained:
        raise NotImplementedError("pretrained weights: the port has no "
                                  "model store; carry weights over with "
                                  "gluon.utils.from_jax_params")
    block_type, layers, channels = resnet_spec[num_layers]
    return ResNetV1(resnet_block_versions[block_type], layers, channels,
                    **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)
