"""Inception v3: the port of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``.  The final 8 x 8
average pool fixes the input at 299 x 299."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ...nn import HybridConcurrent

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    setting_names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        kwargs = {}
        for i, value in enumerate(setting):
            if value is not None:
                kwargs[setting_names[i]] = value
        out.add(_make_basic_conv(**kwargs))
    return out


def _make_A(pool_features, prefix):
    out = HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (64, 1, None, None)))
        out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2)))
        out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, None, 1)))
        out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B(prefix):
    out = HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (384, 3, 2, None)))
        out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7, prefix):
    out = HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None)))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0))))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (192, (1, 7), None, (0, 3))))
        out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D(prefix):
    out = HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None), (320, 3, 2, None)))
        out.add(_make_branch(None, (192, 1, None, None),
                             (192, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0)),
                             (192, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


class _InceptionE(HybridBlock):
    """Block E needs in-branch fan-out (1x3 + 3x1 concat inside a branch)."""

    def __init__(self, prefix):
        super().__init__(prefix=prefix)
        with self.name_scope():
            self.branch1 = _make_branch(None, (320, 1, None, None))
            self.branch2_stem = _make_basic_conv(channels=384, kernel_size=1)
            self.branch2_a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                              padding=(0, 1))
            self.branch2_b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                              padding=(1, 0))
            self.branch3_stem = nn.HybridSequential(prefix="")
            self.branch3_stem.add(
                _make_basic_conv(channels=448, kernel_size=1))
            self.branch3_stem.add(
                _make_basic_conv(channels=384, kernel_size=3, padding=1))
            self.branch3_a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                              padding=(0, 1))
            self.branch3_b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                              padding=(1, 0))
            self.branch4 = _make_branch("avg", (192, 1, None, None))

    def hybrid_forward(self, F, x):
        b1 = self.branch1(x)
        b2 = self.branch2_stem(x)
        b2 = F.concat(self.branch2_a(b2), self.branch2_b(b2), dim=1)
        b3 = self.branch3_stem(x)
        b3 = F.concat(self.branch3_a(b3), self.branch3_b(b3), dim=1)
        b4 = self.branch4(x)
        return F.concat(b1, b2, b3, b4, dim=1)


def _make_E(prefix):
    return _InceptionE(prefix)


def make_aux(classes):
    out = nn.HybridSequential(prefix="")
    out.add(nn.AvgPool2D(pool_size=5, strides=3))
    out.add(_make_basic_conv(channels=128, kernel_size=1))
    out.add(_make_basic_conv(channels=768, kernel_size=5))
    out.add(nn.Flatten())
    out.add(nn.Dense(classes))
    return out


class Inception3(HybridBlock):
    r"""Inception v3 (Szegedy 2015)."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               strides=2))
            self.features.add(_make_basic_conv(channels=32, kernel_size=3))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80, kernel_size=1))
            self.features.add(_make_basic_conv(channels=192, kernel_size=3))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_make_E("E1_"))
            self.features.add(_make_E("E2_"))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    net = Inception3(**kwargs)
    if pretrained:
        from ..model_store import get_model_file
        net.load_parameters(get_model_file("inceptionv3", root=root), ctx=ctx)
    return net
