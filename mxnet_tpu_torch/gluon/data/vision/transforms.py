"""Vision transforms: the port of
``mxnet_tpu/gluon/data/vision/transforms.py`` (reference:
python/mxnet/gluon/data/vision/transforms.py).

Transforms are Blocks operating per-sample on HWC uint8/float NDArrays or
numpy arrays, in numpy and OpenCV on the host (``image/image.py``); an
output NDArray lives on its input's device, the CPU for a host input, so
a transform in a ``DataLoader`` worker never touches the card.
"""
from __future__ import annotations

import random

import numpy as np

from .... import image as _image
from .... import ndarray as nd
from ....ndarray import NDArray
from ...block import Block
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting", "RandomGray"]


def _np(x):
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


def _nd(a, x, dtype=None):
    """``a`` as an NDArray on ``x``'s device (the CPU for a host ``x``)."""
    ctx = x.context if isinstance(x, NDArray) else "cpu"
    return nd.array(a, ctx=ctx, dtype=dtype)


class Compose(Sequential):
    """Sequentially compose transforms (reference: transforms.py Compose)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return _nd(_np(x).astype(self._dtype), x, self._dtype)


class ToTensor(Block):
    """HWC uint8 [0,255] → CHW float32 [0,1] (reference: ToTensor)."""

    def forward(self, x):
        a = _np(x).astype(np.float32) / 255.0
        if a.ndim == 3:
            a = a.transpose(2, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(0, 3, 1, 2)
        return _nd(a, x)


class Normalize(Block):
    """(x - mean) / std per channel on CHW float tensors."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self._std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        return _nd((_np(x) - self._mean) / self._std, x)


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        if isinstance(self._size, int):
            if self._keep:
                return _image.resize_short(x, self._size, self._interpolation)
            w = h = self._size
        else:
            w, h = self._size
        return _image.imresize(x, w, h, self._interpolation)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._interpolation = interpolation

    def forward(self, x):
        return _image.center_crop(x, self._size, self._interpolation)[0]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def forward(self, x):
        return _image.random_size_crop(x, self._size, self._scale,
                                       self._ratio, self._interpolation)[0]


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if random.random() < 0.5:
            return _nd(_np(x)[:, ::-1].copy(), x, _np(x).dtype)
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if random.random() < 0.5:
            return _nd(_np(x)[::-1].copy(), x, _np(x).dtype)
        return x


class _JitterBlock(Block):
    def __init__(self, aug):
        super().__init__()
        self._aug = aug

    def forward(self, x):
        return self._aug(x)


class RandomBrightness(_JitterBlock):
    def __init__(self, brightness):
        super().__init__(_image.BrightnessJitterAug(brightness))


class RandomContrast(_JitterBlock):
    def __init__(self, contrast):
        super().__init__(_image.ContrastJitterAug(contrast))


class RandomSaturation(_JitterBlock):
    def __init__(self, saturation):
        super().__init__(_image.SaturationJitterAug(saturation))


class RandomHue(_JitterBlock):
    def __init__(self, hue):
        super().__init__(_image.HueJitterAug(hue))


class RandomColorJitter(_JitterBlock):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        aug = _image.SequentialAug(
            ([_image.ColorJitterAug(brightness, contrast, saturation)]
             if (brightness or contrast or saturation) else []) +
            ([_image.HueJitterAug(hue)] if hue else []))
        super().__init__(aug)


class RandomLighting(_JitterBlock):
    def __init__(self, alpha):
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        super().__init__(_image.LightingAug(alpha, eigval, eigvec))


class RandomGray(_JitterBlock):
    def __init__(self, p=0.5):
        super().__init__(_image.RandomGrayAug(p))
