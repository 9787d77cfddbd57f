"""`mx.image` namespace: the port of ``mxnet_tpu/image/`` (reference:
python/mxnet/image/).  ``image.detection`` (``ImageDetIter`` and the
detection augmenters) is imported by name, as in the reference."""
from .image import *  # noqa: F401,F403
from .image import ImageIter  # noqa: F401
