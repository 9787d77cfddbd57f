"""`mx.image` namespace: the port of ``mxnet_tpu/image/`` (reference:
python/mxnet/image/).  ``image/detection.py`` (``ImageDetIter``) is
ROADMAP.md queue A, item 10."""
from .image import *  # noqa: F401,F403
from .image import ImageIter  # noqa: F401
