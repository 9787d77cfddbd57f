"""Gluon layers of the port (reference: ``mxnet_tpu/gluon/nn``)."""
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from .basic_layers import __all__ as _basic
from .conv_layers import __all__ as _conv
from ..block import Block, HybridBlock  # noqa: F401

__all__ = list(_basic) + list(_conv) + ["Block", "HybridBlock"]
