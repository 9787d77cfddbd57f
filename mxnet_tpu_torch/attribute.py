"""``attribute`` (the port of ``mxnet_tpu/attribute.py``): AttrScope for
scoped symbol attributes."""
from .symbol.symbol import AttrScope

__all__ = ["AttrScope"]
