"""``gluon.contrib`` of the port (reference: ``mxnet_tpu/gluon/contrib``):
``nn``.  The reference's ``contrib.rnn`` is ROADMAP.md queue A, item 10."""
from . import nn

__all__ = ["nn"]
