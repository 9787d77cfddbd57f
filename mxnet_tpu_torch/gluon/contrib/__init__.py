"""``gluon.contrib`` of the port (reference: ``mxnet_tpu/gluon/contrib``):
``nn`` and ``rnn``."""
from . import nn, rnn

__all__ = ["nn", "rnn"]
