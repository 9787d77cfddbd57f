"""``mx.rnn`` of the port — symbolic cells, the bucketing sentence
iterator and the checkpoint helpers (reference: ``mxnet_tpu/rnn/``)."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       DropoutCell, ZoneoutCell, ResidualCell, ModifierCell)
from .rnn import save_rnn_checkpoint, load_rnn_checkpoint, do_rnn_checkpoint
from .io import BucketSentenceIter

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ZoneoutCell", "ResidualCell", "ModifierCell",
           "save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint", "BucketSentenceIter"]
