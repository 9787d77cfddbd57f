"""``gluon.rnn`` of the port — recurrent layers and cells (reference:
``mxnet_tpu/gluon/rnn/``)."""
from .rnn_cell import (RecurrentCell, HybridRecurrentCell, RNNCell, LSTMCell,
                       GRUCell, SequentialRNNCell, DropoutCell, ModifierCell,
                       ZoneoutCell, ResidualCell, BidirectionalCell)
from .rnn_layer import RNN, LSTM, GRU

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell",
           "RNN", "LSTM", "GRU"]
