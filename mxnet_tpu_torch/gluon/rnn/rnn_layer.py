"""Fused recurrent layers ``gluon.rnn.RNN`` / ``LSTM`` / ``GRU``: the port
of ``mxnet_tpu/gluon/rnn/rnn_layer.py``.

The parameters keep the reference's names and shapes
(``l0_i2h_weight``, ``r1_h2h_bias``, ...), so ``.params`` files cross
between the packages.  The reference concatenates them into the flat
vector of the ``RNN`` op at every forward (``_pack_params``); here each
layer's and direction's tensors go to the op's per-layer entry
(``ops.rnn.rnn_layers``) as they are, on the same routes, so no flat copy
is made and each parameter takes its gradient directly.
"""
from __future__ import annotations

import torch

from ... import ndarray as nd
from ...ops import rnn as _rnn_ops
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), "invalid layout %r" % layout
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = _rnn_ops._GATES[mode]

        ng, ni, nh = self._gates, input_size, hidden_size
        with self.name_scope():
            for i in range(num_layers):
                for j in ["l", "r"][:self._dir]:
                    self._register_param(
                        "%s%d_i2h_weight" % (j, i), (ng * nh, ni),
                        i2h_weight_initializer)
                    self._register_param(
                        "%s%d_h2h_weight" % (j, i), (ng * nh, nh),
                        h2h_weight_initializer)
                    self._register_param(
                        "%s%d_i2h_bias" % (j, i), (ng * nh,),
                        i2h_bias_initializer)
                    self._register_param(
                        "%s%d_h2h_bias" % (j, i), (ng * nh,),
                        h2h_bias_initializer)
                ni = nh * self._dir

    def _register_param(self, name, shape, initializer):
        p = self.params.get(name, shape=shape, init=initializer,
                            allow_deferred_init=True)
        setattr(self, name, p)
        return p

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        mapping = "{0} -> {1}".format(
            self._input_size if self._input_size else None, self._hidden_size)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def infer_param_shapes(self, x, *args):
        ni = x.shape[-1]
        if self._input_size == 0:
            self._input_size = ni
            ng, nh = self._gates, self._hidden_size
            for i in range(self._num_layers):
                for j in ["l", "r"][:self._dir]:
                    p = getattr(self, "%s%d_i2h_weight" % (j, i))
                    if p._deferred_init:
                        p.shape = (ng * nh, ni)
                ni = nh * self._dir

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states, ``func(shape=...)`` each (``nd.zeros``:
        NDArrays on ``ctx``, the current context by default)."""
        if func is None:
            func = nd.zeros
        return [func(shape=info["shape"], **kwargs) if "shape" in info
                else func(**kwargs) for info in self.state_info(batch_size)]

    def hybrid_forward(self, F, inputs, states=None, **params):
        if self._layout == "NTC":
            inputs = inputs.transpose(0, 1)
        skip_states = states is None
        if skip_states:
            states = [torch.zeros(info["shape"], dtype=inputs.dtype,
                                  device=inputs.device)
                      for info in self.state_info(inputs.shape[1])]
        if isinstance(states, torch.Tensor):
            states = [states]
        weights = [[[params["%s%d_%s" % (j, i, n)] for n in
                     ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias")]
                    for j in ["l", "r"][:self._dir]]
                   for i in range(self._num_layers)]
        outs = _rnn_ops.rnn_layers(
            inputs, weights, states[0],
            states[1] if self._mode == "lstm" else None, self._hidden_size,
            self._num_layers, self._mode, self._dir == 2, p=self._dropout,
            state_outputs=True, _train=self._train_flag())
        out, out_states = outs[0], list(outs[1:])
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        return out if skip_states else (out, out_states)


class RNN(_RNNLayer):
    """Vanilla multi-layer RNN with relu / tanh (reference: rnn_layer.py
    RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (reference: rnn_layer.py LSTM)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU, cuDNN variant (reference: rnn_layer.py GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
