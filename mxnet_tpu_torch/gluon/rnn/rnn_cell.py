"""Recurrent cells: the port of ``mxnet_tpu/gluon/rnn/rnn_cell.py``.

A cell computes one timestep; ``unroll`` runs it over a sequence.  Both
run on torch tensors: called on NDArrays (the states a list of them),
a cell or ``unroll`` crosses the boundary once
(``gluon.block.run_on_tensors``: recorded only inside
``autograd.record()``, the training flag ``autograd.is_training()``) and
hands NDArrays back.  Dropout-like cells read that flag
(``Block._train_flag``).  ``begin_state`` called by a user makes
NDArrays (``nd.zeros``); inside ``unroll`` the states start as zeros
beside the inputs.
"""
from __future__ import annotations

import torch

from ... import ndarray as nd
from ...ops.indexing import sequence_last, sequence_reverse
from ..block import Block, HybridBlock, _has_ndarray, run_on_tensors

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _zeros_beside(ref):
    """A ``begin_state`` func: zeros of ``shape`` on ``ref``'s device and
    dtype."""
    def zeros(shape, **kwargs):
        return torch.zeros(shape, dtype=ref.dtype, device=ref.device)
    return zeros


def _steps(inputs, length, axis):
    """The sequence as a list of ``length`` steps along ``axis``."""
    if isinstance(inputs, (list, tuple)):
        return list(inputs)
    return list(torch.unbind(inputs, dim=axis))[:length]


class RecurrentCell(Block):
    """Base class for recurrent cells."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be " \
            "called directly"
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            info.pop("__layout__", None)
            states.append(func(**info, **kwargs))
        return states

    def __call__(self, inputs, states):
        if _has_ndarray((inputs, states)):
            return run_on_tensors(self.__call__, (inputs, states), {})
        return torch.nn.Module.__call__(self, inputs, states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell over ``length`` timesteps
        (reference: rnn_cell.py unroll)."""
        args = (length, inputs, begin_state, layout, merge_outputs,
                valid_length)
        if _has_ndarray(args):
            return run_on_tensors(self._unroll, args, {})
        return self._unroll(*args)

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        self.reset()
        axis = layout.find("T")
        batch_axis = layout.find("N")
        seq = _steps(inputs, length, axis)
        if isinstance(inputs, (list, tuple)):
            batch_size = seq[0].shape[batch_axis if batch_axis < axis
                                      else batch_axis - 1]
        else:
            batch_size = inputs.shape[batch_axis]
        if begin_state is None:
            begin_state = self.begin_state(batch_size,
                                           func=_zeros_beside(seq[0]))
        states = begin_state
        outputs = []
        all_states = []
        for i in range(length):
            out, states = self(seq[i], states)
            outputs.append(out)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            # the final states at t = valid_length - 1, not at the padded
            # end; padded steps' outputs zeroed
            states = [sequence_last(torch.stack(ele, dim=0), valid_length,
                                    use_sequence_length=True, axis=0)
                      for ele in zip(*all_states)]
            vl = valid_length.reshape(-1, 1)
            outputs = [torch.where(i < vl, o, torch.zeros_like(o))
                       for i, o in enumerate(outputs)]
        if merge_outputs is None or merge_outputs:
            outputs = torch.stack(outputs, dim=axis)
        return outputs, states

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, inputs, states):
        self._counter += 1
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class _BaseGatedCell(HybridRecurrentCell):
    """The parameters RNN / LSTM / GRU cells share."""

    def __init__(self, hidden_size, gates, input_size,
                 i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._gates = gates
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(gates * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(gates * hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(gates * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(gates * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def infer_param_shapes(self, x, *args):
        if self.i2h_weight._deferred_init:
            self.i2h_weight.shape = (self._gates * self._hidden_size,
                                     x.shape[-1])
            self._input_size = x.shape[-1]


class RNNCell(_BaseGatedCell):
    """Elman RNN cell: h' = act(W x + b + R h + b_R)
    (reference: rnn_cell.py RNNCell)."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(hidden_size, 1, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, prefix, params)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(_BaseGatedCell):
    """LSTM cell, gates i, f, g, o (reference: rnn_cell.py LSTMCell)."""

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(hidden_size, 4, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, prefix, params)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        in_gate, forget_gate, in_transform, out_gate = (i2h + h2h).chunk(
            4, dim=-1)
        next_c = torch.sigmoid(forget_gate) * states[1] \
            + torch.sigmoid(in_gate) * torch.tanh(in_transform)
        next_h = torch.sigmoid(out_gate) * torch.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(_BaseGatedCell):
    """GRU cell, cuDNN variant, gates r, z, n (reference: rnn_cell.py
    GRUCell)."""

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(hidden_size, 3, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, prefix, params)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h_n = i2h.chunk(3, dim=-1)
        h2h_r, h2h_z, h2h_n = h2h.chunk(3, dim=-1)
        reset = torch.sigmoid(i2h_r + h2h_r)
        update = torch.sigmoid(i2h_z + h2h_z)
        new = torch.tanh(i2h_n + reset * h2h_n)
        next_h = (1.0 - update) * new + update * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack cells, feeding each output to the next
    (reference: rnn_cell.py SequentialRNNCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell, str(len(self._children)))

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, func=func, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        next_states = []
        pos = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            state = states[pos:pos + n]
            pos += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]


class DropoutCell(HybridRecurrentCell):
    """Dropout on cell outputs (reference: rnn_cell.py DropoutCell)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes,
                               _train=self._train_flag())
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """Base for cells wrapping another cell (reference: ModifierCell)."""

    def __init__(self, base_cell):
        assert not base_cell._modified
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(), params=None)
        self.base_cell = base_cell
        self.register_child(base_cell, "base_cell")

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size=batch_size, func=func,
                                           **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference: rnn_cell.py ZoneoutCell): each
    output and state keeps its previous value where a dropout mask of
    ones drops it, under training only."""

    def _alias(self):
        return "zoneout"

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell)
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        super().__init__(base_cell)
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        po, ps = self._zoneout_outputs, self._zoneout_states
        train = self._train_flag()

        def mask(p, like):
            return F.Dropout(torch.ones_like(like), p=p, _train=train)
        prev_output = self._prev_output if self._prev_output is not None \
            else torch.zeros_like(next_output)
        output = F.where(mask(po, next_output), next_output, prev_output) \
            if po != 0.0 else next_output
        new_states = [F.where(mask(ps, ns), ns, os) for ns, os in
                      zip(next_states, states)] if ps != 0.0 else next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Adds inputs to cell outputs (reference: rnn_cell.py ResidualCell)."""

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Two cells over the sequence in opposite directions
    (reference: rnn_cell.py BidirectionalCell); with ``valid_length`` each
    sequence is reversed within its length (``SequenceReverse``), so
    padding never enters the reverse recurrence."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell cannot be stepped; use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, func=func, **kwargs)

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        self.reset()
        axis = layout.find("T")
        seq = _steps(inputs, length, axis)
        batch_size = seq[0].shape[layout.find("N") - (1 if axis == 0 else 0)]
        if begin_state is None:
            begin_state = self.begin_state(batch_size,
                                           func=_zeros_beside(seq[0]))
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info())
        inner_layout = "NTC" if axis == 1 else "TNC"
        l_outputs, l_states = l_cell.unroll(
            length, seq, begin_state[:n_l], layout=inner_layout,
            merge_outputs=False, valid_length=valid_length)

        def _rev(step_list):
            if valid_length is None:
                return list(reversed(step_list))
            rev = sequence_reverse(torch.stack(step_list, dim=0),
                                   valid_length, use_sequence_length=True)
            return list(torch.unbind(rev, dim=0))

        r_outputs, r_states = r_cell.unroll(
            length, _rev(seq), begin_state[n_l:], layout=inner_layout,
            merge_outputs=False, valid_length=valid_length)
        outputs = [torch.cat([l, r], dim=-1) for l, r in
                   zip(l_outputs, _rev(r_outputs))]
        if merge_outputs is None or merge_outputs:
            outputs = torch.stack(outputs, dim=axis)
        return outputs, l_states + r_states
