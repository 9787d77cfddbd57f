"""Symbolic RNN cells, ``mx.rnn``: the port of
``mxnet_tpu/rnn/rnn_cell.py`` (reference: python/mxnet/rnn/rnn_cell.py).

The cells compose ``sym`` graphs for ``BucketingModule`` training over
variable lengths.  ``FusedRNNCell`` unrolls into one ``RNN`` node
(``ops/rnn.py``: cuDNN through torch's fused RNN functions on the card),
its flat parameter vector carrying the ``FusedRNN`` initializer in its
``__init__`` attribute; the other cells unroll step by step into
``FullyConnected`` and elementwise nodes.  Begin states of an unknown
batch become ``_state_zeros_like`` nodes anchored to the input.
"""
from __future__ import annotations

from .. import initializer as init_mod
from .. import symbol
from ..symbol.symbol import Symbol

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ZoneoutCell", "ResidualCell"]


class RNNParams:
    """Container for cell parameter symbols, shared by name
    (reference: rnn_cell.py RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


def _resolve_deferred_states(states, ref, batch_axis=0):
    """Rewrite unknown-batch zeros states in place to take their batch
    dimension from ``ref`` (``ops/init.py`` ``_state_zeros_like``), as the
    reference does."""
    from ..ops import registry as _reg
    for s in states:
        node = s._outputs[0][0]
        if node.op in ("_zeros", "_full"):
            shape = _reg.canonicalize(node.attrs.get("shape", "()"))
            if shape and 0 in tuple(shape):
                node.op = "_state_zeros_like"
                node.inputs = [ref._outputs[0]]
                node.attrs = {"shape": str(tuple(shape)),
                              "batch_axis": str(int(batch_axis))}
    return states


class BaseRNNCell:
    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if info is not None:
                info = dict(info)
                info.update(kwargs)
            else:
                info = kwargs
            state = func(name="%sbegin_state_%d" % (self._prefix,
                                                    self._init_counter),
                         **info)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Split fused parameter blobs into per-gate entries
        (reference: rnn_cell.py unpack_weights)."""
        args = dict(args)
        h = self._num_hidden
        for group_name in ["i2h", "h2h"]:
            weight = args.pop("%s%s_weight" % (self._prefix, group_name))
            bias = args.pop("%s%s_bias" % (self._prefix, group_name))
            for j, gate in enumerate(self._gate_names):
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                args[wname] = weight[j * h:(j + 1) * h].copy()
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                args[bname] = bias[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        from .. import ndarray as nd
        args = dict(args)
        for group_name in ["i2h", "h2h"]:
            ws = [args.pop("%s%s%s_weight" % (self._prefix, group_name, gate))
                  for gate in self._gate_names]
            bs = [args.pop("%s%s%s_bias" % (self._prefix, group_name, gate))
                  for gate in self._gate_names]
            args["%s%s_weight" % (self._prefix, group_name)] = \
                nd.concatenate(ws, axis=0)
            args["%s%s_bias" % (self._prefix, group_name)] = \
                nd.concatenate(bs, axis=0)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll into a symbol graph (reference: rnn_cell.py unroll)."""
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, Symbol):
            if length == 1:
                inputs = [symbol.squeeze(inputs, axis=axis)]
            else:
                inputs = list(symbol.split(inputs, num_outputs=length,
                                           axis=axis, squeeze_axis=1))
        if begin_state is None:
            begin_state = _resolve_deferred_states(self.begin_state(),
                                                   inputs[0], batch_axis=0)
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs is None or merge_outputs:
            outputs = [symbol.expand_dims(o, axis=axis) for o in outputs]
            outputs = symbol.Concat(*outputs, dim=axis)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class RNNCell(BaseRNNCell):
    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=self._num_hidden,
                                    name="%sh2h" % name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        from ..initializer import LSTMBias
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias",
                                   init=LSTMBias(forget_bias=forget_bias))

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%sh2h" % name)
        gates = i2h + h2h
        slice_gates = symbol.SliceChannel(gates, num_outputs=4, axis=-1,
                                          name="%sslice" % name)
        in_gate = symbol.Activation(slice_gates[0], act_type="sigmoid")
        forget_gate = symbol.Activation(slice_gates[1], act_type="sigmoid")
        in_transform = symbol.Activation(slice_gates[2], act_type="tanh")
        out_gate = symbol.Activation(slice_gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(prev_h, self._hW, self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%sh2h" % name)
        i2h_r, i2h_z, i2h_o = symbol.SliceChannel(
            i2h, num_outputs=3, axis=-1, name="%si2h_slice" % name)
        h2h_r, h2h_z, h2h_o = symbol.SliceChannel(
            h2h, num_outputs=3, axis=-1, name="%sh2h_slice" % name)
        reset_gate = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = symbol.Activation(i2h_o + reset_gate * h2h_o,
                                       act_type="tanh")
        next_h = update_gate * prev_h + (1.0 - update_gate) * next_h_tmp
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer cell backed by the RNN op
    (reference: rnn_cell.py FusedRNNCell over the cuDNN op)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        # flat cuDNN-layout parameter vector: 1-D, so route init through the
        # FusedRNN initializer (Xavier would reject a 1-D weight)
        self._parameter = self.params.get(
            "parameters", init=init_mod.FusedRNN(
                None, num_hidden, num_layers, mode, bidirectional,
                forget_bias))
        self._directions = ["l", "r"] if bidirectional else ["l"]

    @property
    def state_info(self):
        b = self._num_layers * len(self._directions)
        n = (self._mode == "lstm") + 1
        return [{"shape": (b, 0, self._num_hidden), "__layout__": "LNC"}
                for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": ("",), "rnn_tanh": ("",),
                "lstm": ("_i", "_f", "_c", "_o"),
                "gru": ("_r", "_z", "_o")}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, (list, tuple)):
            inputs = [symbol.expand_dims(i, axis=0) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=0)
            axis = 0
        elif axis == 1:
            inputs = symbol.swapaxes(inputs, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = _resolve_deferred_states(self.begin_state(), inputs,
                                                   batch_axis=1)
        states = begin_state
        rnn = symbol.RNN(inputs, self._parameter, *states,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers, mode=self._mode,
                         bidirectional=self._bidirectional, p=self._dropout,
                         state_outputs=self._get_next_state,
                         name="%srnn" % self._prefix)
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if axis == 1:
            outputs = symbol.swapaxes(outputs, dim1=0, dim2=1)
        if merge_outputs is not None and not merge_outputs:
            outputs = list(symbol.split(outputs, num_outputs=length,
                                        axis=axis, squeeze_axis=1))
        return outputs, states

    def _slice_weights(self, arr, li, lh):
        """Yield (name, ndarray) per layer/direction in cuDNN order
        (reference: rnn_cell.py FusedRNNCell._slice_weights)."""
        import numpy as _np
        args = {}
        g = self._num_gates
        h = self._num_hidden
        d = len(self._directions)
        a = arr.asnumpy() if hasattr(arr, "asnumpy") else _np.asarray(arr)
        off = 0
        for layer in range(self._num_layers):
            in_size = li if layer == 0 else lh * d
            for direction in self._directions:
                name = "%s%s%d" % (self._prefix, direction, layer)
                args["%s_i2h_weight" % name] = a[off:off + g * h * in_size] \
                    .reshape(g * h, in_size)
                off += g * h * in_size
                args["%s_h2h_weight" % name] = a[off:off + g * h * h] \
                    .reshape(g * h, h)
                off += g * h * h
        for layer in range(self._num_layers):
            for direction in self._directions:
                name = "%s%s%d" % (self._prefix, direction, layer)
                args["%s_i2h_bias" % name] = a[off:off + g * h]
                off += g * h
                args["%s_h2h_bias" % name] = a[off:off + g * h]
                off += g * h
        return args

    def unpack_weights(self, args):
        from .. import ndarray as nd
        args = dict(args)
        arr = args.pop("%sparameters" % self._prefix)
        h = self._num_hidden
        d = len(self._directions)
        g = self._num_gates
        # input size from total parameter count: total =
        #   d*g*h*(li+h) + d*2*g*h                       (layer 0)
        # + (L-1)*d*(g*h*(h*d+h) + 2*g*h)                (layers 1..L-1)
        total = arr.size if hasattr(arr, "size") else arr.shape[0]
        rest = total - (self._num_layers - 1) * d * (
            g * h * (h * d + h) + 2 * g * h) - d * 2 * g * h
        li = rest // (d * g * h) - h
        for k, v in self._slice_weights(arr, li, h).items():
            args[k] = nd.array(v)
        return args

    def pack_weights(self, args):
        import numpy as _np
        from .. import ndarray as nd
        args = dict(args)
        g = self._num_gates
        ws, bs = [], []
        for layer in range(self._num_layers):
            for direction in self._directions:
                name = "%s%s%d" % (self._prefix, direction, layer)
                ws.append(args.pop("%s_i2h_weight" % name).asnumpy().ravel())
                ws.append(args.pop("%s_h2h_weight" % name).asnumpy().ravel())
        for layer in range(self._num_layers):
            for direction in self._directions:
                name = "%s%s%d" % (self._prefix, direction, layer)
                bs.append(args.pop("%s_i2h_bias" % name).asnumpy().ravel())
                bs.append(args.pop("%s_h2h_bias" % name).asnumpy().ravel())
        args["%sparameters" % self._prefix] = nd.array(
            _np.concatenate(ws + bs))
        return args

    def unfuse(self):
        """Equivalent stack of unfused cells (reference:
        FusedRNNCell.unfuse)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden, "relu", p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden, "tanh", p),
            "lstm": lambda p: LSTMCell(self._num_hidden, p),
            "gru": lambda p: GRUCell(self._num_hidden, p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(
                    self._dropout,
                    prefix="%s_dropout%d_" % (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            cell._own_params = False
            cell._params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            cell_states = states[p:p + n]
            p += n
            inputs, cell_states = cell(inputs, cell_states)
            next_states.extend(cell_states)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Step the stack as one cell (the reference's graph); a stack
        holding a ``BidirectionalCell``, which cannot be stepped (the
        ``unfuse`` of a bidirectional ``FusedRNNCell``), unrolls cell by
        cell over the whole sequence instead, where the reference raises
        (ROADMAP.md C8)."""
        if not any(isinstance(c, BidirectionalCell) for c in self._cells):
            return super().unroll(length, inputs, begin_state=begin_state,
                                  layout=layout, merge_outputs=merge_outputs)
        self.reset()
        next_states = []
        p = 0
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = None if begin_state is None else begin_state[p:p + n]
            p += n
            last = i == len(self._cells) - 1
            inputs, states = cell.unroll(
                length, inputs, begin_state=states, layout=layout,
                merge_outputs=merge_outputs if last else False)
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(inputs, p=self.dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    def __init__(self, base_cell):
        base_cell._modified = True
        super().__init__()
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class ZoneoutCell(ModifierCell):
    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)
        mask = (lambda p, like:
                symbol.Dropout(symbol.ones_like(like), p=p))
        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(next_output)
        output = symbol.where(mask(self.zoneout_outputs, next_output),
                              next_output, prev_output) \
            if self.zoneout_outputs > 0 else next_output
        states = [symbol.where(mask(self.zoneout_states, new_s), new_s, old_s)
                  for new_s, old_s in zip(next_states, states)] \
            if self.zoneout_states > 0 else next_states
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol.elemwise_add(output, inputs)
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)
        self.base_cell._modified = True
        if isinstance(outputs, (list, tuple)):
            if not isinstance(inputs, (list, tuple)):
                axis = layout.find("T")
                inputs = list(symbol.split(inputs, num_outputs=length,
                                           axis=axis, squeeze_axis=1))
            outputs = [symbol.elemwise_add(o, i)
                       for o, i in zip(outputs, inputs)]
        else:
            if isinstance(inputs, (list, tuple)):
                axis = layout.find("T")
                inputs = [symbol.expand_dims(i, axis=axis) for i in inputs]
                inputs = symbol.Concat(*inputs, dim=axis)
            outputs = symbol.elemwise_add(outputs, inputs)
        return outputs, states


class BidirectionalCell(BaseRNNCell):
    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        self._cells = [l_cell, r_cell]
        for cell in self._cells:
            self.params._params.update(cell.params._params)

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped; use unroll")

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, Symbol):
            if length == 1:
                inputs = [symbol.squeeze(inputs, axis=axis)]
            else:
                inputs = list(symbol.split(inputs, num_outputs=length,
                                           axis=axis, squeeze_axis=1))
        if begin_state is None:
            begin_state = _resolve_deferred_states(self.begin_state(),
                                                   inputs[0], batch_axis=0)
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[n_l:], layout=layout,
            merge_outputs=False)
        outputs = [symbol.Concat(l, r, dim=1,
                                 name="%st%d" % (self._output_prefix, i))
                   for i, (l, r) in enumerate(
                       zip(l_outputs, reversed(r_outputs)))]
        if merge_outputs is None or merge_outputs:
            outputs = [symbol.expand_dims(o, axis=axis) for o in outputs]
            outputs = symbol.Concat(*outputs, dim=axis)
        return outputs, l_states + r_states
