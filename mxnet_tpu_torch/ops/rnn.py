"""The fused multi-layer RNN operator (RNN / LSTM / GRU): the port of
``mxnet_tpu/ops/rnn.py``.

The parameters arrive as the reference's flat vector: all weights, layer
by layer and direction by direction (``W`` then ``R``), then all biases
(``bW`` then ``bR``), the layout of MXNet's cuDNN op (``:55-80``), so
checkpoints cross between the packages.  :func:`_unpack` slices it into
views, which go in ``[w_ih, w_hh, b_ih, b_hh]`` order per layer and
direction to the functions ``nn.LSTM`` / ``nn.GRU`` / ``nn.RNN`` call
(``torch.lstm``, ``torch.gru``, ``torch.rnn_tanh``, ``torch.rnn_relu``):
cuDNN on the card, torch's native recurrences on the CPU.  The gate
orders agree with the reference's: LSTM i, f, g, o; GRU r, z, n with
``n = tanh(x_n + r * (W_hn h + b_hn))``.  The views are not cuDNN's own
weight buffer, so cuDNN copies them into one on every call.

The op picks its route from its own arguments, before any launch, and
never swaps one for another after a failure (:func:`rnn_route`):

- ``"fused"``: one fused call for every layer and direction;
- ``"fused_per_layer"``: inter-layer dropout under training (``p > 0``,
  more than one layer): one fused call per layer, the mask between
  layers drawn from ``_rng``'s generator of the data's device (torch's
  own ``dropout`` argument would draw from its default generator, so it
  is never passed);
- ``"loop"``: LSTM with ``lstm_state_clip_min`` or
  ``lstm_state_clip_nan``, a clip of the cell state inside the
  recurrence (``:100-106``) that the fused functions lack; a loop over
  timesteps of torch ops, the input projection of every step one matmul.

:func:`launch_counts` counts the op's calls by route (shape inference on
the meta device counts nothing).
"""
from __future__ import annotations

import torch

from . import registry as _reg
from .elemwise import _clip
from .nn import Dropout
from .registry import register

__all__ = ["rnn", "rnn_layers", "rnn_param_size", "rnn_state_shape",
           "rnn_route", "launch_counts", "reset_launch_counts"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}
_FUSED = {"lstm": torch.lstm, "gru": torch.gru, "rnn_tanh": torch.rnn_tanh,
          "rnn_relu": torch.rnn_relu}
ROUTES = ("fused", "fused_per_layer", "loop")
_launches = dict.fromkeys(ROUTES, 0)


def launch_counts():
    """{route: calls of the op on it} since the last reset."""
    return dict(_launches)


def reset_launch_counts():
    for k in _launches:
        _launches[k] = 0


def _dirs(bidirectional):
    return 2 if bidirectional else 1


def rnn_param_size(state_size, input_size, num_layers, mode, bidirectional):
    """Length of the flat parameter vector (reference: ``:35-44``)."""
    g = _GATES[mode]
    d = _dirs(bidirectional)
    size = 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else state_size * d
        size += d * (g * state_size * (in_size + state_size)
                     + 2 * g * state_size)
    return size


def rnn_state_shape(attrs, dshape):
    """``(layers * directions, batch, state_size)`` for data of shape
    ``dshape`` (seq_len, batch, input_size)."""
    num_layers = int(_reg.canonicalize(attrs.get("num_layers", 1)))
    state_size = int(_reg.canonicalize(attrs.get("state_size")))
    d = _dirs(_reg.canonicalize(attrs.get("bidirectional", False)))
    return (num_layers * d, dshape[1], state_size)


def _unpack(params, state_size, input_size, num_layers, mode,
            bidirectional):
    """Views of the flat vector: ``[layer][direction] -> [W, R, bW, bR]``."""
    g = _GATES[mode]
    d = _dirs(bidirectional)
    H = state_size
    weights = []
    off = 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else H * d
        layer_w = []
        for _ in range(d):
            W = params[off:off + g * H * in_size].view(g * H, in_size)
            off += g * H * in_size
            R = params[off:off + g * H * H].view(g * H, H)
            off += g * H * H
            layer_w.append([W, R])
        weights.append(layer_w)
    for layer in range(num_layers):
        for direction in range(d):
            bW = params[off:off + g * H]
            off += g * H
            bR = params[off:off + g * H]
            off += g * H
            weights[layer][direction] += [bW, bR]
    if off != params.shape[0]:
        raise ValueError("RNN: %d parameters given, the layout needs %d"
                         % (params.shape[0], off))
    return weights


def rnn_route(mode, num_layers=1, p=0.0, train=False, clip_min=None,
              clip_nan=False):
    """The route the op takes for these arguments (module docstring)."""
    if mode == "lstm" and (clip_min is not None or clip_nan):
        return "loop"
    if p > 0 and train and num_layers > 1:
        return "fused_per_layer"
    return "fused"


def _fused(mode, x, h0, c0, flat, num_layers, bidirectional):
    """One fused call over ``num_layers`` layers: (out, h_T, c_T | None)."""
    train = torch.is_grad_enabled()
    if mode == "lstm":
        return torch.lstm(x, (h0, c0), flat, True, num_layers, 0.0, train,
                          bidirectional, False)
    out, h = _FUSED[mode](x, h0, flat, True, num_layers, 0.0, train,
                          bidirectional, False)
    return out, h, None


def _loop_direction(x, h, c, W, R, bW, bR, reverse, clip_min, clip_max,
                    clip_nan):
    """One LSTM direction step by step with the cell clip
    (reference: ``_cell_step`` / ``_run_direction``, ``:83-139``)."""
    if reverse:
        x = torch.flip(x, (0,))
    T, B, _ = x.shape
    xp = (x.reshape(T * B, -1) @ W.t() + bW).reshape(T, B, -1)
    outs = []
    for t in range(T):
        gates = xp[t] + h @ R.t() + bR
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        if clip_nan:
            c = torch.nan_to_num(c)
        if clip_min is not None and clip_max is not None:
            c = _clip(c, clip_min, clip_max)
        elif clip_min is not None:
            c = torch.maximum(c, c.new_tensor(clip_min))
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    out = torch.stack(outs)
    if reverse:
        out = torch.flip(out, (0,))
    return out, h, c


def _rnn_num_outputs(params):
    if not _reg.canonicalize(params.get("state_outputs", False)):
        return 1
    return 3 if params.get("mode", "lstm") == "lstm" else 2


def _rnn_optional(params):
    """The state_cell input exists only in LSTM mode."""
    return () if params.get("mode", "lstm") == "lstm" else ("state_cell",)


@register("RNN", arg_names=["data", "parameters", "state", "state_cell"],
          num_outputs=_rnn_num_outputs, needs_train=True,
          optional_args=_rnn_optional)
def rnn(data, parameters, state, state_cell=None, state_size=0, num_layers=1,
        mode="lstm", bidirectional=False, p=0.0, state_outputs=False,
        lstm_state_clip_min=None, lstm_state_clip_max=None,
        lstm_state_clip_nan=False, projection_size=None, _train=False):
    """Fused RNN forward (reference: src/operator/rnn-inl.h:49).

    data: (seq_len, batch, input_size); parameters: the flat vector;
    state: (layers * directions, batch, H); returns output (seq_len,
    batch, directions * H) [+ final h [+ final c]]."""
    if projection_size:
        raise NotImplementedError(
            "projected LSTM (projection_size) is not supported; the flat "
            "parameter layout would be misread — failing loudly instead")
    if mode not in _GATES:
        raise ValueError("unknown RNN mode %r" % mode)
    weights = None
    if data.device.type != "meta":
        weights = _unpack(parameters, int(state_size), data.shape[2],
                          int(num_layers), mode, bidirectional)
    return rnn_layers(data, weights, state, state_cell, int(state_size),
                      int(num_layers), mode, bool(bidirectional), p,
                      state_outputs, lstm_state_clip_min,
                      lstm_state_clip_max, lstm_state_clip_nan, _train)


def rnn_layers(data, weights, state, state_cell, H, L, mode, bidirectional,
               p=0.0, state_outputs=False, clip_min=None, clip_max=None,
               clip_nan=False, _train=False):
    """The op on per-layer weights: ``weights[layer][direction]`` is
    ``[W, R, bW, bR]`` (views of the flat vector, or a Gluon layer's own
    parameters, which thus take their gradients directly)."""
    d = _dirs(bidirectional)
    T, B, _ = data.shape
    lstm = mode == "lstm"
    if data.device.type == "meta":
        out = data.new_empty((T, B, d * H))
        h = data.new_empty((L * d, B, H))
        if not state_outputs:
            return out
        return (out, h, data.new_empty((L * d, B, H))) if lstm else (out, h)
    c0 = None
    if lstm:
        c0 = state_cell if state_cell is not None else torch.zeros_like(state)
    p = float(p)
    route = rnn_route(mode, L, p, _train, clip_min, clip_nan)
    _launches[route] += 1
    if route == "fused":
        flat = [w for layer in weights for dw in layer for w in dw]
        out, h_out, c_out = _fused(mode, data, state, c0, flat, L,
                                   bidirectional)
    else:
        x, hs, cs = data, [], []
        for layer in range(L):
            if route == "loop":
                outs = []
                for direction in range(d):
                    idx = layer * d + direction
                    o, h_t, c_t = _loop_direction(
                        x, state[idx], c0[idx], *weights[layer][direction],
                        direction == 1, clip_min, clip_max, clip_nan)
                    outs.append(o)
                    hs.append(h_t[None])
                    cs.append(c_t[None])
                x = outs[0] if d == 1 else torch.cat(outs, dim=-1)
            else:
                rows = slice(layer * d, (layer + 1) * d)
                flat = [w for dw in weights[layer] for w in dw]
                x, h_t, c_t = _fused(mode, x, state[rows],
                                     None if c0 is None else c0[rows], flat,
                                     1, bidirectional)
                hs.append(h_t)
                cs.append(c_t)
            if p > 0 and _train and layer + 1 < L:
                # the reference's inter-layer mask (``:205-212``), drawn
                # from the seeded generator of x's device
                x = Dropout(x, p=p, _train=True)
        out = x
        h_out = torch.cat(hs)
        c_out = torch.cat(cs) if lstm else None
    if not state_outputs:
        return out
    return (out, h_out, c_out) if lstm else (out, h_out)
