"""The fused ``RNN`` operator of mxnet_tpu_torch held against mxnet_tpu on
the CPU (``ops/rnn.py``), with the symbol's shape rule and the RNN
initializers.

- Every mode (lstm, gru, rnn_tanh, rnn_relu) at 1 and 2 layers and in
  one and two directions (one depth in each), with ``state_outputs``: the output and the final states,
  and the gradients with respect to the data, the flat parameter vector
  and both begin states under one set of seeded cotangents, within 1e-5
  of the reference's (``jax.vjp`` through its ``lax.scan``).  Each of
  these goes through torch's fused RNN functions (the ``fused`` route's
  counter).
- The cell clip (``lstm_state_clip_min/max``, ``lstm_state_clip_nan``):
  the ``loop`` route, the same limits.
- Inter-layer dropout under training: the ``fused_per_layer`` route; its
  mask is the one ``_rng``'s generator draws (the output equals two
  one-layer calls around that mask), kept at the rate 1 - p (law), two
  forwards differ, and one ``mx.random.seed`` repeats a forward bitwise.
- ``projection_size`` raises, as the reference's does.
- ``nd.RNN`` and ``sym.RNN``: the symbol infers the reference's argument
  and output shapes; ``LSTMBias`` and the ``FusedRNN`` a fused cell's
  parameter vector carries fill a buffer bitwise as the reference's do.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import rnn as jrnn
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.ops import rnn as trnn

TOL = 1e-5
T, B, I, H = 4, 3, 5, 6
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")
# each mode at 1 and 2 layers, each depth in one direction or the other,
# so every mode runs both directions and both depths (phase 28 of
# chip_smoke.py runs the whole product on the card)
CASES = [(m, L, bi) for i, m in enumerate(MODES)
         for L, bi in (((1, False), (2, True)) if i % 2 == 0
                       else ((1, True), (2, False)))]
CLIPS = [(2, True, dict(lstm_state_clip_min=-0.2, lstm_state_clip_max=0.25,
                        lstm_state_clip_nan=True)),
         (1, False, dict(lstm_state_clip_nan=True))]


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _inputs(mode, L, bi, seed=0):
    rng = np.random.RandomState(seed)
    d = 2 if bi else 1
    n = trnn.rnn_param_size(H, I, L, mode, bi)
    assert n == jrnn.rnn_param_size(H, I, L, mode, bi)
    x = rng.randn(T, B, I).astype(np.float32)
    flat = (rng.randn(n) * 0.4).astype(np.float32)
    h0 = (rng.randn(L * d, B, H) * 0.5).astype(np.float32)
    c0 = (rng.randn(L * d, B, H) * 0.5).astype(np.float32)
    return x, flat, h0, c0


def _cotangents(outs, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(*o.shape).astype(np.float32) for o in outs]


def _reference(mode, arrays, params):
    """(outputs, gradients wrt x, flat, h0[, c0]) from the reference."""
    lstm = mode == "lstm"
    args = [jnp.asarray(a) for a in (arrays if lstm else arrays[:3])]

    def f(*a):
        out = jrnn.rnn(*a, mode=mode, state_outputs=True, **params)
        return tuple(out)
    # op by op: at these sizes faster than compiling the scan per case
    with jax.disable_jit():
        outs, vjp = jax.vjp(f, *args)
        cts = _cotangents(outs)
        grads = vjp(tuple(jnp.asarray(c) for c in cts))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port(mode, arrays, params):
    lstm = mode == "lstm"
    ts = [torch.tensor(a, requires_grad=True)
          for a in (arrays if lstm else arrays[:3])]
    outs = trnn.rnn(*ts, mode=mode, state_outputs=True, **params)
    cts = _cotangents(outs)
    grads = torch.autograd.grad(outs, ts, [torch.from_numpy(c) for c in cts])
    return ([o.detach().numpy() for o in outs],
            [g.numpy() for g in grads])


def _close(want, got, msg):
    assert len(want) == len(got), msg
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.shape == g.shape, (msg, i, w.shape, g.shape)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   err_msg="%s [%d]" % (msg, i))


@pytest.mark.parametrize("mode,L,bi", CASES,
                         ids=["%s-L%d-%s" % (m, L, "bi" if b else "uni")
                              for m, L, b in CASES])
def test_fused_route_matches_reference(mode, L, bi):
    arrays = _inputs(mode, L, bi)
    params = dict(state_size=H, num_layers=L, bidirectional=bi)
    want_out, want_grad = _reference(mode, arrays, params)
    trnn.reset_launch_counts()
    got_out, got_grad = _port(mode, arrays, params)
    assert trnn.launch_counts() == {"fused": 1, "fused_per_layer": 0,
                                    "loop": 0}
    _close(want_out, got_out, "outputs")
    _close(want_grad, got_grad, "gradients")


@pytest.mark.parametrize("L,bi,clip", CLIPS,
                         ids=["L%d-%s-%s" % (L, "bi" if b else "uni",
                                             "-".join(sorted(c)))
                              for L, b, c in CLIPS])
def test_clip_route_matches_reference(L, bi, clip):
    arrays = list(_inputs("lstm", L, bi, seed=2))
    arrays[0] = arrays[0] * 3
    params = dict(state_size=H, num_layers=L, bidirectional=bi, **clip)
    want_out, want_grad = _reference("lstm", arrays, params)
    trnn.reset_launch_counts()
    got_out, got_grad = _port("lstm", arrays, params)
    assert trnn.launch_counts()["loop"] == 1
    _close(want_out, got_out, "outputs")
    _close(want_grad, got_grad, "gradients")
    if "lstm_state_clip_max" in clip:
        assert np.abs(got_out[2]).max() <= clip["lstm_state_clip_max"] \
            + 1e-7


def test_route_choice():
    assert trnn.rnn_route("lstm") == "fused"
    assert trnn.rnn_route("gru", 2, p=0.5, train=False) == "fused"
    assert trnn.rnn_route("gru", 1, p=0.5, train=True) == "fused"
    assert trnn.rnn_route("gru", 2, p=0.5, train=True) == "fused_per_layer"
    assert trnn.rnn_route("lstm", 2, p=0.5, train=True,
                          clip_min=-1.0) == "loop"
    assert trnn.rnn_route("lstm", clip_nan=True) == "loop"
    # the reference applies its clip in LSTM mode only
    assert trnn.rnn_route("gru", clip_min=-1.0) == "fused"


def _dropout_forward(x, flat, h0, c0, p=0.5):
    return trnn.rnn(torch.from_numpy(x), torch.from_numpy(flat),
                    torch.from_numpy(h0), torch.from_numpy(c0),
                    state_size=H, num_layers=2, mode="lstm", p=p,
                    _train=True)


def test_interlayer_dropout_mask_is_drawn_from_the_seeded_generator():
    from mxnet_tpu_torch import _rng
    x, flat, h0, c0 = _inputs("lstm", 2, False, seed=3)
    p = 0.5
    tmx.random.seed(11)
    trnn.reset_launch_counts()
    out = _dropout_forward(x, flat, h0, c0, p)
    assert trnn.launch_counts()["fused_per_layer"] == 1
    again = _dropout_forward(x, flat, h0, c0, p)
    assert not torch.equal(out, again)
    tmx.random.seed(11)
    assert torch.equal(out, _dropout_forward(x, flat, h0, c0, p))

    # the same forward as two one-layer calls around the mask the seeded
    # generator draws next
    tmx.random.seed(11)
    w = trnn._unpack(torch.from_numpy(flat), H, I, 2, "lstm", False)
    l0 = torch.cat([t.reshape(-1) for t in w[0][0][:2]]
                   + [t.reshape(-1) for t in w[0][0][2:]])
    l1 = torch.cat([t.reshape(-1) for t in w[1][0][:2]]
                   + [t.reshape(-1) for t in w[1][0][2:]])
    assert l0.numel() + l1.numel() == flat.size
    h, c = torch.from_numpy(h0), torch.from_numpy(c0)
    y0 = trnn.rnn(torch.from_numpy(x), l0, h[:1], c[:1], state_size=H,
                  mode="lstm")
    keep = torch.rand(y0.shape, generator=_rng.next_generator("cpu")) \
        < 1.0 - p
    y1 = trnn.rnn(torch.where(keep, y0 / (1.0 - p), torch.zeros_like(y0)),
                  l1, h[1:], c[1:], state_size=H, mode="lstm")
    torch.testing.assert_close(out, y1, rtol=0, atol=0)


def test_interlayer_dropout_keeps_at_its_rate():
    """The mask the op draws between layers (``ops.nn.Dropout`` under
    training) keeps 2**14 elements at 1 - p within 4.5 sigma, scaled by
    1 / (1 - p)."""
    from mxnet_tpu_torch.ops.nn import Dropout
    p = 0.3
    x = torch.ones(64, 16, 16)
    tmx.random.seed(5)
    y = Dropout(x, p=p, _train=True)
    kept = (y != 0).double().mean().item()
    assert abs(kept - (1 - p)) < 4.5 * np.sqrt(p * (1 - p) / x.numel())
    assert torch.equal(y[y != 0], (x / (1 - p))[y != 0])


def test_projection_size_raises_as_the_reference_does():
    x, flat, h0, c0 = [torch.from_numpy(a)
                       for a in _inputs("lstm", 1, False)]
    with pytest.raises(NotImplementedError, match="projection_size"):
        trnn.rnn(x, flat, h0, c0, state_size=H, projection_size=3)
    with pytest.raises(NotImplementedError, match="projection_size"):
        jrnn.rnn(jnp.asarray(x.numpy()), jnp.asarray(flat.numpy()),
                 jnp.asarray(h0.numpy()), jnp.asarray(c0.numpy()),
                 state_size=H, projection_size=3)


def test_nd_rnn_and_the_symbol_shape_rule():
    x, flat, h0, c0 = _inputs("gru", 2, True)
    want = mx.nd.RNN(mx.nd.array(x), mx.nd.array(flat), mx.nd.array(h0),
                     state_size=H, num_layers=2, mode="gru",
                     bidirectional=True, state_outputs=True)
    got = tmx.nd.RNN(tmx.nd.array(x), tmx.nd.array(flat),
                     tmx.nd.array(h0), state_size=H, num_layers=2,
                     mode="gru", bidirectional=True, state_outputs=True)
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=TOL,
                                   atol=TOL)
    shapes = {}
    for tag, m in (("ref", mx), ("port", tmx)):
        data = m.sym.Variable("data")
        net = m.sym.RNN(data, state_size=H, num_layers=2, mode="lstm",
                        bidirectional=True, state_outputs=True, name="rnn")
        shapes[tag] = (net.list_arguments(), net.list_outputs(),
                       net.infer_shape(data=(T, B, I)))
    assert shapes["port"] == shapes["ref"]
    assert shapes["port"][2][0][1] == (
        trnn.rnn_param_size(H, I, 2, "lstm", True),)


def test_rnn_initializers_match_the_reference():
    for tag, m in (("ref", mx), ("port", tmx)):
        assert m.init.FusedRNN(None, H, 2, "lstm", True).dumps() \
            == '["fusedrnn", {}]'
        assert m.init.LSTMBias(2.0).dumps() \
            == '["lstmbias", {"forget_bias": 2.0}]'
    bufs = {}
    for tag, m in (("ref", mx), ("port", tmx)):
        m.random.seed(3)
        fused = np.zeros(40, np.float32)
        bias = np.zeros(4 * H, np.float32)
        xavier = m.init.Xavier()
        if m is mx:
            fused_nd, bias_nd = mx.nd.array(fused), mx.nd.array(bias)
            xavier(m.init.InitDesc("lstm_parameters", {
                "__init__": m.init.FusedRNN(None, H).dumps()}), fused_nd)
            xavier(m.init.InitDesc("lstm_h2h_bias", {
                "__init__": m.init.LSTMBias(2.0).dumps()}), bias_nd)
            fused, bias = fused_nd.asnumpy(), bias_nd.asnumpy()
        else:
            xavier(m.init.InitDesc("lstm_parameters", {
                "__init__": m.init.FusedRNN(None, H).dumps()}), fused)
            xavier(m.init.InitDesc("lstm_h2h_bias", {
                "__init__": m.init.LSTMBias(2.0).dumps()}), bias)
        bufs[tag] = (fused, bias)
    np.testing.assert_array_equal(bufs["port"][0], bufs["ref"][0])
    np.testing.assert_array_equal(bufs["port"][1], bufs["ref"][1])
    assert np.abs(bufs["port"][0]).max() <= 0.07
    assert bufs["port"][1][H:2 * H].tolist() == [2.0] * H
