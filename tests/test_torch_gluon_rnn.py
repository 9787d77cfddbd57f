"""``gluon.rnn`` and ``gluon.contrib.rnn`` of mxnet_tpu_torch held against
mxnet_tpu on the CPU.

Each net is built and initialized in both packages after the same
``mx.random.seed`` (``Xavier``), which draws the same weights: the
``.params`` files both write are byte-identical, and each package loads
the other's.  Then, under ``autograd.record()``:

- the cells (RNN relu / tanh, LSTM, GRU) unrolled in layout NTC or TNC
  from given begin states; with ``valid_length`` (final states at each
  sequence's end, padded steps zeroed); ``BidirectionalCell`` with
  ``valid_length`` (``SequenceReverse``); a ``SequentialRNNCell`` of
  LSTM, ``ResidualCell(GRU)`` and ``DropoutCell``: outputs, final states
  and the gradients of the inputs and every parameter within 1e-5;
- the layers ``RNN`` / ``LSTM`` / ``GRU`` (2 layers, both directions;
  both layouts and with and without states among them): the same
  limits;
- ``ZoneoutCell``, ``DropoutCell`` and ``VariationalDropoutCell`` at rate
  0 and outside training equal their base cell (reference's outputs
  1e-5); in training held by their laws (zoneout keeps the previous
  output at its rate; the variational masks are one draw reused at every
  step, kept at 1 - p).
"""
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.context import use

TOL = 1e-5
BOTH = (("ref", mx), ("port", tmx))


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _close(want, got, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=msg)


def _flat(out):
    """A cell's or layer's (outputs, states) as a flat list of arrays."""
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    return [out.asnumpy()]


def _run(m, make, inputs, call, tmp, tag, train=True):
    """Build with ``make(m)`` after ``m.random.seed(0)``, initialize
    (Xavier), run ``call(m, net, *nd inputs)`` recorded, backward from a
    seeded weighting of every output; returns (outputs, grads of inputs
    and parameters, .params path)."""
    m.random.seed(0)
    # a fresh global block counter: cells made outside a name scope (the
    # bidirectional pair) are named by it, and other tests in the process
    # may have advanced the two packages' counters unequally
    scope = m.gluon.block._BlockScope
    saved, scope._global_counter = scope._global_counter, {}
    try:
        net = make(m)
    finally:
        scope._global_counter = saved
    net.initialize(m.init.Xavier())
    xs = [m.nd.array(a) for a in inputs]
    xs[0].attach_grad()
    with m.autograd.record(train_mode=train):
        out = call(m, net, *xs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        leaves = []
        for o in outs:
            leaves.extend(o if isinstance(o, (list, tuple)) else [o])
        rng = np.random.RandomState(9)
        total = None
        for o in leaves:
            w = m.nd.array(rng.randn(*o.shape).astype(np.float32))
            s = m.nd.sum(o * w)
            total = s if total is None else total + s
    total.backward()
    grads = {"x": xs[0].grad.asnumpy()}
    for name, p in net.collect_params().items():
        if p.grad_req != "null":
            grads[name[len(net.prefix):]] = p.grad().asnumpy()
    path = os.path.join(tmp, tag + ".params")
    net.save_parameters(path)
    return _flat(out), grads, path


def _both(make, inputs, call, tmp_path, train=True):
    res = {tag: _run(m, make, inputs, call, str(tmp_path), tag, train)
           for tag, m in BOTH}
    (wo, wg, wp), (go, gg, gp) = res["ref"], res["port"]
    with open(wp, "rb") as f, open(gp, "rb") as g:
        assert f.read() == g.read(), ".params files differ"
    assert len(wo) == len(go)
    for i, (w, g) in enumerate(zip(wo, go)):
        assert w.shape == g.shape, (i, w.shape, g.shape)
        _close(w, g, msg="output %d" % i)
    assert sorted(wg) == sorted(gg)
    for k in wg:
        _close(wg[k], gg[k], msg="gradient of %s" % k)
    return res


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


CELLS = [("RNNCell", dict(activation="relu"), "NTC"),
         ("RNNCell", {}, "TNC"), ("LSTMCell", {}, "NTC"),
         ("GRUCell", {}, "TNC")]
N, T, C, H = 2, 4, 3, 5


@pytest.mark.parametrize("cell,kw,layout", CELLS,
                         ids=["rnn_relu-NTC", "rnn_tanh-TNC", "lstm-NTC",
                              "gru-TNC"])
def test_cells_unroll_match_reference(cell, kw, layout, tmp_path):
    x = _x(N, T, C) if layout == "NTC" else _x(T, N, C)

    def call(m, net, x):
        states = net.begin_state(N)
        return net.unroll(T, x, begin_state=states, layout=layout,
                          merge_outputs=True)
    _both(lambda m: getattr(m.gluon.rnn, cell)(H, **kw), [x], call,
          tmp_path)


def test_valid_length_and_bidirectional_cell_match_reference(tmp_path):
    x = _x(N, T, C, seed=1)
    vl = np.array([2, 4], np.float32)

    def call(m, net, x, vl):
        out, states = net.unroll(T, x, layout="NTC", valid_length=vl,
                                 merge_outputs=True)
        return [out, states]
    _both(lambda m: m.gluon.rnn.LSTMCell(H), [x, vl], call, tmp_path)
    res = _both(lambda m: m.gluon.rnn.BidirectionalCell(
        m.gluon.rnn.LSTMCell(H), m.gluon.rnn.GRUCell(H)), [x, vl], call,
        tmp_path)
    out = res["port"][0][0]
    assert out.shape == (N, T, 2 * H)
    np.testing.assert_array_equal(out[0, 2:], 0.0)


def test_stacked_residual_dropout_cells_match_reference(tmp_path):
    x = _x(N, T, H, seed=2)

    def make(m):
        stack = m.gluon.rnn.SequentialRNNCell()
        stack.add(m.gluon.rnn.LSTMCell(H))
        stack.add(m.gluon.rnn.ResidualCell(m.gluon.rnn.GRUCell(H)))
        stack.add(m.gluon.rnn.DropoutCell(0.5))
        return stack

    def call(m, net, x):
        return net.unroll(T, x, layout="NTC", merge_outputs=False)
    # outside training the dropout cell is the identity
    _both(make, [x], call, tmp_path, train=False)


LAYERS = [("RNN", dict(activation="tanh"), "TNC", False),
          ("RNN", {}, "NTC", True), ("LSTM", {}, "NTC", True),
          ("GRU", {}, "TNC", False)]


@pytest.mark.parametrize("layer,kw,layout,states", LAYERS,
                         ids=["rnn_tanh-TNC", "rnn_relu-NTC-states",
                              "lstm-NTC-states", "gru-TNC"])
def test_layers_match_reference(layer, kw, layout, states, tmp_path):
    x = _x(T, N, C, seed=3) if layout == "TNC" else _x(N, T, C, seed=3)

    def call(m, net, x):
        if not states:
            return net(x)
        begin = [s + 0.25 for s in net.begin_state(N)]
        return net(x, begin)
    _both(lambda m: getattr(m.gluon.rnn, layer)(
        H, num_layers=2, layout=layout, bidirectional=True, **kw), [x],
        call, tmp_path)


def test_params_files_cross_between_packages(tmp_path):
    x = _x(T, N, C, seed=4)
    outs = {}
    for tag, m in BOTH:
        m.random.seed(1)
        net = m.gluon.rnn.GRU(H, num_layers=2, bidirectional=True)
        net.initialize(m.init.Xavier())
        outs[tag] = net(m.nd.array(x)).asnumpy()
        net.save_parameters(str(tmp_path / (tag + ".params")))
    for tag, m in BOTH:
        other = "port" if tag == "ref" else "ref"
        net = m.gluon.rnn.GRU(H, num_layers=2, bidirectional=True)
        net.load_parameters(str(tmp_path / (other + ".params")))
        _close(outs[other], net(m.nd.array(x)).asnumpy())


def _modifier_pair(m, wrap):
    m.random.seed(3)
    base = m.gluon.rnn.LSTMCell(H)
    cell = wrap(m, base)
    cell.initialize(m.init.Xavier())
    return cell


WRAPS = {
    "zoneout": lambda m, c: m.gluon.rnn.ZoneoutCell(c, 0.5, 0.5),
    "vardrop": lambda m, c: m.gluon.contrib.rnn.VariationalDropoutCell(
        c, 0.5, 0.5, 0.5),
    "zoneout0": lambda m, c: m.gluon.rnn.ZoneoutCell(c, 0.0, 0.0),
    "vardrop0": lambda m, c: m.gluon.contrib.rnn.VariationalDropoutCell(
        c, 0.0, 0.0, 0.0),
}


@pytest.mark.parametrize("name,train", [("zoneout", False),
                                        ("vardrop", False),
                                        ("zoneout0", True),
                                        ("vardrop0", True)])
def test_modifier_cells_as_their_base_match_reference(name, train):
    x = _x(N, T, C, seed=6)
    outs = {}
    for tag, m in BOTH:
        cell = _modifier_pair(m, WRAPS[name])
        with m.autograd.record(train_mode=train):
            out, states = cell.unroll(T, m.nd.array(x), layout="NTC",
                                      merge_outputs=True)
        outs[tag] = [out.asnumpy()] + [s.asnumpy() for s in states]
    for w, g in zip(outs["ref"], outs["port"]):
        _close(w, g)


def test_zoneout_keeps_the_previous_output_at_its_rate():
    """Step 0's previous output is zeros: the share of zeros in it is the
    zoneout rate (4.5 sigma over 64 x 256 draws)."""
    p = 0.3
    cell = tmx.gluon.rnn.ZoneoutCell(tmx.gluon.rnn.GRUCell(256), p, 0.0)
    cell.initialize(tmx.init.Xavier())
    tmx.random.seed(4)
    with tmx.autograd.record():
        out, _ = cell.unroll(1, tmx.nd.array(_x(64, 1, 8, seed=7)),
                             layout="NTC")
    zero = (out.asnumpy() == 0).mean()
    n = 64 * 256
    assert abs(zero - p) < 4.5 * np.sqrt(p * (1 - p) / n)


def test_variational_dropout_reuses_one_mask_at_every_step():
    p = 0.5
    cell = tmx.gluon.contrib.rnn.VariationalDropoutCell(
        tmx.gluon.rnn.RNNCell(128), drop_inputs=p, drop_outputs=p)
    cell.initialize(tmx.init.Xavier())
    x = np.ones((64, 3, 8), np.float32)
    tmx.random.seed(5)
    masks = []
    with tmx.autograd.record():
        cell.unroll(3, tmx.nd.array(x), layout="NTC")
        masks.append(cell._input_mask.clone())
        mask_out = cell._output_mask
    kept = (masks[0] != 0).double().mean().item()
    assert abs(kept - (1 - p)) < 4.5 * np.sqrt(p * (1 - p) / masks[0].numel())
    assert mask_out.shape == (64, 128)
    # inputs of ones: every step's masked input is the one mask
    seen = []
    base = cell.base_cell
    orig = base.hybrid_forward

    def spy(F, inputs, states, **kw):
        seen.append(inputs.clone())
        return orig(F, inputs, states, **kw)
    base.hybrid_forward = spy
    tmx.random.seed(5)
    with tmx.autograd.record():
        cell.unroll(3, tmx.nd.array(x), layout="NTC")
    assert len(seen) == 3
    for s in seen:
        assert np.array_equal(s.numpy(), masks[0].numpy())
