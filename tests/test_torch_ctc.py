"""The CTC loss of mxnet_tpu_torch held against mxnet_tpu on the CPU:
the ``_contrib_ctc_loss`` op (``ops/contrib.py``) and its aliases, and
``gluon.loss.CTCLoss``.

- Both blank labels (``"first"``: blank 0, padding 0; ``"last"``: blank
  A - 1, padding -1), label lengths given or counted from the padding,
  data lengths given or T, repeated labels, an empty label, T = 1: losses
  within 1e-5 relative, gradients with respect to the activations within
  1e-5 (the softmax runs inside the op in both packages).
- A row whose labels need more frames than it has: both packages return
  the reference's sentinel loss, 1e30.  The reference's gradient there is
  an artifact of that sentinel (entries outside [-1, 1], which no
  softmax minus posterior reaches); the port's is zero (ROADMAP.md C7),
  and the feasible rows of the batch keep the reference's gradient.
- ``gluon.loss.CTCLoss`` in layouts NTC / TNC and NT / TN, with lengths
  and a sample weight: losses 1e-5, gradients 1e-5.
- ``nd.contrib.ctc_loss``, ``nd.CTCLoss`` and ``sym.contrib.ctc_loss``
  reach the same op; a symbol infers the loss's shape (batch,).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import contrib as jcontrib
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.ops import contrib as tcontrib

TOL = 1e-5
T, B, A, L = 10, 4, 6, 4


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _case(blank, seed=0, t=T, b=B, repeats=True):
    """Activations (t, b, A) and labels (b, L) padded for ``blank``, with
    label lengths 4, 2, 3, 0, ... and data lengths t, t - 2, ...."""
    rng = np.random.RandomState(seed)
    x = rng.randn(t, b, A).astype(np.float32)
    lo, hi = (1, A) if blank == "first" else (0, A - 1)
    lab = rng.randint(lo, hi, (b, L)).astype(np.float32)
    if repeats:
        lab[0, 1] = lab[0, 0]
    lab_len = np.array([4, 2, 3, 0, 1, 4][:b], np.float32)
    pad = 0 if blank == "first" else -1
    for i in range(b):
        lab[i, int(lab_len[i]):] = pad
    dat_len = np.array([t, t - 2, t, t - 1, t, t - 3][:b],
                       np.float32).clip(1)
    return x, lab, dat_len, lab_len


def _reference(x, lab, dl, ll, **kw):
    args = [jnp.asarray(x), jnp.asarray(lab),
            None if dl is None else jnp.asarray(dl),
            None if ll is None else jnp.asarray(ll)]

    def f(d):
        return jcontrib.ctc_loss(d, *args[1:], **kw)
    loss, vjp = jax.vjp(f, args[0])
    (g,) = vjp(jnp.ones_like(loss))
    return np.asarray(loss), np.asarray(g)


def _port(x, lab, dl, ll, **kw):
    d = torch.tensor(x, requires_grad=True)
    loss = tcontrib.ctc_loss(
        d, torch.from_numpy(lab), None if dl is None else
        torch.from_numpy(dl), None if ll is None else torch.from_numpy(ll),
        **kw)
    (g,) = torch.autograd.grad(loss.sum(), d)
    return loss.detach().numpy(), g.numpy()


def _held(want, got):
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=TOL, atol=TOL)


# each blank with each length option given and inferred
OPTIONS = [("first", False, False), ("first", True, True),
           ("last", False, True), ("last", True, False)]


@pytest.mark.parametrize("blank,use_dl,use_ll", OPTIONS,
                         ids=["%s-dl%d-ll%d" % o for o in OPTIONS])
def test_ctc_loss_matches_reference(blank, use_dl, use_ll):
    x, lab, dl, ll = _case(blank)
    kw = dict(blank_label=blank, use_data_lengths=use_dl,
              use_label_lengths=use_ll)
    args = (x, lab, dl if use_dl else None, ll if use_ll else None)
    want, got = _reference(*args, **kw), _port(*args, **kw)
    assert got[0].shape == (B,)
    assert np.isfinite(got[0]).all() and (got[0] < 1e29).all()
    _held(want, got)


def test_ctc_loss_one_frame():
    x, lab, _, _ = _case("first", seed=1, t=1, b=3, repeats=False)
    lab[:, 1:] = 0
    lab[2, 0] = 0       # an empty label: every frame blank
    want, got = _reference(x, lab, None, None), _port(x, lab, None, None)
    _held(want, got)


def test_infeasible_rows_take_the_sentinel_loss_and_no_gradient():
    """Row 0: 4 labels in 3 frames; row 1: 1, 1 (a repeat needs a blank
    between) in 2 usable frames of 3; row 2 feasible."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 3, A).astype(np.float32)
    lab = np.array([[1, 2, 3, 4], [1, 1, 0, 0], [2, 3, 0, 0]], np.float32)
    dl = np.array([3, 2, 3], np.float32)
    kw = dict(use_data_lengths=True)
    want, got = _reference(x, lab, dl, None, **kw), _port(x, lab, dl, None,
                                                          **kw)
    np.testing.assert_array_equal(got[0][:2], np.float32(1e30))
    np.testing.assert_array_equal(want[0][:2], np.float32(1e30))
    np.testing.assert_allclose(got[0][2], want[0][2], rtol=TOL)
    # the feasible row: the reference's gradient
    np.testing.assert_allclose(got[1][:, 2], want[1][:, 2], rtol=TOL,
                               atol=TOL)
    # the infeasible rows: the reference's gradient leaves [-1, 1], the
    # bounds of softmax minus a posterior; the port's is zero
    assert np.abs(want[1][:, :2]).max() > 1.0
    np.testing.assert_array_equal(got[1][:, :2], 0.0)
    assert tcontrib.ctc_infeasible(
        torch.tensor(lab).long(), torch.tensor([4, 2, 2]),
        torch.tensor([3, 2, 3])).tolist() == [True, True, False]


GLUON = [("NTC", "NT", False), ("TNC", "TN", True)]


@pytest.mark.parametrize("layout,label_layout,lengths", GLUON,
                         ids=["%s-%s-len%d" % g for g in GLUON])
def test_gluon_ctc_loss_matches_reference(layout, label_layout, lengths):
    x, lab, dl, ll = _case("last", seed=3)
    if layout == "NTC":
        x = x.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        lab = lab.T.copy()
    sw = np.random.RandomState(4).rand(B).astype(np.float32)
    out = {}
    for tag, m in (("ref", mx), ("port", tmx)):
        loss = m.gluon.loss.CTCLoss(layout=layout, label_layout=label_layout,
                                    weight=0.5)
        xd = m.nd.array(x)
        xd.attach_grad()
        extra = [m.nd.array(dl), m.nd.array(ll)] if lengths else []
        with m.autograd.record():
            if lengths:
                v = loss(xd, m.nd.array(lab), *extra,
                         sample_weight=m.nd.array(sw))
            else:
                v = loss(xd, m.nd.array(lab))
        v.backward()
        out[tag] = (v.asnumpy(), xd.grad.asnumpy())
    assert out["port"][0].shape == (B,)
    _held(out["ref"], out["port"])


def test_the_op_names_reach_one_op():
    x, lab, _, _ = _case("first", seed=5)
    want = tcontrib.ctc_loss(torch.from_numpy(x), torch.from_numpy(lab))
    for f in (tmx.nd.contrib.ctc_loss, tmx.nd.contrib.CTCLoss,
              tmx.nd.CTCLoss, tmx.nd.ctc_loss):
        got = f(tmx.nd.array(x), tmx.nd.array(lab))
        np.testing.assert_array_equal(got.asnumpy(), want.numpy())
    data, label = tmx.sym.Variable("data"), tmx.sym.Variable("label")
    net = tmx.sym.MakeLoss(tmx.sym.contrib.ctc_loss(data, label))
    _, outs, _ = net.infer_shape(data=(T, B, A), label=(B, L))
    assert outs == [(B,)]
    ex = net.bind("cpu", {"data": tmx.nd.array(x),
                          "label": tmx.nd.array(lab)})
    np.testing.assert_array_equal(ex.forward()[0].asnumpy(), want.numpy())
