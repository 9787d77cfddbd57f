"""mxnet_tpu_torch.autograd held against mxnet_tpu.autograd.

The same seeded arrays go through both packages' recording scopes:
first-order gradients written by ``backward`` (``grad_req`` "write" and
"add" over two calls), head gradients, second-order gradients through
``grad(create_graph=True)``, ``pause`` inside ``record``, a custom
``Function``, and the training flag BatchNorm reads under
``record(train_mode=False)`` and ``pause(train_mode=True)``.  Tolerance:
1e-5 (f32).  The port's own rules are checked beside: ``backward`` on an
unrecorded head raises, ``retain_graph=False`` frees the graph, and an
in-place write while recording leaves the values the tape saved alone.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.gluon.utils import from_jax_params

TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _x(seed=0, shape=(3, 4)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(a):
    j, t = mx.nd.array(a), nd.array(a)
    j.attach_grad()
    t.attach_grad()
    return j, t


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=tol,
                               atol=tol)


def _f(x, w):
    """A chain of the ported ops: matmul, tanh, scalar arithmetic, an
    elementwise power and a reduction."""
    return ((x.dot(w).tanh() * 2 - 1) ** 2).sum(axis=1) / 3


@pytest.mark.parametrize("head", [False, True])
def test_first_order_gradients_match_reference(head):
    jx, tx = _both(_x(1))
    jw, tw = _both(_x(2, (4, 5)))
    with mx.autograd.record():
        jy = _f(jx, jw)
    with autograd.record():
        ty = _f(tx, tw)
    _close(jy, ty)
    hg = _x(3, (3,))
    if head:
        jy.backward(mx.nd.array(hg))
        ty.backward(nd.array(hg))
    else:
        mx.autograd.backward([jy])
        autograd.backward([ty])
    _close(jx.grad, tx.grad)
    _close(jw.grad, tw.grad)


def test_grad_req_add_accumulates_over_two_backwards():
    jx, tx = _both(_x(4))
    jx.attach_grad(grad_req="add")
    tx.attach_grad(grad_req="add")
    for scale in (1.0, 3.0):
        with mx.autograd.record():
            jy = (jx * jx * scale).sum()
        with autograd.record():
            ty = (tx * tx * scale).sum()
        jy.backward()
        ty.backward()
        _close(jx.grad, tx.grad)
    np.testing.assert_allclose(tx.grad.asnumpy(), 8 * _x(4), rtol=TOL)
    # "write" overwrites instead
    jx.attach_grad()
    tx.attach_grad()
    for _ in range(2):
        with autograd.record():
            ty = (tx * 5).sum()
        ty.backward()
    np.testing.assert_array_equal(tx.grad.asnumpy(), np.full((3, 4), 5.0))


def test_parameter_grad_req_add_over_two_backwards():
    net = gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx="cpu", rng=np.random.RandomState(0))
    net.collect_params().setattr("grad_req", "add")
    x = nd.array(_x(5))
    for _ in range(2):
        with autograd.record():
            y = net(x).sum()
        y.backward()
    want = 2 * _x(5).sum(axis=0)
    np.testing.assert_allclose(net.weight.grad().asnumpy(),
                               np.tile(want, (3, 1)), rtol=TOL, atol=TOL)
    net.collect_params().zero_grad()
    assert not net.weight.grad().asnumpy().any()


def test_second_order_gradients_match_reference():
    jx, tx = _both(_x(6))
    with mx.autograd.record():
        jy = (jx ** 3).sum() + (jx * jx).sum()
        jg = mx.autograd.grad(jy, [jx], create_graph=True)[0]
        jz = (jg * jg).sum()
    jz.backward()
    with autograd.record():
        ty = (tx ** 3).sum() + (tx * tx).sum()
        tg = autograd.grad(ty, [tx], create_graph=True)[0]
        tz = (tg * tg).sum()
    tz.backward()
    _close(jg, tg)
    _close(jx.grad, tx.grad)
    # grad of an interior node, without create_graph: a plain value
    with autograd.record():
        h = tx * 2
        out = (h * h).sum()
    gh = autograd.grad(out, h)
    np.testing.assert_allclose(gh.asnumpy(), 4 * _x(6), rtol=TOL)
    assert not gh._data.requires_grad


def test_pause_excludes_ops_from_the_graph():
    jx, tx = _both(_x(7))
    with mx.autograd.record():
        jy = jx * 2
        with mx.autograd.pause():
            jc = jx * 10
        jz = (jy * jc).sum()
    jz.backward()
    with autograd.record():
        ty = tx * 2
        with autograd.pause():
            tc = tx * 10
        assert not tc._data.requires_grad
        tz = (ty * tc).sum()
    tz.backward()
    _close(jx.grad, tx.grad)


def test_custom_function_matches_reference():
    def make(base):
        class Sigmoid(base):
            def forward(self, x):
                y = 1 / (1 + (-x).exp())
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                (y,) = self.saved_tensors
                return dy * y * (1 - y) * 2   # a deliberate factor 2

        return Sigmoid()

    jx, tx = _both(_x(8))
    with mx.autograd.record():
        jy = make(mx.autograd.Function)(jx)
        jz = (jy * jy).sum()
    jz.backward()
    with autograd.record():
        ty = make(autograd.Function)(tx)
        tz = (ty * ty).sum()
    tz.backward()
    _close(jy, ty)
    _close(jx.grad, tx.grad)
    # outside record the function is its forward
    out = make(autograd.Function)(nd.array(_x(8)))
    _close(jy, out)


def test_backward_on_an_unrecorded_head_raises():
    x = nd.array(_x(9))
    x.attach_grad()
    y = (x * 2).sum()           # outside record()
    with pytest.raises(MXNetError, match="outside autograd.record"):
        y.backward()
    with autograd.record():
        z = nd.array(_x(9)) * 2  # recorded, but of no variable
    with pytest.raises(MXNetError):
        z.backward()


def test_retain_graph_false_frees_the_graph():
    x = nd.array(_x(10))
    x.attach_grad()
    with autograd.record():
        y = (x.exp() * x).sum()
    y.backward(retain_graph=True)
    first = x.grad.asnumpy()
    y.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), first)
    with pytest.raises(RuntimeError):
        y.backward()


def test_inplace_write_while_recording_keeps_saved_values():
    jx, tx = _both(_x(11))
    with mx.autograd.record():
        jh = jx * 3
        jy = (jh * jh).sum()
    with autograd.record():
        th = tx * 3
        ty = (th * th).sum()     # the tape saved th
        th += 100.0
        th[0] = -5.0
    jy.backward()
    ty.backward()
    _close(jx.grad, tx.grad)


def test_scopes_set_and_restore_the_flags():
    assert not autograd.is_recording() and not autograd.is_training()
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        with autograd.pause():
            assert not autograd.is_recording()
            assert not autograd.is_training()
        with autograd.predict_mode():
            assert autograd.is_recording() and not autograd.is_training()
    with autograd.train_mode():
        assert autograd.is_training() and not autograd.is_recording()
    assert autograd.set_recording(True) is False
    assert autograd.set_training(True) is False
    autograd.set_recording(False)
    autograd.set_training(False)
    with pytest.raises(NotImplementedError, match="symbolic graphs"):
        autograd.get_symbol(nd.zeros((1,)))


def test_mark_variables_writes_into_the_given_buffers():
    x = nd.array(_x(12))
    buf = nd.zeros((3, 4))
    autograd.mark_variables([x], [buf])
    with autograd.record():
        y = (x * x).sum()
    autograd.backward(y)
    np.testing.assert_allclose(buf.asnumpy(), 2 * _x(12), rtol=TOL)


def _bn_pair():
    jbn = jgluon.nn.BatchNorm(in_channels=3)
    jbn.initialize()
    x = _x(13, (4, 3, 2, 2))
    jbn(mx.nd.array(x))
    tbn = gluon.nn.BatchNorm(in_channels=3)
    arrays = {n: p.data().asnumpy() for n, p in jbn.collect_params().items()}
    from_jax_params(tbn, arrays, device="cpu")
    return jbn, tbn, x


@pytest.mark.parametrize("scope", ["record_train", "record_predict",
                                   "pause_train", "pause", "none"])
def test_batchnorm_follows_the_autograd_training_flag(scope):
    """The moving statistics update exactly when the reference's do; the
    output is normalized by the batch or the moving statistics to
    match."""
    jbn, tbn, x = _bn_pair()
    scopes = {"record_train": lambda ag: ag.record(),
              "record_predict": lambda ag: ag.record(train_mode=False),
              "pause_train": lambda ag: ag.pause(train_mode=True),
              "pause": lambda ag: ag.pause(),
              "none": lambda ag: ag.predict_mode()}
    with scopes[scope](mx.autograd):
        jy = jbn(mx.nd.array(x))
    tbn.train(scope == "none")      # the module flag must not matter
    with scopes[scope](autograd):
        ty = tbn(nd.array(x))
    assert isinstance(ty, nd.NDArray)
    _close(jy, ty)
    _close(jbn.running_mean.data(), tbn.running_mean.data())
    _close(jbn.running_var.data(), tbn.running_var.data())
    moved = not np.array_equal(tbn.running_mean.data().asnumpy(),
                               np.zeros(3, np.float32))
    assert moved == (scope in ("record_train", "pause_train"))
