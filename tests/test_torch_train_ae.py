"""``tools/train_ae.py`` held against ``examples/autoencoder/train_ae.py``
on the CPU.

Each package runs the example's pieces (its data, its ``AutoEncoder``,
its ``train`` loop of Adam steps under ``L2Loss``) at the example's
width: 4 batches of 64 of the plain model, then 4 of the sparse one
(``IdentityAttachKLSparseReg``).  Both iterators shuffle with the same
seed (the example's ``NDArrayIter(shuffle=True)`` draws a fresh one),
and ``mx.random.seed`` seeds both packages' Xavier draws.  Held: the
initial parameters bitwise, each batch's loss within 2e-5, the
parameters after the four steps within 5e-6 and the codes of 256 points
within 1e-5, each over the larger of 1 and the reference's largest
magnitude.  The tool at its defaults passes the example's two asserts.
"""
import numpy as np
import pytest

from test_torch_detection_train import (LOSS_TOL, PARAM_TOL, _Stop, _load,
                                        _within)
from test_torch_sparse_train import _quiet

CODE_TOL = 1e-5
STEPS = 4


def _seeded_shuffle(mx, monkeypatch):
    init = mx.io.NDArrayIter.__init__

    def seeded(self, *a, **k):
        k["shuffle_seed"] = 0
        init(self, *a, **k)
    monkeypatch.setattr(mx.io.NDArrayIter, "__init__", seeded)


def _run(mx, mod, monkeypatch):
    """{variant: (initial params, losses, final params, codes)} of the
    plain and the sparse model, each stopped after STEPS steps."""
    _seeded_shuffle(mx, monkeypatch)
    losses = []
    backward = mx.ndarray.NDArray.backward
    step = mx.gluon.Trainer.step

    def record(self, *a, **k):
        losses.append(self.asnumpy().copy())
        return backward(self, *a, **k)

    def counted(self, *a, **k):
        out = step(self, *a, **k)
        if len(losses) == STEPS:
            raise _Stop
        return out
    monkeypatch.setattr(mx.ndarray.NDArray, "backward", record)
    monkeypatch.setattr(mx.gluon.Trainer, "step", counted)
    mx.random.seed(0)
    X = mod.make_data(np.random.RandomState(0), 1024)
    out = {}
    for reg in (0.0, 0.05):
        net = mod.AutoEncoder(sparse_reg=reg)
        net.initialize(mx.init.Xavier())
        # the deferred shapes resolve at the first forward (no draw
        # before), as they do inside the first training step
        net(mx.nd.array(X[:2]))
        params = list(net.collect_params().values())
        first = [p.data().asnumpy().copy() for p in params]
        del losses[:]
        with pytest.raises(_Stop):
            mod.train(net, X, 1)
        code = net.encode(mx.nd.array(X[:256])).asnumpy()
        out[reg] = (first, list(losses),
                    [p.data().asnumpy() for p in params], code)
    monkeypatch.undo()
    return out


def test_train_ae_matches_reference_example(monkeypatch):
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.context import use
    from mxnet_tpu_torch.tools import train_ae
    example = _load("examples/autoencoder/train_ae.py", "examples_train_ae")
    want = _run(jmx, example, monkeypatch)
    with use("cpu"):
        got = _run(tmx, train_ae, monkeypatch)
    for reg in want:
        w0, wl, wp, wc = want[reg]
        g0, gl, gp, gc = got[reg]
        assert [a.shape for a in g0] == [a.shape for a in w0]
        for a, b in zip(g0, w0):
            np.testing.assert_array_equal(a, b)
        assert len(gl) == len(wl) == STEPS
        for a, b in zip(gl, wl):
            _within(a, b, LOSS_TOL)
        for a, b, b0 in zip(gp, wp, w0):
            _within(a, b, PARAM_TOL)
            assert not np.array_equal(b, b0)
        _within(gc, wc, CODE_TOL)


def test_tool_defaults_pass_the_examples_asserts():
    from mxnet_tpu_torch.tools import train_ae
    with _quiet():
        base, final, plain, sparse = train_ae.main(["--ctx", "cpu"])
    assert final < base * 0.25
    assert sparse < plain * 0.6
