"""mxnet_tpu_torch.serialization held against mxnet_tpu.serialization.

The same arrays saved by both packages, in both formats (the reference
MXNet dmlc stream and ``MXTPUND1``), must be the same bytes, and each
package must load the other's file to the same values (dtypes and
shapes included; bfloat16 kept in ``MXTPUND1`` and widened to float32 in
the dmlc stream, bool written as uint8 there, a 0-dim array as shape
(1,)).  The legacy V1 and pre-V1 records of the dmlc stream load too.
Trainer states files cross both ways: states saved by either package's
``Trainer.save_states`` load into the other's, and the next step there
matches the step the saving side takes (1e-6, f32).
"""
import struct
import tempfile

import ml_dtypes
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.gluon.utils import from_jax_params

FORMATS = ["mxtpu", "mxnet"]


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _arrays():
    rng = np.random.RandomState(0)
    return {
        "w": rng.randn(3, 4).astype(np.float32),
        "h": rng.randn(5).astype(np.float16),
        "i": rng.randint(-9, 9, (2, 2)).astype(np.int32),
        "b": rng.randint(0, 255, (4,)).astype(np.uint8),
        "c": rng.randint(-9, 9, (3,)).astype(np.int8),
        "m": rng.rand(2, 3) > 0.5,
        "z": np.float32(2.5).reshape(()),
        "bf": rng.randn(2, 3).astype(np.float32),
    }


def _ref(a):
    if a.dtype == np.bool_:
        return mx.nd.array(a, dtype=np.bool_)
    return mx.nd.array(a, dtype=a.dtype)


def _port(a, name):
    return nd.array(a, dtype="bfloat16" if name == "bf" else a.dtype)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("as_list", [False, True])
def test_files_are_byte_identical_and_cross_load(fmt, as_list):
    arrays = _arrays()
    ref = {k: _ref(v) for k, v in arrays.items()}
    ref["bf"] = mx.nd.array(arrays["bf"]).astype(ml_dtypes.bfloat16)
    port = {k: _port(v, k) for k, v in arrays.items()}
    if as_list:
        ref, port = list(ref.values()), list(port.values())
    with tempfile.TemporaryDirectory() as d:
        mx.nd.save(d + "/ref", ref, format=fmt)
        nd.save(d + "/port", port, format=fmt)
        assert _read(d + "/ref") == _read(d + "/port")
        got = nd.load(d + "/ref", ctx="cpu")
        back = mx.nd.load(d + "/port")
    if as_list:
        ref = dict(zip(arrays, ref))
        got = dict(zip(arrays, got))
        back = dict(zip(arrays, back))
    for k in arrays:
        want = np.asarray(ref[k].asnumpy())
        if k == "bf":
            want = want.astype(np.float32)
        if fmt == "mxnet":
            want = want.reshape(want.shape or (1,))
            if want.dtype == np.bool_:
                want = want.astype(np.uint8)
        g, b = got[k].asnumpy(), np.asarray(back[k].asnumpy())
        np.testing.assert_array_equal(g, want, err_msg=k)
        np.testing.assert_array_equal(b.astype(g.dtype), g, err_msg=k)
        assert g.shape == b.shape, k
        if k != "bf":
            assert g.dtype == b.dtype == want.dtype, k
    assert got["bf"].dtype == ("bfloat16" if fmt == "mxtpu" else
                               np.float32)


def test_legacy_records_load():
    """A V1 record (int64 shape) and a pre-V1 record (the magic is ndim,
    uint32 dims), written by hand as old MXNet wrote them."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    with tempfile.TemporaryDirectory() as d:
        path = d + "/legacy"
        with open(path, "wb") as f:
            f.write(struct.pack("<QQQ", 0x112, 0, 2))
            f.write(struct.pack("<IIqq", 0xF993FAC8, 2, 2, 3))
            f.write(struct.pack("<iii", 1, 0, 0))
            f.write(a.tobytes())
            f.write(struct.pack("<III", 2, 2, 3))
            f.write(struct.pack("<iii", 1, 0, 0))
            f.write((a * 2).tobytes())
            f.write(struct.pack("<Q", 0))
        got = nd.load(path, ctx="cpu")
        want = mx.nd.load(path)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


def test_bad_files_raise():
    with tempfile.TemporaryDirectory() as d:
        with open(d + "/junk", "wb") as f:
            f.write(b"not a params file")
        with pytest.raises(ValueError, match="not an NDArray params file"):
            nd.load(d + "/junk", ctx="cpu")
        with pytest.raises(TypeError, match="no slot"):
            nd.save(d + "/x", [nd.array(np.zeros(2), dtype="int16")],
                    format="mxnet")


def _net(pkg):
    net = pkg.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.nn.Dense(6, activation="relu"), pkg.nn.Dense(3))
    return net


def _step(pkg, net, tr, x, y):
    ag = mx.autograd if pkg is jgluon else autograd
    arr = mx.nd.array if pkg is jgluon else nd.array
    with ag.record():
        L = pkg.loss.SoftmaxCrossEntropyLoss()(net(arr(x)), arr(y))
    L.backward()
    tr.step(x.shape[0])


def _weights(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


def _pair(x):
    np.random.seed(0)
    jnet = _net(jgluon)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.array(x))
    arrays = {n: p.data().asnumpy() for n, p in
              jnet.collect_params().items()}
    return jnet, from_jax_params(_net(gluon), arrays, device="cpu")


SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}


@pytest.mark.parametrize("saver", ["ref", "port"])
def test_trainer_states_cross_both_ways(saver):
    """Both sides train two SGD+momentum steps; the saver's states go into
    a fresh Trainer of the other package (whose own states are then
    nothing but the file's), and its next step matches the saver's."""
    rng = np.random.RandomState(1)
    x = rng.rand(4, 5).astype(np.float32)
    y = rng.randint(0, 3, 4).astype(np.float32)
    jnet, tnet = _pair(x)
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(SGD))
    ttr = gluon.Trainer(tnet.collect_params(), "sgd", dict(SGD))
    for _ in range(2):
        _step(jgluon, jnet, jtr, x, y)
        _step(gluon, tnet, ttr, x, y)
    with tempfile.TemporaryDirectory() as d:
        path = d + "/states"
        if saver == "ref":
            jtr.save_states(path)
            ttr = gluon.Trainer(tnet.collect_params(), "sgd", dict(SGD))
            ttr.load_states(path)
        else:
            ttr.save_states(path)
            jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(SGD))
            jtr.load_states(path)
    _step(jgluon, jnet, jtr, x, y)
    _step(gluon, tnet, ttr, x, y)
    for a, b in zip(_weights(jnet), _weights(tnet)):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("route", [False, True])
def test_states_round_trip_is_bitwise(route):
    """save_states -> load_states into a fresh Trainer, then one step: the
    same bits as the uninterrupted run (both update_on_kvstore routes)."""
    rng = np.random.RandomState(2)
    x = rng.rand(4, 5).astype(np.float32)
    y = rng.randint(0, 3, 4).astype(np.float32)
    _, a = _pair(x)
    _, b = _pair(x)
    ta = gluon.Trainer(a.collect_params(), "sgd", dict(SGD),
                       update_on_kvstore=route)
    tb = gluon.Trainer(b.collect_params(), "sgd", dict(SGD),
                       update_on_kvstore=route)
    for _ in range(2):
        _step(gluon, a, ta, x, y)
        _step(gluon, b, tb, x, y)
    with tempfile.TemporaryDirectory() as d:
        tb.save_states(d + "/s")
        tb = gluon.Trainer(b.collect_params(), "sgd", dict(SGD),
                           update_on_kvstore=route)
        tb.load_states(d + "/s")
    _step(gluon, a, ta, x, y)
    _step(gluon, b, tb, x, y)
    for wa, wb in zip(_weights(a), _weights(b)):
        np.testing.assert_array_equal(wa, wb)
