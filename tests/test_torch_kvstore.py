"""mxnet_tpu_torch.kvstore held against mxnet_tpu.kvstore (one process).

``init`` / ``push`` (a list summed per key) / ``pull``, a store-side
optimizer (``set_optimizer``) and updater (``set_updater``), 2-bit
gradient compression with error feedback, and the optimizer states'
files, with the same seeded arrays through both packages: 1e-6 (f32).
The 'dist' types raise, naming ROADMAP.md queue A, item 6.
"""
import tempfile

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import kvstore as jkv
from mxnet_tpu_torch import kvstore, nd
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import use

TOL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _vals(n, seed=0, shape=(2, 3)):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _close(want, got):
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("kv_type", ["local", "device"])
def test_push_sums_and_pull_copies(kv_type):
    init, = _vals(1)
    grads = _vals(3, seed=1)
    stores = []
    for kvmod, arr in ((jkv, mx.nd.array), (kvstore, nd.array)):
        kv = kvmod.create(kv_type)
        assert kv.type == kv_type and kv.rank == 0 and kv.num_workers == 1
        kv.init(3, arr(init))
        kv.init(["a", "b"], [arr(init), arr(init * 2)])
        kv.push(3, [arr(g) for g in grads])
        kv.push(["a", "b"], [[arr(grads[0])], [arr(grads[1]),
                                                arr(grads[2])]])
        outs = [arr(np.zeros((2, 3), np.float32)) for _ in range(4)]
        kv.pull(3, out=outs[:2])
        kv.pull(["a", "b"], out=outs[2:])
        stores.append(outs)
    for w, g in zip(*stores):
        _close(w, g)
    np.testing.assert_allclose(stores[1][0].asnumpy(), sum(grads),
                               rtol=TOL)


def test_pull_is_a_copy_and_init_twice_raises():
    kv = kvstore.create("device")
    kv.init(0, nd.ones((2,)))
    out = nd.zeros((2,))
    kv.pull(0, out=out)
    kv.push(0, nd.full((2,), 5.0))
    np.testing.assert_array_equal(out.asnumpy(), [1.0, 1.0])
    with pytest.raises(MXNetError, match="already initialized"):
        kv.init(0, nd.ones((2,)))
    with pytest.raises(MXNetError, match="not initialized"):
        kv.push(9, nd.ones((2,)))


@pytest.mark.parametrize("opt,kw", [("sgd", {"learning_rate": 0.1,
                                             "momentum": 0.9, "wd": 1e-3}),
                                    ("adam", {"learning_rate": 0.01})])
def test_store_side_optimizer_matches_reference(opt, kw):
    w0, = _vals(1, seed=2)
    grads = _vals(3, seed=3)
    got = []
    for kvmod, optmod, arr in ((jkv, mx.optimizer, mx.nd.array),
                               (kvstore, topt, nd.array)):
        kv = kvmod.create("device")
        kv.init(0, arr(w0))
        kv.set_optimizer(optmod.create(opt, **kw))
        assert kv.has_updater
        for g in grads:
            kv.push(0, arr(g))
        out = arr(np.zeros_like(w0))
        kv.pull(0, out=out)
        with tempfile.TemporaryDirectory() as d:
            kv.save_optimizer_states(d + "/s")
            kv.load_optimizer_states(d + "/s")
        kv.push(0, arr(grads[0]))
        kv.pull(0, out=out)
        got.append(out)
    _close(*got)


def test_set_updater_runs_at_push():
    seen = []

    def updater(key, grad, stored):
        seen.append(key)
        stored[:] = stored.asnumpy() - 0.5 * grad.asnumpy()

    kv = kvstore.create()
    kv.init("w", nd.ones((3,)))
    kv.set_updater(updater)
    kv.push("w", [nd.ones((3,)), nd.ones((3,))])
    out = nd.zeros((3,))
    kv.pull("w", out=out)
    assert seen == ["w"]
    np.testing.assert_array_equal(out.asnumpy(), [0.0, 0.0, 0.0])


def test_gradient_compression_matches_reference():
    grads = _vals(4, seed=4)
    outs = []
    for kvmod, arr in ((jkv, mx.nd.array), (kvstore, nd.array)):
        kv = kvmod.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init(0, arr(np.zeros((2, 3), np.float32)))
        seq = []
        for g in grads:
            kv.push(0, arr(g))
            out = arr(np.zeros((2, 3), np.float32))
            kv.pull(0, out=out)
            seq.append(out)
        outs.append(seq)
    for w, g in zip(*outs):
        _close(w, g)
    with pytest.raises(ValueError):
        kvstore.create().set_gradient_compression({"type": "1bit"})


@pytest.mark.parametrize("name", ["dist_sync", "dist_device_sync",
                                  "dist_async", "dist"])
def test_dist_types_name_their_roadmap_item(name):
    with pytest.raises(NotImplementedError, match="item 6"):
        kvstore.create(name)


def test_unknown_types_and_missing_optimizer_raise():
    with pytest.raises(MXNetError):
        kvstore.create("nope")
    with pytest.raises(TypeError):
        kvstore.create(3)
    with pytest.raises(MXNetError, match="no optimizer"):
        kvstore.create().save_optimizer_states("/nonexistent/x")
