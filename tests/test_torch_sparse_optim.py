"""The row-sparse update paths of mxnet_tpu_torch held against mxnet_tpu on
the CPU: the optimizers' lazy row-wise rules (``optimizer.py``) and the
local kvstore's sparse half (``kvstore.py``).

- SGD with and without momentum, Adam and AdaGrad on a row-sparse
  gradient, with wd, ``rescale_grad`` and ``clip_gradient`` off and on,
  two steps through each package's updater: weights and states within
  1e-6 of the larger of 1 and the reference's largest magnitude; the rows
  the gradients do not hold bitwise unchanged, in the weight and in every
  state.  ``_sparse_adagrad_update`` (the dense rule) is held beside
  AdaGrad's row-wise one: equal on the rows a gradient holds.
- A gradient that holds one row twice: the weight takes both steps and
  the state the last one, in both packages (weight 1, gradients 1 and 2
  on row 1, lr 1, momentum 0.9: weight -2, momentum -2).
- The kvstore: a push of several row-sparse values (merged over the union
  of their rows), a push to a store with an optimizer (the row-wise
  update) and without one (the value densified and stored), and
  ``row_sparse_pull`` into row-sparse outs (the unique rows, sorted) and
  into dense outs (a copy of the whole value, not an alias).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import kvstore as jkv
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu_torch import kvstore as tkv, nd
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.ndarray import sparse as tsp

TOL = 1e-6
SHAPE = (8, 3)
ROWS = ([1, 4, 6], [0, 4])


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _within(got, want, tol=TOL):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _grads(seed=0):
    """Two row-sparse gradients (rows ``ROWS``) as (values, indices)."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(len(r), SHAPE[1]).astype(np.float32) * 2,
             np.array(r, np.int64)) for r in ROWS]


def _rsp(sp, vals, idx, array):
    return sp.RowSparseNDArray(array(vals), array(idx), SHAPE)


def _t_array(x):
    return nd.array(x, ctx="cpu", dtype=x.dtype)


def _j_array(x):
    return jmx.nd.array(x, dtype=x.dtype)


def _states(s):
    if s is None:
        return []
    if isinstance(s, tuple):
        return [x for x in s if x is not None]
    return [s]


def _run(pkg, name, kw, w0, grads):
    """Two steps of optimizer ``name`` through ``pkg``'s updater; (weight,
    states, weight after the first step)."""
    mod, sp, array = ((jmx.optimizer, jsp, _j_array) if pkg == "ref"
                      else (topt, tsp, _t_array))
    up = mod.get_updater(mod.create(name, **kw))
    w = array(w0)
    after = []
    for vals, idx in grads:
        up(0, _rsp(sp, vals, idx, array), w)
        after.append(w.asnumpy().copy())
    return w.asnumpy(), [_host(s) for s in _states(up.states[0])], after


CASES = {
    "sgd": dict(learning_rate=0.1),
    "sgd_mom": dict(learning_rate=0.1, momentum=0.9),
    "adam": dict(learning_rate=0.01),
    "adagrad": dict(learning_rate=0.1),
}
KNOBS = {"plain": {}, "wd_rescale_clip": dict(wd=0.01, rescale_grad=0.5,
                                              clip_gradient=0.7)}


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_row_sparse_update_matches_reference(case, knobs):
    name = "sgd" if case.startswith("sgd") else case
    kw = dict(CASES[case], **KNOBS[knobs])
    w0 = np.random.RandomState(1).randn(*SHAPE).astype(np.float32)
    grads = _grads()
    jw, js, jafter = _run("ref", name, kw, w0, grads)
    tw, ts, tafter = _run("port", name, kw, w0, grads)
    _within(tw, jw)
    assert len(ts) == len(js)
    for t, j in zip(ts, js):
        _within(t, j)
    # rows no gradient holds: weight and states bitwise untouched
    untouched = sorted(set(range(SHAPE[0])) - set(sum(ROWS, [])))
    assert tw[untouched].tobytes() == w0[untouched].tobytes()
    for t in ts:
        assert not t[untouched].any()
    first = sorted(set(range(SHAPE[0])) - set(ROWS[0]))
    assert tafter[0][first].tobytes() == w0[first].tobytes()
    assert not np.array_equal(tw[ROWS[0]], w0[ROWS[0]])


def test_adagrad_row_wise_equals_the_dense_op_on_held_rows():
    """AdaGrad's row-wise rule on a row-sparse gradient is the
    ``_sparse_adagrad_update`` op's dense rule on the rows it holds (a
    dense gradient of zeros elsewhere moves nothing: AdaGrad's step is
    g / sqrt(h))."""
    w0 = np.random.RandomState(2).randn(*SHAPE).astype(np.float32)
    (vals, idx), _ = _grads(3)
    kw = dict(lr=0.1, epsilon=1e-7, wd=0.0, rescale_grad=0.5,
              clip_gradient=0.7)
    dense_g = np.zeros(SHAPE, np.float32)
    dense_g[idx] = vals
    h0 = np.zeros(SHAPE, np.float32)
    w_op = nd.array(w0)
    h_op = nd.array(h0)
    nd.sparse_adagrad_update(w_op, nd.array(dense_g), h_op, out=w_op, **kw)
    opt = topt.create("adagrad", learning_rate=0.1, rescale_grad=0.5,
                      clip_gradient=0.7)
    w = torch.from_numpy(w0.copy())
    h = torch.zeros(SHAPE)
    opt.update(0, w, _rsp(tsp, vals, idx, _t_array), h)
    _within(w.numpy(), w_op.asnumpy())
    _within(h.numpy(), h_op.asnumpy())


@pytest.mark.parametrize("name", ["sgd", "adam", "adagrad"])
def test_repeated_row_adds_the_weight_and_sets_the_state_last(name):
    """Row 1 held twice (gradients 1 and 2): the weight takes both steps,
    each state the later one's value, in both packages (the reference's
    ``.at[].add`` / ``.at[].set`` on the CPU; the port writes the last
    value explicitly, so the card's unordered writes give it too)."""
    kw = dict(learning_rate=1.0, momentum=0.9) if name == "sgd" \
        else dict(learning_rate=1.0)
    vals = np.array([[1.0], [2.0]], np.float32)
    idx = np.array([1, 1], np.int64)
    got = {}
    for pkg, mod, sp, array in (("ref", jmx.optimizer, jsp, _j_array),
                                ("port", topt, tsp, _t_array)):
        up = mod.get_updater(mod.create(name, **kw))
        w = array(np.ones((3, 1), np.float32))
        up(0, sp.RowSparseNDArray(array(vals), array(idx), (3, 1)), w)
        got[pkg] = (w.asnumpy(), [_host(s) for s in _states(up.states[0])])
    for t, j in zip([got["port"][0]] + got["port"][1],
                    [got["ref"][0]] + got["ref"][1]):
        _within(t, j)
    if name == "sgd":
        # weight 1 - 1 - 2 = -2; momentum -2 (the second gradient's)
        np.testing.assert_array_equal(got["port"][0][:, 0], [1.0, -2.0, 1.0])
        np.testing.assert_array_equal(got["port"][1][0][:, 0],
                                      [0.0, -2.0, 0.0])


def test_gradient_on_another_device_raises():
    opt = topt.create("sgd", learning_rate=0.1)
    g = tsp.RowSparseNDArray(
        nd.NDArray(torch.empty((1, 3), device="meta")),
        nd.NDArray(torch.empty(1, dtype=torch.int64, device="meta")), SHAPE)
    with pytest.raises(MXNetError, match="row-sparse gradient"):
        opt.update(0, torch.zeros(SHAPE), g, None)


# -- the kvstore's sparse half ------------------------------------------------
def _stores(optimizer):
    """Both packages' local stores holding key "w" (and "d", no
    optimizer) from the same values."""
    w0 = np.random.RandomState(4).randn(*SHAPE).astype(np.float32)
    out = {}
    for pkg, kvmod, array in (("ref", jkv, _j_array),
                              ("port", tkv, _t_array)):
        kv = kvmod.create("local")
        kv.init("w", array(w0))
        if optimizer:
            kv.set_optimizer(optimizer())
        out[pkg] = (kv, array)
    return out, w0


@pytest.mark.parametrize("optimizer", ["none", "sgd"])
def test_push_of_row_sparse_values_matches_reference(optimizer):
    make = None if optimizer == "none" else (
        lambda: jmx.optimizer.create("sgd", learning_rate=0.5))
    stores, w0 = _stores(make)
    if make is not None:
        stores["port"][0].set_optimizer(topt.create("sgd",
                                                    learning_rate=0.5))
    grads = _grads(5)
    got = {}
    for pkg, (kv, array) in stores.items():
        sp = jsp if pkg == "ref" else tsp
        # a list of values: merged over the union of their rows
        kv.push("w", [_rsp(sp, v, i, array) for v, i in grads])
        out = array(np.zeros(SHAPE, np.float32))
        kv.pull("w", out=out)
        got[pkg] = out.asnumpy()
    _within(got["port"], got["ref"])
    held = sorted(set(sum(ROWS, [])))
    other = sorted(set(range(SHAPE[0])) - set(held))
    if make is None:
        # no updater: the merged value, densified, replaces the stored one
        assert not got["port"][other].any()
    else:
        assert got["port"][other].tobytes() == w0[other].tobytes()
    merged = tkv.KVStore._merge([_rsp(tsp, v, i, _t_array)
                                 for v, i in grads])
    assert merged.indices.asnumpy().tolist() == held


def test_row_sparse_pull_matches_reference():
    stores, w0 = _stores(None)
    ids = np.array([6, 1, 6, 3], np.float32)
    got = {}
    for pkg, (kv, array) in stores.items():
        sp = jsp if pkg == "ref" else tsp
        rsp_outs = [sp.zeros("row_sparse", SHAPE) if pkg == "ref" else
                    sp.zeros("row_sparse", SHAPE, ctx="cpu")
                    for _ in range(2)]
        dense = array(np.zeros(SHAPE, np.float32))
        kv.row_sparse_pull("w", out=rsp_outs + [dense],
                           row_ids=[array(ids), array(ids[:1]),
                                    array(ids)])
        got[pkg] = ([(o.indices.asnumpy().astype(np.int64),
                      o.data.asnumpy()) for o in rsp_outs], dense)
    for (ti, td), (ji, jd) in zip(got["port"][0], got["ref"][0]):
        np.testing.assert_array_equal(ti, ji)
        assert td.tobytes() == jd.tobytes()
    assert got["port"][0][0][0].tolist() == [1, 3, 6]
    dense = got["port"][1]
    assert dense.asnumpy().tobytes() == w0.tobytes()
    # a copy, not an alias: the store's next update leaves it as it was
    kv = stores["port"][0]
    assert dense._data.data_ptr() != kv._store["w"]._data.data_ptr()
    kv.push("w", tsp.RowSparseNDArray(_t_array(np.ones((1, 3), np.float32)),
                                      _t_array(np.array([0])), SHAPE))
    assert dense.asnumpy().tobytes() == w0.tobytes()
    with pytest.raises(ValueError, match="row_ids"):
        kv.row_sparse_pull("w", out=dense)
