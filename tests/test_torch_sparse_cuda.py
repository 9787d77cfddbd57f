"""The sparse storage ops of mxnet_tpu_torch on the card (marked ``cuda``;
skipped without one).  This file imports no JAX, so it runs on the GPU
host:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_sparse_cuda.py

Each op of ``chip_smoke.py`` phase 30 (a) runs on the card and on the CPU
of the card's host from the same seeded inputs, at a small shape, in
float64: index, indptr and nnz outputs equal, floats within 1e-10 of the
larger of 1 and their largest magnitude.  Host syncs a call, counted by
torch's sync debug mode: one for ``cast_storage`` and ``add_rsp`` (their
data-dependent sizes), none for ``dot``, ``retain``, the row-sparse
updates and the registered ops.  Nothing launches the port's hand
kernels (B1-B10): the reference's sparse code reaches no
``pallas_call``.
"""
import warnings

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import nd, optimizer
from mxnet_tpu_torch.ndarray import sparse
from mxnet_tpu_torch.ops import fused_optimizer, generated_kernels
from mxnet_tpu_torch.ops import pallas_kernels, registry

pytestmark = pytest.mark.cuda
COUNTERS = (fused_optimizer, pallas_kernels, generated_kernels)
TOL = 1e-10
ROWS, COLS, NNZ_ROW = 64, 500, 6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for m in COUNTERS:
        m.reset_launch_counts()
    yield
    assert not {k: v for m in COUNTERS for k, v in
                m.launch_counts().items() if v}


def _csr(device, seed=0):
    """A (ROWS, COLS) CSR batch with NNZ_ROW sorted distinct columns a
    row, float64."""
    rng = np.random.RandomState(seed)
    cols = np.sort(rng.randint(0, COLS - NNZ_ROW + 1, (ROWS, NNZ_ROW)),
                   1) + np.arange(NNZ_ROW)
    vals = rng.randn(ROWS * NNZ_ROW)
    indptr = np.arange(ROWS + 1) * NNZ_ROW
    return sparse.CSRNDArray(
        nd.array(vals, ctx=device, dtype=np.float64),
        nd.array(cols.reshape(-1), ctx=device, dtype=np.int64),
        nd.array(indptr, ctx=device, dtype=np.int64), (ROWS, COLS))


def _syncs(fn):
    """fn's result and the host syncs torch's debug mode reports in it."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x.asnumpy()


def _close(card, host):
    card, host = _host(card), _host(host)
    assert card.shape == host.shape
    scale = max(1.0, float(np.abs(host).max())) if host.size else 1.0
    np.testing.assert_allclose(card, host, rtol=0, atol=TOL * scale)


def _equal(card, host):
    np.testing.assert_array_equal(_host(card), _host(host))


@pytest.mark.parametrize("transpose_a", [False, True])
def test_dot_card_matches_cpu_without_syncs(card, transpose_a):
    rng = np.random.RandomState(1)
    rhs = rng.randn(ROWS if transpose_a else COLS, 8)
    out = {}
    for dev in ("cuda", "cpu"):
        x = _csr(dev)
        r = nd.array(rhs, ctx=dev, dtype=np.float64)
        if dev == "cuda":
            sparse.dot(x, r, transpose_a=transpose_a)
            out[dev], n = _syncs(lambda: sparse.dot(
                x, r, transpose_a=transpose_a))
            assert n == 0
        else:
            out[dev] = sparse.dot(x, r, transpose_a=transpose_a)
    _close(out["cuda"], out["cpu"])


def test_cast_storage_retain_add_card_matches_cpu(card):
    rng = np.random.RandomState(2)
    rhs = rng.randn(ROWS, 1)
    res = {}
    for dev in ("cuda", "cpu"):
        x = _csr(dev)
        gw = sparse.dot(x, nd.array(rhs, ctx=dev, dtype=np.float64),
                        transpose_a=True)
        rows = np.unique(x.indices.asnumpy())
        keep = nd.array(rows, ctx=dev, dtype=np.int64)
        rsp, n_cast = _syncs(lambda: sparse.cast_storage(gw, "row_sparse"))
        kept, n_retain = _syncs(lambda: sparse.retain(rsp, keep))
        other = sparse.retain(rsp, nd.array(rows[::2], ctx=dev,
                                            dtype=np.int64))
        total, n_add = _syncs(lambda: kept + other)
        dense = x.todense()
        csr, n_csr = _syncs(lambda: sparse.cast_storage(dense, "csr"))
        res[dev] = (rsp, kept, total, csr)
        if dev == "cuda":
            assert (n_cast, n_retain, n_add, n_csr) == (1, 0, 1, 1)
    for c, h in zip(res["cuda"], res["cpu"]):
        _equal(c.indices, h.indices)
        if c.stype == "csr":
            _equal(c.indptr, h.indptr)
        _close(c.data, h.data)


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("adam", dict(learning_rate=0.01, rescale_grad=0.5)),
    ("adagrad", dict(learning_rate=0.1, wd=0.01))])
def test_row_sparse_updates_card_match_cpu_without_syncs(card, name, kw):
    rng = np.random.RandomState(3)
    w0 = rng.randn(COLS, 4)
    idx = np.array([3, 7, 7, 100, 499])
    vals = rng.randn(len(idx), 4)
    res = {}
    for dev in ("cuda", "cpu"):
        opt = optimizer.create(name, **kw)
        w = torch.tensor(w0, device=dev)
        state = opt.create_state(0, w)
        g = sparse.RowSparseNDArray(nd.array(vals, ctx=dev, dtype=np.float64),
                                    nd.array(idx, ctx=dev, dtype=np.int64),
                                    w0.shape)
        if dev == "cuda":
            _, n = _syncs(lambda: opt.update(0, w, g, state))
            assert n == 0
        else:
            opt.update(0, w, g, state)
        states = state if isinstance(state, tuple) else (state,)
        res[dev] = [w] + [s for s in states if s is not None]
    for c, h in zip(res["cuda"], res["cpu"]):
        _close(c, h)


def test_registered_sparse_ops_card_match_cpu(card):
    rng = np.random.RandomState(4)
    x = rng.randn(40, 30) * (rng.rand(40, 30) < 0.2)
    x[[0, 5, 9]] = 0.0
    w, g, h = rng.randn(3, 40, 30)
    h = np.abs(h)
    calls = [
        ("cast_storage", (x,), dict(stype="row_sparse")),
        ("cast_storage", (x,), dict(stype="csr", capacity=100)),
        ("_sparse_retain", (x[:6], np.array([1, 4, 9, 11, 20, 33]),
                            np.array([4, 5, 33])), {}),
        ("sparse_retain", (x, np.array([1, 7, 30])), {}),
        ("_sparse_adagrad_update", (w, g, h), dict(lr=0.1, wd=0.01)),
        ("_contrib_SparseEmbedding", (np.array([[1, 3], [3, 39]]), w), {}),
        ("_contrib_getnnz", (x,), dict(axis=1)),
    ]
    for name, args, kw in calls:
        fn = registry.get(name).fn
        out = {}
        for dev in ("cuda", "cpu"):
            ts = [torch.tensor(a, device=dev) for a in args]
            if dev == "cuda":
                out[dev], n = _syncs(lambda: fn(*ts, **kw))
                assert n == 0, name
            else:
                out[dev] = fn(*ts, **kw)
        cs = out["cuda"] if isinstance(out["cuda"], tuple) else (out["cuda"],)
        hs = out["cpu"] if isinstance(out["cpu"], tuple) else (out["cpu"],)
        for c, hh in zip(cs, hs):
            assert c.dtype == hh.dtype, name
            if c.is_floating_point():
                _close(c, hh)
            else:
                _equal(c, hh)
