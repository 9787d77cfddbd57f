"""Sparse storage of mxnet_tpu_torch (``ndarray/sparse.py``,
``ops/sparse_ops.py`` and the other registered sparse names) held against
mxnet_tpu on the CPU, on the same seeded inputs.

- The classes, the constructors, ``zeros``, ``tostype``, ``cast_storage``,
  ``retain``, ``add_rsp`` and ``dot``: structural outputs (indices,
  indptr, nnz, shapes) equal; copies (``cast_storage`` / ``retain``
  values, ``todense`` without repeated indices) bitwise; sums (``dot``,
  ``add_rsp`` with overlap, ``todense`` with repeats) within 1e-6 of the
  larger of 1 and the reference's largest magnitude.  The port's index
  arrays are int64 (the reference's int32: JAX runs without x64).
- The eight registered names (``cast_storage``, ``_sparse_retain``,
  ``sparse_retain``, ``_sparse_adagrad_update`` and its alias,
  ``_contrib_SparseEmbedding`` and its alias, ``_contrib_getnnz``)
  against the reference's registry.
- ``rand_ndarray(stype=)``, the same draws after one numpy seed.
- Sparse ``.params`` records: both packages write the same bytes, each
  loads the other's file.
- Each case of the reference's ``tests/test_sparse_operator.py``, run
  through both packages.
- ROADMAP.md C10 (``retain`` over unsorted stored indices: the
  reference's binary search misses rows that are there) and repeated
  indices (``todense`` adds them; the optimizers' rule is in
  ``test_torch_sparse_optim.py``), each shown in both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import serialization as jser
from mxnet_tpu import test_utils as jtu
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import nd, serialization as tser
from mxnet_tpu_torch import test_utils as ttu
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.ndarray import sparse as tsp
from mxnet_tpu_torch.ops import registry as treg

treg.load_all()
TOL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _within(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.astype(got.dtype).tobytes()


def _index_equal(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want.astype(np.int64))


def _rand_csr(m, n, density, rng):
    dense = rng.rand(m, n) * (rng.rand(m, n) < density)
    return dense.astype(np.float32)


def _dense(seed, shape=(10, 8), density=0.3):
    return _rand_csr(shape[0], shape[1], density,
                     np.random.RandomState(seed))


# the inputs of the reference's own cases (tests/test_sparse_operator.py),
# which the other tests share so the reference compiles each shape once
def _dot_inputs(transpose_a):
    rng = np.random.RandomState(2 if transpose_a else 1)
    dense = _rand_csr(7, 11, 0.3, rng) if transpose_a \
        else _rand_csr(12, 9, 0.25, rng)
    return dense, rng.randn(dense.shape[0] if transpose_a else 9,
                            4 if transpose_a else 5).astype(np.float32)


def _retain_input():
    dense = np.zeros((8, 3), np.float32)
    dense[[1, 3, 6]] = np.random.RandomState(4).rand(3, 3)
    return dense


def _add_inputs():
    rng = np.random.RandomState(5)
    a = np.zeros((10, 4), np.float32)
    b = np.zeros((10, 4), np.float32)
    a[[0, 3, 7]] = rng.rand(3, 4)
    b[[3, 5]] = rng.rand(2, 4)
    return a, b


def _both(dense, stype):
    return (jsp.cast_storage(jmx.nd.array(dense), stype),
            tsp.cast_storage(nd.array(dense), stype))


def _same_sparse(j, t):
    """The two arrays' parts: indices equal, values bitwise."""
    assert t.stype == j.stype and t.shape == j.shape
    _index_equal(t.indices, j.indices)
    if t.stype == "csr":
        _index_equal(t.indptr, j.indptr)
    _same(t.data, j.data)


# -- the classes and constructors --------------------------------------------
@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
def test_cast_storage_and_todense_match_reference(stype):
    dense = _dense(0)
    j, t = _both(dense, stype)
    _same_sparse(j, t)
    _same(t.todense(), j.todense())
    _same(t.asnumpy(), dense)
    assert t.dtype == np.float32 and t.context.torch_device() == torch.device("cpu")
    assert t.size == dense.size and t.ndim == 2
    _same(t.tostype("default"), dense)
    _same_sparse(j, t.tostype(stype))
    _same_sparse(j, nd.array(dense).tostype(stype))
    assert "x".join(map(str, dense.shape)) in repr(t)


def test_cast_storage_of_a_sparse_array_and_3d_rows():
    rng = np.random.RandomState(1)
    x = rng.randn(6, 2, 3).astype(np.float32)
    x[[0, 2, 5]] = 0.0
    j, t = _both(x, "row_sparse")
    _same_sparse(j, t)
    _same(t.todense(), x)
    csr = tsp.cast_storage(nd.array(_dense(0)), "csr")
    _same_sparse(jsp.cast_storage(jsp.cast_storage(
        jmx.nd.array(_dense(0)), "csr"), "row_sparse"),
        tsp.cast_storage(csr, "row_sparse"))


@pytest.mark.parametrize("how", ["tuple", "dense"])
def test_constructors_match_reference(how):
    dense = _dense(0)
    if how == "tuple":
        data = np.random.RandomState(4).randn(3, 5).astype(np.float32)
        idx = np.array([1, 4, 6])
        j = jsp.row_sparse_array((data, idx), shape=(7, 5))
        t = tsp.row_sparse_array((data, idx), shape=(7, 5))
        jc = jsp.csr_matrix((np.array([1., 2., 3.], np.float32),
                             np.array([0, 4, 2]), np.array([0, 2, 2, 3])),
                            shape=(3, 5))
        tc = tsp.csr_matrix((np.array([1., 2., 3.], np.float32),
                             np.array([0, 4, 2]), np.array([0, 2, 2, 3])),
                            shape=(3, 5))
    else:
        j, t = jsp.row_sparse_array(dense), tsp.row_sparse_array(dense)
        jc, tc = jsp.csr_matrix(dense), tsp.csr_matrix(dense)
    _same_sparse(j, t)
    _same_sparse(jc, tc)
    _same(t.asnumpy(), j.asnumpy())
    _same(tc.asnumpy(), jc.asnumpy())
    with pytest.raises(ValueError, match="shape"):
        tsp.row_sparse_array((np.ones((1, 2)), np.array([0])))


@pytest.mark.parametrize("stype", ["row_sparse", "csr", "default"])
def test_zeros_match_reference(stype):
    j = jsp.zeros(stype, (4, 3), dtype="float32")
    t = tsp.zeros(stype, (4, 3), dtype="float32")
    assert t.stype == j.stype and t.shape == j.shape
    _same(t.asnumpy(), j.asnumpy())
    if stype != "default":
        assert t.indices.shape == j.indices.shape
        assert t.indices.dtype == np.int64
    tz = nd.zeros((4, 3), stype=stype)
    assert tz.stype == stype and tz.shape == (4, 3)
    assert jmx.nd.zeros((4, 3), stype=stype).stype == stype
    assert tmx.nd.sparse is tsp


def test_copyto_and_as_in_context():
    j, t = _both(_dense(0), "row_sparse")
    jo = jsp.zeros("row_sparse", (10, 8))
    to = tsp.zeros("row_sparse", (10, 8), ctx="cpu")
    j.copyto(jo)
    t.copyto(to)
    _same_sparse(jo, to)
    assert to.data._data.data_ptr() != t.data._data.data_ptr()
    dense_out = nd.zeros((10, 8), ctx="cpu")
    t.copyto(dense_out)
    _same(dense_out, _dense(0))
    for a in (t, tsp.cast_storage(nd.array(_dense(0)), "csr")):
        moved = a.as_in_context("cpu")
        assert type(moved) is type(a) and moved.shape == a.shape
        _same(moved.asnumpy(), a.asnumpy())


# -- retain, add, dot ---------------------------------------------------------
def test_retain_matches_reference_on_sorted_indices():
    dense = _retain_input()
    j, t = _both(dense, "row_sparse")
    keep = np.array([1, 2, 6], np.int64)
    jk = jsp.retain(j, jmx.nd.array(keep, dtype="int64"))
    tk = tsp.retain(t, nd.array(keep, dtype="int64"))
    _same_sparse(jk, tk)
    _same(tk.asnumpy(), jk.asnumpy())
    # a list of indices, and an empty source
    _same_sparse(jk, tsp.retain(t, [1, 2, 6]))
    je = jsp.retain(jsp.zeros("row_sparse", (8, 3)),
                    jmx.nd.array(keep, dtype="int64"))
    te = tsp.retain(tsp.zeros("row_sparse", (8, 3)), keep)
    _same_sparse(je, te)


def test_c10_retain_over_unsorted_stored_indices():
    """ROADMAP.md C10: stored indices [4, 1, 2] retained at [1, 2, 4].  The
    reference's binary search assumes them sorted and returns rows 1 and
    4 as zeros; the port returns the three rows that are there."""
    data = np.array([[4., 4.], [1., 1.], [2., 2.]], np.float32)
    idx = np.array([4, 1, 2])
    keep = np.array([1, 2, 4], np.int64)
    j = jsp.retain(jsp.row_sparse_array((data, idx), shape=(6, 2)),
                   jmx.nd.array(keep, dtype="int64"))
    t = tsp.retain(tsp.row_sparse_array((data, idx), shape=(6, 2)),
                   nd.array(keep, dtype="int64"))
    np.testing.assert_array_equal(j.data.asnumpy(),
                                  [[0., 0.], [2., 2.], [0., 0.]])
    np.testing.assert_array_equal(t.data.asnumpy(),
                                  [[1., 1.], [2., 2.], [4., 4.]])
    # the registered _sparse_retain likewise
    jo = jreg.get("_sparse_retain").fn(jnp.asarray(data), jnp.asarray(idx),
                                       jnp.asarray(keep))
    to = treg.get("_sparse_retain").fn(torch.from_numpy(data),
                                       torch.from_numpy(idx),
                                       torch.from_numpy(keep))
    np.testing.assert_array_equal(np.asarray(jo[0])[[0, 2]], 0.0)
    np.testing.assert_array_equal(to[0].numpy(), t.data.asnumpy())


def test_repeated_indices_todense_adds_in_both():
    """A row-sparse array that holds row 1 twice: ``todense`` adds them
    (the optimizers' rule for repeats is in test_torch_sparse_optim.py)."""
    data = np.array([[1., 2.], [3., 4.], [5., 6.]], np.float32)
    idx = np.array([1, 3, 1])
    j = jsp.row_sparse_array((data, idx), shape=(4, 2))
    t = tsp.row_sparse_array((data, idx), shape=(4, 2))
    _within(t.todense(), j.todense())
    np.testing.assert_array_equal(t.asnumpy()[1], [6., 8.])
    csr_j = jsp.csr_matrix((np.array([1., 2.], np.float32), np.array([2, 2]),
                            np.array([0, 2, 2])), shape=(2, 3))
    csr_t = tsp.csr_matrix((np.array([1., 2.], np.float32), np.array([2, 2]),
                            np.array([0, 2, 2])), shape=(2, 3))
    _within(csr_t.todense(), csr_j.todense())
    assert csr_t.asnumpy()[0, 2] == 3.0


def test_add_rsp_matches_reference():
    a, b = _add_inputs()
    ja, ta = _both(a, "row_sparse")
    jb, tb = _both(b, "row_sparse")
    js_, ts_ = ja + jb, ta + tb
    assert ts_.stype == "row_sparse"
    _index_equal(ts_.indices, js_.indices)
    _within(ts_.data, js_.data)
    _within(ts_.asnumpy(), a + b)
    empty = tsp.zeros("row_sparse", (10, 4), ctx="cpu")
    _same_sparse(jsp.add_rsp(jsp.zeros("row_sparse", (10, 4)),
                             jsp.zeros("row_sparse", (10, 4))),
                 tsp.add_rsp(empty, empty))
    _within((ta + nd.array(b)).asnumpy(), a + b)


@pytest.mark.parametrize("transpose_a", [False, True])
def test_dot_matches_reference(transpose_a):
    dense, rhs = _dot_inputs(transpose_a)
    j, t = _both(dense, "csr")
    jo = jsp.dot(j, jmx.nd.array(rhs), transpose_a=transpose_a)
    to = tsp.dot(t, nd.array(rhs), transpose_a=transpose_a)
    assert to.shape == jo.shape
    _within(to, jo)
    # float64 (the reference runs without x64): against numpy
    to64 = tsp.dot(tsp.csr_matrix(dense.astype(np.float64), ctx="cpu"),
                   nd.array(rhs, dtype=np.float64), transpose_a=transpose_a)
    want = (dense.T if transpose_a else dense).astype(np.float64) \
        @ rhs.astype(np.float64)
    assert to64.dtype == np.float64
    _within(to64, want, 1e-12)
    with pytest.raises(NotImplementedError, match="transpose_b"):
        tsp.dot(t, nd.array(rhs), transpose_b=True)
    with pytest.raises(TypeError, match="CSR"):
        tsp.dot(nd.array(dense), nd.array(rhs))


def test_operands_on_two_devices_raise():
    """Sparse ops never copy across devices: parts or operands on two
    devices raise (the meta device stands in for the card here)."""
    t = tsp.cast_storage(nd.array(_dense(8)), "csr")
    rhs_meta = nd.NDArray(torch.empty((8, 2), device="meta"))
    with pytest.raises(MXNetError, match="one device"):
        tsp.dot(t, rhs_meta)
    r = tsp.cast_storage(nd.array(_dense(8)), "row_sparse")
    with pytest.raises(MXNetError, match="row indices"):
        tsp.retain(r, nd.NDArray(torch.empty(2, dtype=torch.int64,
                                             device="meta")))
    mixed = tsp.RowSparseNDArray(r.data, nd.NDArray(
        torch.empty(r.indices.shape, dtype=torch.int64, device="meta")),
        r.shape)
    with pytest.raises(MXNetError, match="one device"):
        mixed.todense()


# -- the registered names -----------------------------------------------------
@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
@pytest.mark.parametrize("capacity", [0, 4])
def test_registered_cast_storage_matches_reference(stype, capacity):
    dense = _dense(9, (6, 5), 0.35)
    dense[2] = 0.0
    jo = jreg.get("cast_storage").fn(jnp.asarray(dense), stype=stype,
                                     capacity=capacity)
    to = treg.get("cast_storage").fn(torch.from_numpy(dense), stype=stype,
                                     capacity=capacity)
    assert len(to) == len(jo) == treg.get("cast_storage").n_outputs(
        {"stype": stype})
    for j, t in zip(jo, to):
        j = np.asarray(j)
        assert t.dtype == torch.from_numpy(j).dtype and t.shape == j.shape
        assert t.numpy().tobytes() == j.tobytes()


def test_registered_cast_storage_padding_example():
    """A 6 x 3 input with rows 1 and 4 set: indices [1, 4, 6, 6, 6, 6] and
    nnz 2, as the reference gives."""
    x = np.zeros((6, 3), np.float32)
    x[1], x[4] = 1.0, 2.0
    vals, idx, nnz = nd.cast_storage(nd.array(x), stype="row_sparse")
    assert idx.asnumpy().tolist() == [1, 4, 6, 6, 6, 6] and int(nnz) == 2
    assert vals.asnumpy()[2:].sum() == 0.0


def test_registered_sparse_retains_match_reference():
    rng = np.random.RandomState(10)
    data = rng.randn(4, 3).astype(np.float32)
    idx = np.array([0, 2, 5, 7], np.int32)
    keep = np.array([2, 3, 7], np.float32)
    for name, args in (("_sparse_retain", (data, idx, keep)),
                       ("sparse_retain", (rng.randn(5, 2).astype(np.float32),
                                          np.array([0, 3], np.float32)))):
        jo = jreg.get(name).fn(*[jnp.asarray(a) for a in args])
        to = treg.get(name).fn(*[torch.from_numpy(a) for a in args])
        jo = jo if isinstance(jo, tuple) else (jo,)
        to = to if isinstance(to, tuple) else (to,)
        for j, t in zip(jo, to):
            j = np.asarray(j)
            assert t.dtype == torch.from_numpy(j).dtype
            assert t.numpy().tobytes() == j.tobytes()
    # a source with no rows (the reference's index into it fails): zeros
    rows, kept = treg.get("_sparse_retain").fn(
        torch.from_numpy(data[:0]), torch.from_numpy(idx[:0]),
        torch.from_numpy(keep))
    assert rows.shape == (3, 3) and not rows.any()
    assert kept.tolist() == [2, 3, 7]


@pytest.mark.parametrize("name", ["_sparse_adagrad_update",
                                  "sparse_adagrad_update"])
@pytest.mark.parametrize("wd,rescale,clip", [(0.0, 1.0, -1.0),
                                             (0.01, 0.5, 0.3)])
def test_registered_sparse_adagrad_update_matches_reference(name, wd, rescale,
                                                            clip):
    rng = np.random.RandomState(11)
    w, g = rng.randn(5, 3).astype(np.float32), rng.randn(5, 3)
    h = rng.rand(5, 3).astype(np.float32)
    kw = dict(lr=0.1, epsilon=1e-7, wd=wd, rescale_grad=rescale,
              clip_gradient=clip)
    jw, jh = jreg.get(name).fn(jnp.asarray(w), jnp.asarray(g, jnp.float32),
                               jnp.asarray(h), **kw)
    tw, th = treg.get(name).fn(torch.from_numpy(w),
                               torch.from_numpy(g.astype(np.float32)),
                               torch.from_numpy(h), **kw)
    _within(tw, np.asarray(jw))
    _within(th, np.asarray(jh))
    # through nd: the history is written back in place, as the reference's
    tw_nd, th_nd = nd.array(w), nd.array(h)
    out = nd.sparse_adagrad_update(tw_nd, nd.array(g), th_nd, out=tw_nd,
                                   **kw)
    _within(out, np.asarray(jw))
    _within(th_nd, np.asarray(jh))


@pytest.mark.parametrize("name", ["_contrib_SparseEmbedding",
                                  "SparseEmbedding"])
def test_registered_sparse_embedding_matches_reference(name):
    rng = np.random.RandomState(12)
    w = rng.randn(10, 4).astype(np.float32)
    idx = np.array([[1, 9], [0, 1]], np.float32)
    jo = jreg.get(name).fn(jnp.asarray(idx), jnp.asarray(w), input_dim=10,
                           output_dim=4)
    to = treg.get(name).fn(torch.from_numpy(idx), torch.from_numpy(w),
                           input_dim=10, output_dim=4)
    _same(to, np.asarray(jo))
    wt = torch.from_numpy(w).requires_grad_()
    (g,) = torch.autograd.grad(treg.get(name).fn(torch.from_numpy(idx), wt)
                               .sum(), wt)
    np.testing.assert_array_equal(g.numpy()[1], [2.0] * 4)
    out = nd.contrib.SparseEmbedding(nd.array(idx), nd.array(w),
                                     input_dim=10, output_dim=4)
    _same(out, np.asarray(jo))


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_registered_getnnz_matches_reference(axis):
    x = _dense(13, (4, 6), 0.4)
    jo = np.asarray(jreg.get("_contrib_getnnz").fn(jnp.asarray(x), axis=axis))
    to = treg.get("_contrib_getnnz").fn(torch.from_numpy(x), axis=axis)
    assert to.dtype == torch.int64 and to.shape == jo.shape
    np.testing.assert_array_equal(to.numpy(), jo)


# -- rand_ndarray(stype=) -----------------------------------------------------
@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
def test_rand_ndarray_stype_matches_reference(stype):
    np.random.seed(4)
    j = jtu.rand_ndarray((5, 4), stype=stype, density=0.1)
    np.random.seed(4)
    t = ttu.rand_ndarray((5, 4), stype=stype, density=0.1)
    assert t.stype == stype
    # density is ignored, as in the reference: the uniform draw has no 0
    assert t.data.shape == j.data.shape
    _same_sparse(j, t)


# -- sparse .params records ---------------------------------------------------
def _params_values(pkg):
    data = np.array([[1., 2.], [3., 4.]], np.float32)
    rsp = pkg.row_sparse_array((data, np.array([0, 3])), shape=(4, 2))
    csr = pkg.csr_matrix((np.array([5., 6., 7.], np.float32),
                          np.array([0, 2, 1]), np.array([0, 2, 2, 3])),
                         shape=(3, 3))
    dense = np.arange(6, dtype=np.float32).reshape(2, 3)
    return {"arg:rsp": rsp, "arg:csr": csr,
            "arg:w": (jmx.nd.array(dense) if pkg is jsp else nd.array(dense))}


@pytest.mark.parametrize("fmt", ["mxnet", "mxtpu"])
def test_sparse_params_byte_identical_and_cross_load(tmp_path, fmt):
    jp, tp = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jser.save_ndarrays(jp, _params_values(jsp), format=fmt)
    tser.save_ndarrays(tp, _params_values(tsp), format=fmt)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    want = _params_values(tsp)
    for loaded in (tser.load_ndarrays(jp, ctx="cpu"),
                   jser.load_ndarrays(tp)):
        for k, v in want.items():
            got = loaded[k]
            _same(got.asnumpy(), v.asnumpy())
            if fmt == "mxnet":
                assert got.stype == v.stype
                if v.stype != "default":
                    np.testing.assert_array_equal(
                        _np(got.indices).astype(np.int64), _np(v.indices))
            else:
                assert got.stype == "default"
    back = tser.load_ndarrays(jp, ctx="cpu")
    if fmt == "mxnet":
        assert isinstance(back["arg:rsp"], tsp.RowSparseNDArray)
        assert isinstance(back["arg:csr"], tsp.CSRNDArray)
        assert back["arg:rsp"].indices.dtype == np.int64
        _index_equal(back["arg:csr"].indptr, [0, 2, 2, 3])


# -- the reference's tests/test_sparse_operator.py, both packages ------------
class _Pkg:
    def __init__(self, ref):
        self.ref = ref
        self.sp = jsp if ref else tsp
        self.mx = jmx if ref else tmx

    def array(self, x, dtype=None):
        return (jmx.nd.array(x, dtype=dtype) if self.ref
                else nd.array(x, ctx="cpu", dtype=dtype))


def _case_csr_roundtrip(p):
    dense = _rand_csr(10, 8, 0.3, np.random.RandomState(0))
    return [p.sp.csr_matrix(dense).todense().asnumpy()]


def _case_csr_dot_dense(p):
    dense, rhs = _dot_inputs(False)
    return [p.sp.dot(p.sp.csr_matrix(dense), p.array(rhs)).asnumpy()]


def _case_csr_dot_transpose_a(p):
    dense, rhs = _dot_inputs(True)
    return [p.sp.dot(p.sp.csr_matrix(dense), p.array(rhs),
                     transpose_a=True).asnumpy()]


def _case_csr_dot_empty(p):
    csr = p.sp.zeros("csr", (4, 6))
    out = p.sp.dot(csr, p.array(np.ones((6, 3), np.float32)))
    return [out.asnumpy()]


def _case_cast_storage_csr(p):
    dense = _rand_csr(6, 5, 0.4, np.random.RandomState(3))
    csr = p.sp.cast_storage(p.array(dense), "csr")
    assert csr.stype == "csr"
    return [csr.todense().asnumpy()]


def _case_cast_storage_row_sparse_drops_zero_rows(p):
    dense = np.zeros((6, 3), np.float32)
    dense[1] = 1.0
    dense[4] = 2.0
    rsp = p.sp.cast_storage(p.array(dense), "row_sparse")
    assert rsp.stype == "row_sparse"
    return [rsp.indices.asnumpy().astype(np.int64), rsp.todense().asnumpy()]


def _case_retain_static_shape(p):
    dense = _retain_input()
    rsp = p.sp.cast_storage(p.array(dense), "row_sparse")
    kept = p.sp.retain(rsp, p.array(np.array([1, 2, 6], np.int64)))
    assert kept.indices.shape == (3,)
    return [kept.todense().asnumpy()]


def _case_add_rsp_union(p):
    a_dense, b_dense = _add_inputs()
    a = p.sp.cast_storage(p.array(a_dense), "row_sparse")
    b = p.sp.cast_storage(p.array(b_dense), "row_sparse")
    s = a + b
    assert s.stype == "row_sparse"
    return [s.indices.asnumpy().astype(np.int64), s.todense().asnumpy()]


def _update(p, opt, w, g):
    """One update through the package's updater; (weight, state)."""
    up = p.mx.optimizer.get_updater(opt)
    up(0, g, w)
    state = up.states[0]
    return w.asnumpy(), _np(state)


def _case_rsp_sgd_no_densify_on_weight(p):
    opt = p.mx.optimizer.SGD(learning_rate=1.0, momentum=0.9)
    w = p.array(np.ones((6, 2), np.float32))
    g = p.sp.RowSparseNDArray(p.array(np.full((2, 2), 0.5, np.float32)),
                              p.array(np.array([1, 4], np.int64)), (6, 2))
    w_after, mom = _update(p, opt, w, g)
    np.testing.assert_array_equal(w_after[[0, 2, 3, 5]], 1.0)
    assert not np.allclose(w_after[[1, 4]], 1.0)
    return [w_after, mom]


def _case_adagrad_row_sparse(p):
    opt = p.mx.optimizer.AdaGrad(learning_rate=0.5)
    w = p.array(np.ones((5, 3), np.float32))
    g = p.sp.RowSparseNDArray(p.array(np.full((2, 3), 0.1, np.float32)),
                              p.array(np.array([0, 2], np.int64)), (5, 3))
    w_after, hist = _update(p, opt, w, g)
    np.testing.assert_array_equal(w_after[[1, 3, 4]], 1.0)
    assert np.all(hist[[0, 2]] > 0) and np.all(hist[[1, 3, 4]] == 0)
    return [w_after, hist]


def _case_sparse_linear_training_no_densify(p):
    rng = np.random.RandomState(6)
    x_dense = _rand_csr(32, 20, 0.2, rng)
    y = (x_dense.sum(axis=1) > x_dense.sum(axis=1).mean()) \
        .astype(np.float32)
    x_csr = p.sp.csr_matrix(x_dense)
    w = p.array(rng.randn(20, 1).astype(np.float32) * 0.1)
    losses = []
    for _ in range(30):
        err = p.sp.dot(x_csr, w).asnumpy()[:, 0] - y
        losses.append(float((err ** 2).mean()))
        gw = p.sp.dot(x_csr, p.array(err[:, None].astype(np.float32)),
                      transpose_a=True)
        w = p.array(w.asnumpy() - 0.1 * gw.asnumpy() / 32)
    assert losses[-1] < losses[0] * 0.5, losses
    return [np.array(losses), w.asnumpy()]


OPERATOR_CASES = {f.__name__[6:]: f for f in (
    _case_csr_roundtrip, _case_csr_dot_dense, _case_csr_dot_transpose_a,
    _case_csr_dot_empty, _case_cast_storage_csr,
    _case_cast_storage_row_sparse_drops_zero_rows, _case_retain_static_shape,
    _case_add_rsp_union, _case_rsp_sgd_no_densify_on_weight,
    _case_adagrad_row_sparse, _case_sparse_linear_training_no_densify)}


@pytest.mark.parametrize("case", sorted(OPERATOR_CASES))
def test_reference_sparse_operator_case_in_both_packages(case):
    want = OPERATOR_CASES[case](_Pkg(ref=True))
    got = OPERATOR_CASES[case](_Pkg(ref=False))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _within(g, w)
