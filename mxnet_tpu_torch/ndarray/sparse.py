"""Sparse NDArrays: the port of ``mxnet_tpu/ndarray/sparse.py``.

Two storage types beside the dense default, as MXNet's
(``include/mxnet/ndarray.h:61-66``): ``row_sparse`` holds the rows of a
subset of row indices, ``(data, indices)`` — the natural form of an
embedding's or a sparse linear model's gradient; ``csr`` holds a 2-D
matrix as ``(data, indices, indptr)``.  The index arrays are int64, as
MXNet's are (the reference asks for int64 and gets int32, JAX running
without x64; its ``.params`` writer widens them back).

The operations keep sparsity where it pays, on the device of their
operands, and never copy across devices (mixed devices raise):

- :func:`dot` of a CSR lhs and a dense rhs stays O(nnz x k): plain, it
  is ``torch.sparse.mm`` over the CSR (cuSPARSE's SpMM on the card);
  with ``transpose_a``, a gather of the rhs rows and an ``index_add_``
  into the output rows (on an H100 each is the faster of the two forms,
  ``chip_smoke.py`` phase 30 (a));
- :func:`retain` keeps the requested rows with a static output shape and
  no host sync;
- :func:`cast_storage` and :func:`add_rsp` size their outputs by a
  data-dependent count: one host sync each (``torch.nonzero``, one
  ``.item()``), where the reference syncs too.

``todense`` adds rows (or entries) that share an index, as the
reference's scatter-add does.  :func:`retain` finds requested rows among
the stored ones whatever their order; the reference's binary search
assumes them sorted (ROADMAP.md C10).  On a CUDA tensor ``index_add_``
sums with atomics, so a sum over repeated indices may differ by ulps from
run to run.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..ops.sparse_ops import find_rows
from .ndarray import NDArray, _device, array as _dense_array, torch_dtype

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "zeros", "cast_storage",
           "retain", "add_rsp", "dot"]


def _same_device(*tensors):
    """The one device of ``tensors``; raises where they are on two."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise MXNetError("sparse operands on %s: move them to one device "
                         "first (as_in_context)" % sorted(map(str, devs)))
    return devs.pop()


class BaseSparseNDArray(NDArray):
    """A sparse array: its parts are NDArrays; it has no dense tensor."""

    __slots__ = ()

    def _init_handle(self):
        self._data = None
        self._fixed = False
        self._grad_req = "null"

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def size(self):
        return int(_np.prod(self._shape))

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def context(self):
        return self.data.context

    ctx = context

    def __repr__(self):
        return "<%s %s @%s>" % (type(self).__name__,
                                "x".join(map(str, self._shape)),
                                self.context)

    def asnumpy(self):
        return self.todense().asnumpy()

    def wait_to_read(self):
        self.data.wait_to_read()

    tostype = NDArray.tostype


class RowSparseNDArray(BaseSparseNDArray):
    """row_sparse: ``data`` (nnz_rows, *row_shape) holds the rows at
    ``indices`` (nnz_rows,) of a ``shape`` array."""

    __slots__ = ("data", "indices", "_shape")

    def __init__(self, data, indices, shape):
        self._init_handle()
        self.data = data
        self.indices = indices
        self._shape = tuple(shape)

    @property
    def stype(self):
        return "row_sparse"

    def todense(self):
        d = self.data._data
        _same_device(d, self.indices._data)
        out = torch.zeros(self._shape, dtype=d.dtype, device=d.device)
        # add, not set: rows that share an index accumulate
        return NDArray(out.index_add_(0, self.indices._data.long(), d))

    def copyto(self, other):
        if isinstance(other, RowSparseNDArray):
            other.data = self.data.copy()
            other.indices = self.indices.copy()
            other._shape = self._shape
            return other
        return self.todense().copyto(other)

    def as_in_context(self, ctx):
        return RowSparseNDArray(self.data.as_in_context(ctx),
                                self.indices.as_in_context(ctx), self._shape)

    as_in_ctx = as_in_context

    def __add__(self, other):
        if isinstance(other, RowSparseNDArray):
            return add_rsp(self, other)
        return self.todense() + other


class CSRNDArray(BaseSparseNDArray):
    """csr: row ``r`` of the ``shape`` matrix holds ``data[indptr[r]:
    indptr[r + 1]]`` at the columns ``indices[indptr[r]:indptr[r + 1]]``."""

    __slots__ = ("data", "indices", "indptr", "_shape")

    def __init__(self, data, indices, indptr, shape):
        self._init_handle()
        self.data = data
        self.indices = indices
        self.indptr = indptr
        self._shape = tuple(shape)

    @property
    def stype(self):
        return "csr"

    def todense(self):
        vals = self.data._data
        _same_device(vals, self.indices._data, self.indptr._data)
        rows = _csr_rows(self.indptr._data, vals.shape[0])
        out = torch.zeros(self._shape, dtype=vals.dtype, device=vals.device)
        return NDArray(out.index_put_((rows, self.indices._data.long()), vals,
                                      accumulate=True))

    def as_in_context(self, ctx):
        return CSRNDArray(self.data.as_in_context(ctx),
                          self.indices.as_in_context(ctx),
                          self.indptr.as_in_context(ctx), self._shape)

    as_in_ctx = as_in_context


def _part(x, ctx, dtype):
    return x if isinstance(x, NDArray) else _dense_array(x, ctx, dtype)


def _host(x):
    return x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` and ``shape``, or from a
    dense array (its rows that are not all zeros)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        if shape is None:
            raise ValueError("shape required")
        return RowSparseNDArray(_part(data, ctx, dtype),
                                _part(indices, ctx, "int64"), shape)
    dense = _host(arg1)
    nz = _np.where(_np.abs(dense).reshape(dense.shape[0], -1).sum(-1) > 0)[0]
    return RowSparseNDArray(_dense_array(dense[nz], ctx, dtype or dense.dtype),
                            _dense_array(nz, ctx, "int64"), dense.shape)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` and ``shape``, or from
    a dense 2-D array."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        return CSRNDArray(_part(data, ctx, dtype),
                          _part(indices, ctx, "int64"),
                          _part(indptr, ctx, "int64"), shape)
    dense = _host(arg1)
    m = dense.shape[0]
    rows, cols = _np.nonzero(dense)
    indptr = _np.zeros(m + 1, _np.int64)
    _np.cumsum(_np.bincount(rows, minlength=m), out=indptr[1:])
    return CSRNDArray(
        _dense_array(_np.asarray(dense[rows, cols], dtype=dense.dtype), ctx,
                     dtype or dense.dtype),
        _dense_array(cols, ctx, "int64"), _dense_array(indptr, ctx, "int64"),
        dense.shape)


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of storage type ``stype``, on ``ctx`` (the card by
    default)."""
    dev = _device(ctx)
    tdt = torch_dtype(dtype or "float32")
    shape = tuple(shape)

    def z(*s, dt=tdt):
        return NDArray(torch.zeros(s, dtype=dt, device=dev))
    if stype == "row_sparse":
        return RowSparseNDArray(z(0, *shape[1:]), z(0, dt=torch.int64),
                                shape)
    if stype == "csr":
        return CSRNDArray(z(0), z(0, dt=torch.int64),
                          z(shape[0] + 1, dt=torch.int64), shape)
    if stype == "default":
        return z(*shape)
    raise ValueError(stype)


def cast_storage(arr, stype):
    """``arr`` in storage type ``stype`` (reference:
    src/operator/tensor/cast_storage.cc).  To a sparse type the nonzero
    scan runs on the array's device; reading its count is the one host
    sync."""
    if stype == arr.stype:
        return arr
    if stype == "default":
        return arr.todense()
    if isinstance(arr, BaseSparseNDArray):
        arr = arr.todense()
    d = arr._data.detach()
    if stype == "row_sparse":
        row_nz = (d.reshape(d.shape[0], -1) != 0).any(-1)
        nz = torch.nonzero(row_nz).reshape(-1)
        return RowSparseNDArray(NDArray(d.index_select(0, nz)), NDArray(nz),
                                d.shape)
    if stype == "csr":
        rows, cols = torch.nonzero(d, as_tuple=True)
        # indptr[r] = the nonzeros in rows before r (rows come sorted)
        indptr = torch.searchsorted(rows, torch.arange(
            d.shape[0] + 1, device=d.device))
        return CSRNDArray(NDArray(d[rows, cols]), NDArray(cols),
                          NDArray(indptr), d.shape)
    raise ValueError(stype)


def _index_tensor(indices, device):
    """Row indices as an int64 tensor on ``device``: an NDArray must be
    there already; a list or numpy array is copied there."""
    if not isinstance(indices, NDArray):
        return torch.as_tensor(_np.asarray(indices, _np.int64), device=device)
    if indices._data.device != device:
        raise MXNetError("row indices on %s for an array on %s"
                         % (indices._data.device, device))
    return indices._data.long()


def retain(rsp, indices):
    """The rows ``indices`` of ``rsp`` (reference:
    src/operator/tensor/sparse_retain.cc): the output has exactly
    ``len(indices)`` rows, a requested row the source lacks comes out
    zero, and nothing syncs with the host."""
    src_data = rsp.data._data
    src_idx = rsp.indices._data.long()
    dev = _same_device(src_data, src_idx)
    keep = _index_tensor(indices, dev)
    row_shape = tuple(src_data.shape[1:])
    if src_idx.shape[0] == 0:
        rows = torch.zeros((keep.shape[0],) + row_shape,
                           dtype=src_data.dtype, device=dev)
        return RowSparseNDArray(NDArray(rows), NDArray(keep), rsp.shape)
    hit, pos = find_rows(src_idx, keep)
    rows = torch.where(hit.reshape((-1,) + (1,) * len(row_shape)),
                       src_data.index_select(0, pos), 0)
    return RowSparseNDArray(NDArray(rows), NDArray(keep), rsp.shape)


def add_rsp(a, b):
    """``a + b`` of two row-sparse arrays, rows over the union of their
    indices (sorted), shared rows summed.  The union's size is the one
    host sync."""
    _same_device(a.indices._data, a.data._data, b.indices._data,
                 b.data._data)
    idx = torch.cat([a.indices._data.long(), b.indices._data.long()])
    data = torch.cat([a.data._data, b.data._data])
    if idx.shape[0] == 0:
        return RowSparseNDArray(a.data.copy(), a.indices.copy(), a.shape)
    idx_s, order = torch.sort(idx, stable=True)
    is_new = torch.ones_like(idx_s)
    is_new[1:] = idx_s[1:] != idx_s[:-1]
    seg = torch.cumsum(is_new, 0) - 1
    n_unique = int(seg[-1]) + 1
    out = torch.zeros((n_unique,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device).index_add_(
                          0, seg, data.index_select(0, order))
    out_idx = torch.zeros(n_unique, dtype=torch.int64,
                          device=idx.device).scatter_(0, seg, idx_s)
    return RowSparseNDArray(NDArray(out), NDArray(out_idx), a.shape)


def _csr_rows(indptr, nnz):
    """The row of each of ``nnz`` stored entries, from ``indptr``."""
    return torch.searchsorted(indptr.long(), torch.arange(
        nnz, device=indptr.device), right=True) - 1


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """``lhs . rhs`` (or ``lhs^T . rhs``) of a CSR ``lhs`` and a dense
    ``rhs`` without densifying (reference: src/operator/tensor/dot-inl.h
    DotCsrDnsDnsImpl / DotCsrDnsRspImpl): ``torch.sparse.mm``, or, with
    ``transpose_a``, each nonzero's product with its row of ``rhs``
    summed into its output row by ``index_add_``."""
    if not isinstance(lhs, CSRNDArray):
        raise TypeError("sparse dot expects CSR lhs")
    if transpose_b:
        raise NotImplementedError("transpose_b unsupported for sparse dot")
    vals = lhs.data._data
    dev = _same_device(vals, lhs.indices._data, lhs.indptr._data)
    rhs_t = rhs._data if isinstance(rhs, NDArray) else torch.as_tensor(
        _np.asarray(rhs), device=dev)
    _same_device(vals, rhs_t)
    m, n = lhs.shape
    out_shape = (n if transpose_a else m,) + tuple(rhs_t.shape[1:])
    nnz = vals.shape[0]
    if nnz == 0:
        return NDArray(torch.zeros(out_shape, dtype=rhs_t.dtype, device=dev))
    cols = lhs.indices._data.long()
    if not transpose_a:
        dt = torch.promote_types(vals.dtype, rhs_t.dtype)
        csr = torch.sparse_csr_tensor(lhs.indptr._data.long(), cols,
                                      vals.to(dt), (m, n),
                                      check_invariants=False)
        out = torch.sparse.mm(csr, rhs_t.to(dt).reshape(n, -1))
        return NDArray(out.reshape(out_shape))
    contrib = vals.reshape((-1,) + (1,) * (rhs_t.dim() - 1)) \
        * rhs_t.index_select(0, _csr_rows(lhs.indptr._data, nnz))
    out = torch.zeros(out_shape, dtype=contrib.dtype, device=dev)
    return NDArray(out.index_add_(0, cols, contrib))
