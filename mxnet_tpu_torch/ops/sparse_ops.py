"""Sparse storage operators in the registry: the port of
``mxnet_tpu/ops/sparse_ops.py`` (``cast_storage`` ``:24-59``,
``_sparse_retain`` ``:62-77``).

Sparse values cross the op boundary as padded, static-capacity tuples
``(data, indices[, indptr], nnz)``, so the ops never sync with the host
(unlike ``ndarray.sparse.cast_storage``, which returns the exact nnz):
the caller picks a capacity (0 is the worst case, always exact), rows or
entries past ``nnz`` carry an out-of-range index (``shape[0]``) and zero
data, the indices are int32 and ``nnz`` is a 0-d int32 output, as in the
reference.  The positions of the first ``capacity`` nonzeros come from a
running count, scattered into a buffer with one spare slot that takes
the rest.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["cast_storage", "sparse_retain", "find_rows"]


def _first_nonzeros(mask, cap, fill):
    """The flat positions of the first ``cap`` True entries of 1-D
    ``mask``, in order, padded with ``fill``."""
    n = mask.shape[0]
    rank = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (rank < cap), rank, cap)
    buf = torch.full((cap + 1,), fill, dtype=torch.int64, device=mask.device)
    # unique slots below cap; the spare slot cap takes every other entry
    buf.scatter_(0, slot, torch.arange(n, device=mask.device))
    return buf[:cap]


def find_rows(src_idx, keep):
    """(hit mask, position in ``src_idx``) of each int64 index of ``keep``
    among the int64 ``src_idx`` (not empty), in any order: a stable sort,
    then a binary search (a repeated stored index finds its first
    occurrence; where the stored indices are sorted, as the reference
    assumes, the sort is the identity)."""
    sorted_idx, order = torch.sort(src_idx, stable=True)
    pos = torch.searchsorted(sorted_idx, keep).clamp_(
        max=src_idx.shape[0] - 1)
    return sorted_idx[pos] == keep, order[pos]


@register("cast_storage", arg_names=["data"],
          num_outputs=lambda p: 4 if p.get("stype") == "csr" else 3)
def cast_storage(data, stype="row_sparse", capacity=0):
    """Dense -> padded sparse encoding on the data's device.

    ``row_sparse`` returns ``(values, row_indices, nnz)`` with
    ``values.shape = (capacity,) + data.shape[1:]``; ``csr`` (2-D data)
    returns ``(values, col_indices, indptr, nnz)`` with element capacity
    padding (padding columns are 0).  ``capacity=0`` means the worst case
    (``shape[0]`` rows / ``size`` elements)."""
    if stype == "row_sparse":
        n = data.shape[0]
        cap = int(capacity) or n
        row_nz = (data.reshape(n, -1) != 0).any(-1)
        idx = _first_nonzeros(row_nz, cap, n)
        hit = idx < n
        vals = torch.where(hit.reshape((-1,) + (1,) * (data.dim() - 1)),
                           data[idx.clamp(max=n - 1)], 0)
        return vals, idx.int(), row_nz.sum().int()
    if stype == "csr":
        if data.dim() != 2:
            raise ValueError("csr needs 2-D data, got %d-D" % data.dim())
        n, m = data.shape
        cap = int(capacity) or data.numel()
        flat = _first_nonzeros((data != 0).reshape(-1), cap, n * m)
        hit = flat < n * m
        rows = torch.where(hit, flat // m, n)
        cols = torch.where(hit, flat % m, 0)
        vals = torch.where(hit, data.reshape(-1)[flat.clamp(max=n * m - 1)],
                           0)
        # indptr[r] = the kept entries in rows before r (rows sorted, the
        # padding's n last)
        indptr = torch.searchsorted(rows, torch.arange(n + 1,
                                                       device=data.device))
        return vals, cols.int(), indptr.int(), hit.sum().int()
    raise ValueError("cast_storage target %r" % (stype,))


@register("_sparse_retain", arg_names=["data", "indices", "new_idx"],
          num_outputs=2)
def sparse_retain(data, indices, new_idx):
    """The rows ``new_idx`` of a (padded) row-sparse pair ``(data,
    indices)``, as ``(rows, new_idx)`` with int32 indices: a requested
    row the source lacks comes out zero.  The source indices may come in
    any order (ROADMAP.md C10)."""
    keep = new_idx.long()
    out_shape = (keep.shape[0],) + tuple(data.shape[1:])
    if indices.shape[0] == 0:
        return (torch.zeros(out_shape, dtype=data.dtype, device=data.device),
                keep.int())
    hit, pos = find_rows(indices.long(), keep)
    return (torch.where(hit.reshape((-1,) + (1,) * (data.dim() - 1)),
                        data.index_select(0, pos), 0), keep.int())
