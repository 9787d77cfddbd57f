"""Data iterators: the part of ``mxnet_tpu/io/__init__.py`` the symbolic
path uses — :class:`DataDesc`, :class:`DataBatch`, :class:`DataIter` and
:class:`NDArrayIter`.  Batches are host (CPU) NDArrays; the executor
moves a feed to its device.  The record, image and pipeline iterators
are ROADMAP.md queue A, item 3.
"""
from __future__ import annotations

import collections

import numpy as _np

from ..ndarray import NDArray, array as _nd_array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape"])):
    """Name/shape/dtype/layout of one input (reference: io.py:DataDesc)."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret


class DataBatch:
    """One batch: lists of data/label arrays plus bookkeeping
    (reference: io.py:118)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __repr__(self):
        shapes = [getattr(d, "shape", None) for d in (self.data or [])]
        return "DataBatch: data shapes %s" % (shapes,)


class DataIter:
    """Iterator base (reference: io.py:182)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Normalize a data/label argument into a list of (name, numpy)."""
    if data is None:
        return []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise ValueError("empty data")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("cannot interpret data: %r" % type(data))
    return [(k, v.asnumpy() if isinstance(v, NDArray) else _np.asarray(v))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays in order (reference: io.py:546); the
    last batch is padded by wrapping to the start, as the reference's
    default ``last_batch_handle="pad"``.  Shuffling and the other
    last-batch modes are ROADMAP.md queue A, item 3."""

    def __init__(self, data, label=None, batch_size=1, data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        self.num_batches = (self.num_data + batch_size - 1) // batch_size
        self.cursor = -1

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        self.cursor = -1

    def iter_next(self):
        self.cursor += 1
        return self.cursor < self.num_batches

    def _take(self, arrays):
        start = self.cursor * self.batch_size
        out = []
        for _, v in arrays:
            chunk = v[start:start + self.batch_size]
            if chunk.shape[0] < self.batch_size:
                # pad by wrapping (the reference pads from the beginning)
                pad = self.batch_size - chunk.shape[0]
                chunk = _np.concatenate([chunk, v[:pad]], axis=0)
            out.append(_nd_array(chunk, ctx="cpu", dtype=chunk.dtype))
        return out

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        return max(0, (self.cursor + 1) * self.batch_size - self.num_data)
