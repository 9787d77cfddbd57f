"""Datasets: the port's copy of ``mxnet_tpu/gluon/data/dataset.py``
(reference: python/mxnet/gluon/data/dataset.py).  Items stay on the host
(numpy, or CPU NDArrays); ``DataLoader`` moves each batch to the card."""
from __future__ import annotations

import os

import numpy as np

from ... import recordio as _recordio
from ...ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Abstract dataset: __getitem__ + __len__."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([s for s in self if fn(s)])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirst(fn), lazy)


class _TransformFirst:
    """``fn`` on a sample's first element (a class, not a closure, so a
    transformed dataset pickles to ``DataLoader`` workers, as MXNet's
    ``_TransformFirstClosure``)."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Zip of arrays/datasets (reference: dataset.py ArrayDataset)."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for a in args:
            assert len(a) == self._length, \
                "all arrays must have the same length"
            if isinstance(a, (np.ndarray, NDArray)) or \
                    hasattr(a, "__getitem__"):
                self._data.append(a)
            else:
                self._data.append(list(a))

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Dataset over an indexed RecordIO file
    (reference: dataset.py RecordFileDataset)."""

    def __init__(self, filename):
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = _recordio.MXIndexedRecordIO(self.idx_file,
                                                   self.filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
