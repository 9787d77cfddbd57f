"""``DataLoaderIter``: a Gluon ``DataLoader`` as a ``DataIter`` for
``Module`` code (reference: python/mxnet/contrib/io.py).  The batches are
the loader's own NDArrays, on the device the loader puts them."""
from __future__ import annotations

from ..io import DataBatch, DataDesc, DataIter

__all__ = ["DataLoaderIter"]


class DataLoaderIter(DataIter):
    def __init__(self, loader, data_name="data", label_name="softmax_label"):
        sampler = getattr(loader, "_batch_sampler", None)
        super().__init__(
            batch_size=getattr(sampler, "_batch_size", 0) if sampler else 0)
        self._loader = loader
        self._iter = iter(loader)
        self._data_name = data_name
        self._label_name = label_name
        self._first = next(self._iter, None)

    @property
    def provide_data(self):
        if self._first is None:
            return []
        d = self._first[0] if isinstance(self._first, (list, tuple)) \
            else self._first
        return [DataDesc(self._data_name, d.shape, d.dtype)]

    @property
    def provide_label(self):
        if not isinstance(self._first, (list, tuple)) or len(self._first) < 2:
            return []
        lbl = self._first[1]
        return [DataDesc(self._label_name, lbl.shape, lbl.dtype)]

    def reset(self):
        self._iter = iter(self._loader)
        self._first = None

    def next(self):
        if self._first is not None:
            batch, self._first = self._first, None
        else:
            batch = next(self._iter)
        if isinstance(batch, (list, tuple)):
            data, label = batch[0], batch[1] if len(batch) > 1 else None
        else:
            data, label = batch, None
        return DataBatch([data], [label] if label is not None else None,
                         pad=0)
