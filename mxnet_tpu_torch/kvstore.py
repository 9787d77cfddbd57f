"""KVStore in one process: the port of the ``local`` / ``device`` types of
``mxnet_tpu/kvstore.py``.

A store maps keys to NDArrays.  ``push`` sums a list of values per key
(the reference's ``Comm::Reduce``) and either runs the store's updater
on the stored value or replaces it; ``pull`` copies the stored value
into the given arrays.  ``init`` keeps the NDArray it is given, so a
store initialized from a ``Parameter``'s data updates that parameter in
place (the Gluon ``Trainer``'s ``update_on_kvstore`` route).
``set_optimizer`` runs the optimizer itself at push time, as MXNet's
local store does: its ``rescale_grad`` and learning rate are the
caller's.  (``mxnet_tpu``'s store runs a pickled copy, which a Gluon
``Trainer`` never updates; ROADMAP.md section C.)  2-bit gradient
compression with error feedback is the reference's arithmetic.

Row-sparse values (``ndarray.sparse.RowSparseNDArray``): a push of
several sums them over the union of their rows; the store's updater
takes the sum as it is (the optimizers update those rows alone), and a
store without one keeps it densified.  :meth:`KVStore.row_sparse_pull`
gives a row-sparse ``out`` the stored rows at the unique ``row_ids`` and
a dense ``out`` a copy of the whole stored array (never an alias: the
store updates in place).

One process is one worker (``rank`` 0 of ``num_workers`` 1).  The
``dist_*`` types raise: the parameter server is ROADMAP.md queue A,
item 6(b) (in-process data parallelism is ``DataParallelTrainer(mesh=)``).
"""
from __future__ import annotations

import torch

from . import optimizer as opt
from .base import MXNetError
from .ndarray import NDArray
from .ndarray.sparse import RowSparseNDArray
from . import ndarray as nd

__all__ = ["KVStore", "create"]

_LOCAL_TYPES = ("local", "device", "nccl")
_DIST_TYPES = ("dist_sync", "dist_device_sync", "dist_async", "dist",
               "tpu_dist")


class KVStore:
    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._compression = None
        self._residuals = {}

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    @property
    def has_updater(self):
        return self._updater is not None

    def init(self, key, value):
        for k, v in zip(*_key_value(key, value)):
            if k in self._store:
                raise MXNetError("key %r already initialized" % (k,))
            self._store[k] = v if isinstance(v, NDArray) else nd.array(v)

    @staticmethod
    def _merge(vlist):
        """The sum of one key's values (the reference's ``Comm::Reduce``):
        an NDArray, or a RowSparseNDArray over the union of the rows."""
        if isinstance(vlist[0], RowSparseNDArray):
            merged = vlist[0]
            for other in vlist[1:]:
                merged = merged + other
            return merged
        merged = vlist[0]._data
        for other in vlist[1:]:
            merged = merged + other._data.to(merged.device)
        return NDArray(merged)

    def push(self, key, value, priority=0):
        for k, v in zip(*_key_value(key, value)):
            merged = self._merge(list(v) if isinstance(v, (list, tuple))
                                 else [v])
            if self._compression is not None:
                merged = NDArray(self._compress(k, merged._data))
            stored = self._store.get(k)
            if stored is None:
                raise MXNetError("key %r not initialized" % (k,))
            if self._updater is not None:
                self._updater(k, merged, stored)
            else:
                if isinstance(merged, RowSparseNDArray):
                    merged = merged.todense()
                stored._set_data(merged._data.to(stored.context, copy=True))

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        for k, o in zip(*_key_value(key, out)):
            stored = self._store[k]
            for dst in o if isinstance(o, (list, tuple)) else [o]:
                if dst._data is not stored._data:
                    dst._set_data(stored._data.detach().to(dst.context,
                                                           copy=True))

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull the rows ``row_ids`` (reference: kvstore.h:195
        PullRowSparse): into a RowSparseNDArray ``out``, the stored rows at
        the unique ids, sorted; into a dense ``out``, the whole stored
        array.  ``row_ids`` is one NDArray for every ``out`` or a list,
        one per ``out``."""
        if row_ids is None:
            raise ValueError("row_sparse_pull requires row_ids")
        rid_list = list(row_ids) if isinstance(row_ids, (list, tuple)) \
            else [row_ids]
        for k, o in zip(*_key_value(key, out)):
            stored = self._store[k]
            olist = list(o) if isinstance(o, (list, tuple)) else [o]
            rids = rid_list if len(rid_list) == len(olist) \
                else rid_list * len(olist)
            for dst, rid in zip(olist, rids):
                if not isinstance(dst, RowSparseNDArray):
                    dst._set_data(stored._data.detach().to(dst.context,
                                                           copy=True))
                    continue
                if rid._data.device != stored._data.device:
                    raise MXNetError("row_ids on %s for a value on %s"
                                     % (rid._data.device,
                                        stored._data.device))
                idx = torch.unique(rid._data.long())
                dst.data = NDArray(stored._data.detach().index_select(0, idx))
                dst.indices = NDArray(idx)
                dst._shape = stored.shape

    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` on the store at push time."""
        if isinstance(optimizer, str):
            optimizer = opt.create(optimizer)
        self._updater = opt.get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        """2-bit quantization with error feedback (reference:
        src/kvstore/gradient_compression.h:52)."""
        ctype = compression_params.get("type", "2bit")
        if ctype != "2bit":
            raise ValueError("unsupported compression type %r" % ctype)
        self._compression = {
            "threshold": float(compression_params.get("threshold", 0.5))}

    def _compress(self, key, g):
        thr = self._compression["threshold"]
        resid = self._residuals.get(key)
        g = g + (torch.zeros_like(g) if resid is None else resid)
        q = torch.where(g >= thr, thr, torch.where(g <= -thr, -thr, 0.0))
        q = q.to(g.dtype)
        self._residuals[key] = g - q
        return q

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no optimizer set")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer set")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())



def _key_value(key, value):
    if isinstance(key, (str, int)):
        return [key], [value]
    if value is None:
        return list(key), [None] * len(key)
    return list(key), list(value)


def create(name="local"):
    """A store of type ``name``: ``local``, ``device`` or ``nccl`` (one
    process); the ``dist_*`` types raise."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in _DIST_TYPES:
        raise NotImplementedError(
            "kvstore %r: the parameter server is ROADMAP.md queue A, "
            "item 6(b)" % name)
    if name not in _LOCAL_TYPES:
        raise MXNetError("unknown KVStore type %r (known: %s)"
                         % (name, _LOCAL_TYPES + _DIST_TYPES))
    return KVStore(name)
