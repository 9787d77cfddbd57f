"""KVStore: the port of ``mxnet_tpu/kvstore.py``.

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

**The ``dist_*`` types** (``mxnet_tpu/kvstore.py:41-125,176-260``):

- ``dist_sync`` (``dist``, ``dist_device_sync``, ``tpu_dist``): every
  process holds a replica; a push sums the local values, then sums over
  the processes with ``torch.distributed.all_reduce``, then updates or
  replaces as above.  The process group comes from the launcher's env
  (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``, or the
  ``DMLC_*`` names, ``tools/launch.py``) and is created by the first
  ``dist_*`` store, not at import; a group that is already up is used.
  Env that names a cluster that does not form within
  ``MXTPU_DIST_TIMEOUT_S`` (300 s) raises.  The backend rule
  is stated and printed, never switched: NCCL when every process on the
  host owns a distinct card, gloo when the ranks share one card or there
  is none.  Over gloo a CUDA value goes to gloo as it is: gloo stages it
  through the host, faster than an explicit copy (``tools/bandwidth.py``
  times both).  With 2-bit compression the processes all-gather
  the packed payloads and each decodes and sums them in rank order.
- ``dist_async``: pushes go to a parameter server (``kvstore_ps``),
  which applies each on arrival; the server is embedded in rank 0, or a
  dedicated ``DMLC_ROLE=server`` process (``DMLC_NUM_SERVER`` > 0,
  ``kvstore_server``), which a single worker uses too (the reference's
  leaves it idle).  Every push carries the store's step for the
  bounded-staleness gate; a refused push pulls fresh state, takes the
  fleet's step and is sent again.  ``set_optimizer`` ships a pickled
  copy of the optimizer to the server, as the reference does.
- ``barrier`` and ``get_num_dead_node`` go to the process group or the
  server; ``rank`` and ``num_workers`` are the process's.

Without a launcher's env a ``dist_*`` store is rank 0 of 1 and behaves
like ``local``.
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys

import numpy as np
import torch

from . import optimizer as opt
from .base import MXNetError
from .ndarray import NDArray
from .ndarray.sparse import RowSparseNDArray
from . import ndarray as nd

__all__ = ["KVStore", "create"]

_LOCAL_TYPES = ("local", "device", "nccl")
_SYNC_TYPES = ("dist_sync", "dist_device_sync", "tpu_dist")
_DIST_TYPES = _SYNC_TYPES + ("dist_async", "dist")


def _env_world():
    """``(rank, world)`` from the launcher's env, or None without one."""
    for r, w in (("RANK", "WORLD_SIZE"), ("DMLC_WORKER_ID", "DMLC_NUM_WORKER")):
        if os.environ.get(w):
            return int(os.environ.get(r, "0")), int(os.environ[w])
    return None


def backend_rule(world=None):
    """``(backend, reason)`` of the dist_sync process group: NCCL when
    every process on this host owns a distinct card, else gloo."""
    world = int(world or (_env_world() or (0, 1))[1])
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        return "gloo", "no CUDA device: the ranks hold host tensors"
    if local <= cards:
        return "nccl", "each of the %d local ranks owns a distinct card"             % local
    return "gloo", "%d local ranks share %d card(s)" % (local, cards)


def _process_group():
    """``(rank, world)`` of the default process group, creating it from
    the launcher's env at the first call (``(0, 1)`` without one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = _env_world()
    if env is None or env[1] <= 1:
        return 0, 1
    rank, world = env
    backend, reason = backend_rule(world)
    addr = os.environ.get("MASTER_ADDR") or os.environ.get(
        "DMLC_PS_ROOT_URI", "127.0.0.1")
    port = os.environ.get("MASTER_PORT") or os.environ.get(
        "DMLC_PS_ROOT_PORT")
    if not port:
        raise MXNetError(
            "distributed kvstore: WORLD_SIZE=%d but no MASTER_PORT "
            "(tools/launch.py sets it)" % world)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    try:
        dist.init_process_group(
            backend, init_method="tcp://%s:%s" % (addr, port), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=float(
                os.environ.get("MXTPU_DIST_TIMEOUT_S", "300"))))
    except Exception as e:
        raise MXNetError(
            "distributed kvstore requested with WORLD_SIZE=%d but the "
            "process group did not form at %s:%s: %s"
            % (world, addr, port, e)) from e
    print("mxnet_tpu_torch.kvstore: rank %d of %d over %s (%s%s)"
          % (rank, world, backend, reason,
             "; CUDA values go to gloo as they are"
             if backend == "gloo" and torch.cuda.is_available() else ""),
          file=sys.stderr)
    return rank, world


def _all_reduce_sum(t):
    """Sum ``t`` over the processes, in place."""
    import torch.distributed as dist
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def _all_gather_packed(packed):
    """Every process's packed uint8 payload, in rank order."""
    import torch.distributed as dist
    t = torch.from_numpy(np.ascontiguousarray(packed))
    if dist.get_backend() == "nccl":
        t = t.cuda()
    outs = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, t)
    return [o.cpu().numpy() for o in outs]


class KVStore:
    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._compression = None
        self._residuals = {}
        self._ps_client = None
        self._ps_server = None
        self._rank, self._num_workers = 0, 1
        if kv_type in _SYNC_TYPES:
            self._rank, self._num_workers = _process_group()
        elif kv_type == "dist_async":
            self._rank, self._num_workers = _env_world() or (0, 1)
            # more than one worker, or a launcher's dedicated server rank
            # to talk to (a single worker beside ``launch.py -s 1``)
            if self._num_workers > 1 or \
                    int(os.environ.get("DMLC_NUM_SERVER", "0")) > 0:
                self._start_ps()

    def _start_ps(self):
        """dist_async rides a host-side parameter server
        (``kvstore.py:81-125``): a dedicated server rank
        (``DMLC_NUM_SERVER`` > 0, spawned by ``tools/launch.py -s 1``,
        recoverable through its state dir) or one embedded in rank 0.
        Heartbeats feed the server's watchdog, and ``MXTPU_PS_STATE_DIR``
        arms snapshot + WAL durability for the embedded server too."""
        from . import kvstore_ps
        from .kvstore_server import _durability_env, _elasticity_env
        host = os.environ.get("MASTER_ADDR") or os.environ.get(
            "DMLC_PS_ROOT_URI", "127.0.0.1")
        port = int(os.environ.get("MXTPU_PS_PORT", "0"))
        if not port:
            raise MXNetError(
                "dist_async needs MXTPU_PS_PORT (tools/launch.py sets it)")
        hb_interval = float(os.environ.get("MXTPU_HEARTBEAT_INTERVAL_S",
                                           "2.0"))
        hb_timeout, staleness = _elasticity_env()
        if self._rank == 0 and int(os.environ.get("DMLC_NUM_SERVER",
                                                  "0")) == 0:
            state_dir, snapshot_every, keep = _durability_env()
            self._ps_server = kvstore_ps.PSServer(
                port=port, num_workers=self._num_workers,
                heartbeat_timeout_s=hb_timeout, max_staleness=staleness,
                state_dir=state_dir, snapshot_every=snapshot_every,
                snapshot_keep=keep)
        self._ps_client = kvstore_ps.PSClient(host, port, rank=self._rank)
        self._push_step = 0
        if hb_interval > 0:
            self._ps_client.start_heartbeat(
                hb_interval, step_fn=lambda: self._push_step)

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._num_workers

    @property
    def has_updater(self):
        return self._updater is not None

    @property
    def compression(self):
        """The active gradient-compression config, or None."""
        return self._compression

    def _cross_process(self):
        return self.type in _SYNC_TYPES and self._num_workers > 1

    def init(self, key, value):
        for k, v in zip(*_key_value(key, value)):
            if k in self._store:
                raise MXNetError("key %r already initialized" % (k,))
            self._store[k] = v if isinstance(v, NDArray) else nd.array(v)
            if self._ps_client is not None:
                self._ps_client.init_array(k, np.asarray(
                    self._store[k].asnumpy(), np.float32))

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
            if self._ps_client is not None:
                self._ps_push(k, merged)
                continue
            if self._compression is not None:
                merged = NDArray(self._compress(k, merged._data))
                if self._cross_process():
                    merged = self._sum_packed(merged)
            elif self._cross_process():
                if isinstance(merged, RowSparseNDArray):
                    merged = merged.todense()
                merged = NDArray(_all_reduce_sum(merged._data.clone()))
            stored = self._store.get(k)
            if stored is None:
                raise MXNetError("key %r not initialized" % (k,))
            if self._updater is not None:
                self._updater(k, merged, stored)
            else:
                if isinstance(merged, RowSparseNDArray):
                    merged = merged.todense()
                stored._set_data(merged._data.to(stored._data.device, copy=True))

    def _sum_packed(self, q):
        """The compressed cross-process sum (``kvstore.py:410-434``): the
        2-bit packed payloads are all-gathered, decoded and summed in
        rank order, in f32, on every process."""
        from . import kvstore_ps
        thr = self._compression["threshold"]
        packed, shape = kvstore_ps.pack_2bit(q.asnumpy(), thr)
        total = np.zeros(shape, np.float32)
        for payload in _all_gather_packed(packed):
            total += kvstore_ps.unpack_2bit(payload, shape, thr)
        return NDArray(torch.from_numpy(total).to(q._data.device))

    def _ps_push(self, k, merged):
        """Async push (``kvstore.py:205-245``): the gradient goes to the
        PS, which applies it at once.  Every wire form (dense, rsp, 2bit)
        carries the store's step, so the bounded-staleness gate sees all
        of them; a refused push pulls fresh state, takes the fleet's step
        and is sent again (the compressed payload as it was: error
        feedback has already moved the residuals)."""
        from . import kvstore_ps
        self._push_step += 1
        if isinstance(merged, RowSparseNDArray):
            payload = (np.asarray(merged.indices.asnumpy(), np.int64),
                       np.asarray(merged.data.asnumpy(), np.float32),
                       tuple(merged.shape))
            send = lambda: self._ps_client.request(
                "push", k, "rsp", payload, self._push_step)
        elif self._compression is not None:
            thr = self._compression["threshold"]
            q = self._compress(k, merged._data)
            packed, shape = kvstore_ps.pack_2bit(
                q.detach().cpu().numpy(), thr)
            send = lambda: self._ps_client.request(
                "push", k, "2bit", (packed, shape, thr), self._push_step)
        else:
            arr = np.asarray(merged.asnumpy(), np.float32)
            send = lambda: self._ps_client.push_array(
                k, arr, step=self._push_step)
        try:
            send()
        except kvstore_ps.StaleWorkerError as e:
            self._set_from_server(k)
            self._push_step = e.max_step
            send()

    def _set_from_server(self, k):
        stored = self._store[k]
        arr = self._ps_client.pull_array(k)
        stored._set_data(torch.from_numpy(np.array(arr, np.float32)).to(
            stored._data.device))
        return stored

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        for k, o in zip(*_key_value(key, out)):
            stored = self._set_from_server(k) if self._ps_client is not None \
                else self._store[k]
            for dst in o if isinstance(o, (list, tuple)) else [o]:
                if dst._data is not stored._data:
                    dst._set_data(stored._data.detach().to(
                        dst._data.device, copy=True))

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
                    dst._set_data(stored._data.detach().to(
                        dst._data.device, copy=True))
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
        """Run ``optimizer`` on the store at push time (this object; on a
        parameter server, a pickled copy of it)."""
        if isinstance(optimizer, str):
            optimizer = opt.create(optimizer)
        if self._ps_client is not None:
            self._ps_client.request("set_optimizer", pickle.dumps(optimizer))
            return
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

    def barrier(self):
        """Wait for every worker: on the server for ``dist_async``, over
        the process group for ``dist_sync``; nothing in one process."""
        if self._ps_client is not None:
            self._ps_client.request("barrier")
        elif self._cross_process():
            import torch.distributed as dist
            dist.barrier()

    _barrier_before_exit = barrier

    def get_num_dead_node(self, node_id=0):
        """Workers the parameter server counts dead (``kvstore.h:339``);
        1 when the server itself is unreachable; 0 without a server."""
        if self._ps_client is not None:
            try:
                return int(self._ps_client.request("num_dead")[1])
            except (OSError, ConnectionError):
                return 1
        return 0

    def close(self):
        """Stop this store's heartbeat, client and embedded server."""
        if self._ps_client is not None:
            self._ps_client.close()
            self._ps_client = None
        if self._ps_server is not None:
            self._ps_server.stop()
            self._ps_server = None


def _key_value(key, value):
    if isinstance(key, (str, int)):
        return [key], [value]
    if value is None:
        return list(key), [None] * len(key)
    return list(key), list(value)


def create(name="local"):
    """A store of type ``name``: ``local``, ``device`` or ``nccl`` (one
    process), or a ``dist_*`` type (``dist`` is ``dist_sync``)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name == "dist":
        name = "dist_sync"
    if name not in _LOCAL_TYPES + _DIST_TYPES:
        raise MXNetError("unknown KVStore type %r (known: %s)"
                         % (name, _LOCAL_TYPES + _DIST_TYPES))
    return KVStore(name)
