"""Multi-process decode/augment pipeline with shared-memory transport.

The port of ``mxnet_tpu/io/pipeline.py``.  Reference: the C++
``ImageRecordIter`` escapes Python entirely — ``preprocess_threads`` OMP
workers decode into pinned buffers and a prefetcher thread double-buffers
the copy (``src/io/iter_image_recordio_2.cc``, ``iter_prefetcher.h``).  A
thread pool in Python shares one interpreter lock, so this module is the
process-parallel analogue:

- **workers** are real processes (forkserver: ``fork()`` from a parent
  that holds a CUDA context and threads is unsafe).  The forkserver
  preloads this package, so a worker starts as a fork of an interpreter
  that has already imported torch, not a fresh import.  Each worker owns
  its own RecordIO handle and decodes/augments whole batches in numpy
  (``ImageIter.next_numpy``); it creates no tensor, and after every batch
  it checks that CUDA is still uninitialised in it, failing the batch
  otherwise: a worker never holds a CUDA context.
- **transport** is a pickle-free shared-memory ring: one ``SharedMemory``
  block sliced into per-worker slot sets.  A worker writes the decoded
  batch straight into its slot and sends only ``(epoch, batch, slot, pad)``
  through a queue; the consumer copies the batch out, frees the slot and
  reorders by batch index.  Depth is bounded at ``prefetch_buffer`` slots
  per worker — a slow consumer stops dispatching tasks, which stops the
  workers (backpressure), it never grows memory.
- **determinism**: batches are assigned round-robin (batch ``b`` belongs to
  worker ``b % W``) and the augmentation RNG is seeded per *batch index*,
  not per worker — so the emitted stream is bitwise-identical for any
  worker count, including the in-process ``num_workers=0`` path (which
  runs the exact same decode function inline).
- **failure**: a crashed worker is detected by liveness polling, respawned,
  and its undelivered batches are re-dispatched in order — nothing is
  dropped or duplicated (the reorder buffer is keyed by batch index).
  Platforms without ``multiprocessing.shared_memory`` degrade to the
  in-process path with a one-time warning.

Batches come out as CPU NDArrays; ``DeviceFeedIter`` (or
``ImageRecordIter(device_tail=True)``) moves them to the card.
"""
from __future__ import annotations

import collections
import logging
import multiprocessing as _mp
import os
import queue as _queue
import random as _random
import time as _time
import warnings

import numpy as _np

from ..base import MXNetError
from ..resilience import chaos as _chaos
from . import DataBatch, DataIter

__all__ = ["ImagePipelineIter", "PipelineWorkerStorm", "pipeline_available",
           "seed_for_batch"]

_RESPAWN_LIMIT = 3          # default per-worker per-epoch crash budget
_POLL_S = 0.25              # consumer liveness-poll interval
_WORKER_POLL_S = 1.0        # worker-side bounded-blocking poll interval


class PipelineWorkerStorm(MXNetError):
    """A worker died more than ``max_respawns`` times within one epoch.

    A deterministic crasher (corrupt record that segfaults the decoder,
    OOM at a fixed batch) would otherwise respawn-loop forever — the
    respawn budget turns the loop into a clear, immediate error naming
    the worker and its crash count (docs/io.md failure semantics)."""


def pipeline_available():
    """True when the multi-process transport can run on this platform."""
    try:
        from multiprocessing import shared_memory  # noqa: F401
    except ImportError:
        return False
    try:
        _mp.get_context("forkserver")
    except ValueError:
        try:
            _mp.get_context("spawn")
        except ValueError:
            return False
    return True


# what the forkserver imports once, so that a forked worker finds torch
# and the decode and dataset code already loaded ("__main__" is the
# multiprocessing default)
_PRELOAD = ["__main__", "mxnet_tpu_torch.image", "mxnet_tpu_torch.gluon.data"]


def _mp_context():
    """The context workers start from: forkserver (preloading
    ``_PRELOAD``; the preload takes effect when this process starts its
    forkserver), else spawn."""
    try:
        ctx = _mp.get_context("forkserver")
    except ValueError:
        return _mp.get_context("spawn")
    ctx.set_forkserver_preload(_PRELOAD)
    return ctx


def _check_no_cuda(where):
    """Raise if CUDA was initialised in this (worker) process."""
    import torch
    if torch.cuda.is_initialized():
        raise MXNetError("%s initialised CUDA: a data worker must never "
                         "create a tensor on the card" % where)


def seed_for_batch(seed, epoch, batch_idx):
    """The per-batch RNG seed — a function of the *batch index*, never the
    worker, so any process (or the in-process path) produces the same
    augmentation stream for the same batch."""
    return (seed * 1_000_003 + epoch * 8191 + batch_idx) % (1 << 32)


def _seed_rngs(seed, epoch, batch_idx):
    if seed is None:
        return
    s = seed_for_batch(seed, epoch, batch_idx)
    _random.seed(s)
    _np.random.seed(s)


def _attach_shm(name):
    """Attach to an existing SharedMemory block WITHOUT registering it with
    this process's resource tracker: the parent is the sole owner/unlinker,
    and a second registration makes the tracker double-unlink at exit."""
    from multiprocessing import resource_tracker, shared_memory
    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig


class _SlotLayout:
    """Byte layout of one ring slot: data block then label block, both at
    full batch capacity (partial tail batches use a row-count header in the
    queue message, not the buffer)."""

    def __init__(self, data_shape, data_dtype, label_shape):
        self.data_shape = tuple(data_shape)
        self.data_dtype = _np.dtype(data_dtype)
        self.label_shape = tuple(label_shape)
        self.data_bytes = int(_np.prod(self.data_shape)) * \
            self.data_dtype.itemsize
        self.label_bytes = int(_np.prod(self.label_shape)) * 4
        self.slot_bytes = self.data_bytes + self.label_bytes

    def views(self, buf, slot):
        """(data, label) numpy views over slot ``slot`` of ``buf``."""
        base = slot * self.slot_bytes
        data = _np.ndarray(self.data_shape, self.data_dtype,
                           buffer=buf, offset=base)
        label = _np.ndarray(self.label_shape, _np.float32,
                            buffer=buf, offset=base + self.data_bytes)
        return data, label


def _worker_main(wid, shm_name, layout, iter_kwargs, aug_list, seed,
                 task_q, free_q, ready_q):
    """Worker process body: pull (epoch, batch_idx, keys) tasks, decode the
    batch in numpy, write it into a free shared-memory slot, announce it.

    ``ready_q`` is this worker's OWN announce queue (single writer): a
    worker killed mid-``put`` dies holding only its own queue's write lock,
    which the parent discards at respawn — a shared queue would be poisoned
    for every surviving worker.

    Creates no tensor: the decode core is ``ImageIter.next_numpy`` and the
    output leaves through shared memory; after each batch the worker
    checks that CUDA is uninitialised in it (``_check_no_cuda``), so a
    worker that touched the card fails its batch instead of running on.

    Every blocking wait is bounded (the SRC005 discipline): the task and
    slot waits poll at ``_WORKER_POLL_S`` and re-check that the parent is
    still alive — an orphaned worker (parent SIGKILLed) exits instead of
    blocking on a queue nobody will ever feed again."""
    parent = os.getppid()
    shm = _attach_shm(shm_name)
    try:
        from ..image import ImageIter
        it = ImageIter(aug_list=list(aug_list), shuffle=False, **iter_kwargs)
        while True:
            try:
                task = task_q.get(timeout=_WORKER_POLL_S)
            except _queue.Empty:
                if os.getppid() != parent:
                    return          # orphaned: the parent died
                continue
            if task is None:
                break
            epoch, batch_idx, keys = task
            while True:             # backpressure: bounded slots
                try:
                    slot = free_q.get(timeout=_WORKER_POLL_S)
                    break
                except _queue.Empty:
                    if os.getppid() != parent:
                        return
            t0 = _time.perf_counter()
            try:
                _seed_rngs(seed, epoch, batch_idx)
                it.seq = list(keys)
                it.cur = 0
                data, label, pad = it.next_numpy()
                _check_no_cuda("pipeline worker %d" % wid)
                dview, lview = layout.views(shm.buf, slot)
                n = data.shape[0]
                dview[:n] = data
                lview[:n] = label
                busy = _time.perf_counter() - t0
                ready_q.put(("batch", epoch, batch_idx, wid, slot, n, pad,
                             busy))
            except BaseException as e:   # surface decode errors, keep going
                free_q.put(slot)
                ready_q.put(("error", epoch, batch_idx, wid,
                             "%s: %s" % (type(e).__name__, e)))
    finally:
        shm.close()


class ImagePipelineIter(DataIter):
    """Image iterator backed by the multi-process shared-memory pipeline.

    Takes the same kwargs as :class:`~mxnet_tpu_torch.image.ImageIter`
    plus:

    num_workers : int — decode/augment processes.  0 runs the identical
        decode path inline (the fallback, and the equivalence baseline).
    prefetch_buffer : int — shared-memory slots *per worker* (ring depth);
        also bounds how many undelivered batches a worker may own.
    seed : int or None — deterministic per-batch RNG seeding.  With a seed
        the output stream is bitwise-identical for ANY ``num_workers``;
        ``None`` leaves worker RNGs free-running (fastest shuffle of
        entropy, no reproducibility).
    max_respawns : int — crash budget per worker *per epoch* (default 3);
        exceeding it raises :class:`PipelineWorkerStorm` instead of
        respawn-looping forever on a deterministic crasher.
    """

    def __init__(self, num_workers=None, prefetch_buffer=2, seed=None,
                 max_respawns=_RESPAWN_LIMIT, **kwargs):
        from .. import profiler as _profiler
        from ..image import ImageIter
        if num_workers is None:
            num_workers = min(4, os.cpu_count() or 1)
        self._requested_workers = int(num_workers)
        self._depth = max(1, int(prefetch_buffer))
        self._seed = seed
        self._shuffle = bool(kwargs.pop("shuffle", False))
        self._epoch = 0

        # template: builds the record index + augmenter chain once, serves
        # as the in-process decoder, and donates its auglist to workers so
        # order-randomised chains (ColorJitterAug shuffles at construction)
        # are identical everywhere
        self._template = ImageIter(shuffle=False, **kwargs)
        super().__init__(self._template.batch_size)
        self._base_seq = list(self._template.seq)
        if not self._base_seq:
            raise MXNetError("pipeline needs a keyed record source "
                             "(path_imgrec with an index, or an imglist)")
        self._iter_kwargs = dict(kwargs)
        self._iter_kwargs.pop("aug_list", None)
        self._aug_list = self._template.auglist
        self._last_batch_handle = self._template.last_batch_handle

        self._n_workers = self._requested_workers
        if self._n_workers > 0 and not pipeline_available():
            warnings.warn(
                "multiprocessing shared memory unavailable on this "
                "platform; ImagePipelineIter falls back to in-process "
                "decoding", RuntimeWarning)
            self._n_workers = 0

        d = self._template.provide_data[0]
        lw = self._template.label_width
        self._layout = _SlotLayout(d.shape, d.dtype, (self.batch_size, lw))
        self.stats = _profiler.PipelineStats(self._n_workers)

        self._shm = None
        self._procs = []
        self._task_qs = []
        self._free_qs = []
        self._ready_qs = []
        self._respawns = 0
        self._max_respawns = int(max_respawns)
        # per-worker per-epoch crash counts (the storm budget's unit)
        self._worker_respawns = [0] * max(1, self._n_workers)
        if self._n_workers > 0:
            self._start_workers()
        self._begin_epoch()

    # -- process management ------------------------------------------------
    def _start_workers(self):
        from multiprocessing import shared_memory
        ctx = _mp_context()
        self._ctx = ctx
        n_slots = self._n_workers * self._depth
        self._shm = shared_memory.SharedMemory(
            create=True, size=n_slots * self._layout.slot_bytes)
        self._ready_qs = []             # one per worker: single writer
        self._slot_owner = {}           # slot -> worker id
        for w in range(self._n_workers):
            self._task_qs.append(None)
            self._free_qs.append(None)
            self._ready_qs.append(None)
            self._procs.append(None)
            self._spawn_worker(w)

    def _spawn_worker(self, wid):
        """(Re)create worker ``wid`` with fresh queues and all of its slots
        free.  Used at startup and after a crash — the caller re-dispatches
        any undelivered batches.  Queues are never reused across a worker
        generation: a SIGKILLed worker may die holding its ready queue's
        write lock or with a half-written pickle in the pipe, either of
        which would wedge a reader forever."""
        ctx = self._ctx
        task_q = ctx.Queue()
        free_q = ctx.Queue()
        ready_q = ctx.Queue()
        for s in range(wid * self._depth, (wid + 1) * self._depth):
            free_q.put(s)
            self._slot_owner[s] = wid
        proc = ctx.Process(
            target=_worker_main,
            args=(wid, self._shm.name, self._layout, self._iter_kwargs,
                  self._aug_list, self._seed, task_q, free_q, ready_q),
            daemon=True)
        proc.start()
        self._task_qs[wid] = task_q
        self._free_qs[wid] = free_q
        self._ready_qs[wid] = ready_q
        self._procs[wid] = proc

    def _discard_queues(self, wid):
        for qs in (self._task_qs, self._free_qs, self._ready_qs):
            q = qs[wid]
            if q is not None:
                q.cancel_join_thread()
                q.close()
                qs[wid] = None

    # -- epoch plumbing ----------------------------------------------------
    def _begin_epoch(self):
        order = list(self._base_seq)
        if self._shuffle:
            rng = _np.random.RandomState(
                None if self._seed is None else
                (self._seed + self._epoch) % (1 << 32))
            order = [order[i] for i in rng.permutation(len(order))]
        b = self.batch_size
        batches = [order[i:i + b] for i in range(0, len(order), b)]
        if batches and len(batches[-1]) < b and \
                self._last_batch_handle == "discard":
            batches.pop()
        self._batches = batches
        self._next_out = 0               # next batch index to emit
        self._done = {}                  # batch_idx -> (data, label, pad)
        self._in_flight = [collections.deque()
                           for _ in range(max(1, self._n_workers))]
        # strict round-robin ownership: worker w owns batches w, w+W, ...
        # — each worker's batch-index stream is monotonic, which is what
        # makes the slot ring deadlock-free (docs/io.md)
        self._next_for_worker = list(range(max(1, self._n_workers)))
        self._exhausted = not batches
        # a fresh epoch resets the crash budget: the storm bound is
        # "max_respawns per worker per epoch"
        self._worker_respawns = [0] * max(1, self._n_workers)
        self.stats.on_epoch()
        if self._n_workers > 0:
            self._fill_dispatch()

    def _fill_dispatch(self):
        """Top up every worker to at most ``depth`` undelivered batches —
        the task side of the backpressure bound (a slow consumer stops
        calling this, which idles the workers)."""
        for wid in range(self._n_workers):
            while self._next_for_worker[wid] < len(self._batches) and \
                    len(self._in_flight[wid]) < self._depth:
                self._dispatch(wid, self._next_for_worker[wid])
                self._next_for_worker[wid] += self._n_workers

    def _dispatch(self, wid, batch_idx):
        # chaos probe: a scheduled fault SIGKILLs a worker (action "call"
        # through ctx) or delays dispatch at a chosen batch index
        _chaos.maybe_inject("pipeline.dispatch", ctx=(self, wid, batch_idx))
        keys = self._batches[batch_idx]
        self._in_flight[wid].append((self._epoch, batch_idx))
        self._task_qs[wid].put((self._epoch, batch_idx, keys))

    # -- consumption -------------------------------------------------------
    def _pump(self, block=True):
        """Drain whatever the workers have announced into the reorder
        buffer.  Blocks (bounded) on the ready pipes via connection.wait;
        every timeout polls worker liveness and recovers crashes.  Returns
        True when at least one message was consumed."""
        got = False
        for wid in range(self._n_workers):
            q = self._ready_qs[wid]
            while q is not None:
                try:
                    msg = q.get_nowait()
                except _queue.Empty:
                    break
                self._handle_msg(msg)
                got = True
        if got or not block:
            return got
        import multiprocessing.connection as _conn
        readers = [q._reader for q in self._ready_qs if q is not None]
        _conn.wait(readers, timeout=_POLL_S)
        if not any(r.poll() for r in readers):
            self._check_workers()
        return False

    def _handle_msg(self, msg):
        if msg[0] == "error":
            _, epoch, batch_idx, wid, text = msg
            if epoch != self._epoch:
                return
            self._forget_in_flight(wid, batch_idx)
            raise MXNetError("pipeline worker %d failed on batch %d: %s"
                             % (wid, batch_idx, text))
        _, epoch, batch_idx, wid, slot, n, pad, busy = msg
        data_v, label_v = self._layout.views(self._shm.buf, slot)
        if epoch == self._epoch:
            # copy out so the slot can recycle immediately; the reorder
            # buffer is bounded by the dispatch throttle (<= W*depth)
            self._done[batch_idx] = (data_v[:n].copy(), label_v[:n].copy(),
                                     pad)
            self._forget_in_flight(wid, batch_idx)
            self.stats.on_batch(wid, busy, len(self._done))
        # stale-epoch deliveries (reset() mid-epoch) just recycle the slot
        owner = self._slot_owner[slot]
        if self._free_qs[owner] is not None:
            self._free_qs[owner].put(slot)

    def _forget_in_flight(self, wid, batch_idx):
        try:
            self._in_flight[wid].remove((self._epoch, batch_idx))
        except ValueError:
            pass

    def _check_workers(self):
        for wid, proc in enumerate(self._procs):
            if proc is None or proc.is_alive():
                continue
            self._recover_worker(wid, proc)

    def _recover_worker(self, wid, proc):
        """Respawn a dead worker and re-dispatch its undelivered batches —
        exactly-once delivery: anything it DID deliver sits in the reorder
        buffer keyed by batch index, anything it did not is re-sent.  The
        dead worker's queues are dropped wholesale (see _spawn_worker), so
        deliveries it completed but the parent had not yet pumped are
        simply re-decoded — wasted work, never a duplicate, because the
        reorder buffer keys on batch index."""
        self._respawns += 1
        self._worker_respawns[wid] += 1
        self.stats.on_respawn()
        if self._worker_respawns[wid] > self._max_respawns:
            raise PipelineWorkerStorm(
                "pipeline worker %d died %d times this epoch (exitcode "
                "%s), exceeding max_respawns=%d — a deterministic "
                "crasher (corrupt record / repeatable OOM), not a "
                "transient fault; inspect the record at the failing "
                "batch instead of respawn-looping"
                % (wid, self._worker_respawns[wid], proc.exitcode,
                   self._max_respawns))
        logging.getLogger(__name__).warning(
            "pipeline worker %d died (exitcode %s); respawning and "
            "requeueing %d batches", wid, proc.exitcode,
            len(self._in_flight[wid]))
        lost = [(e, b) for (e, b) in self._in_flight[wid]
                if e == self._epoch and b not in self._done]
        self._in_flight[wid].clear()
        self._discard_queues(wid)
        self._spawn_worker(wid)
        for e, b in lost:
            self._in_flight[wid].append((e, b))
            self._task_qs[wid].put((e, b, self._batches[b]))

    # -- DataIter API ------------------------------------------------------
    @property
    def provide_data(self):
        return self._template.provide_data

    @property
    def provide_label(self):
        return self._template.provide_label

    def next(self):
        if self._exhausted or self._next_out >= len(self._batches):
            self._exhausted = True
            raise StopIteration
        want = self._next_out
        if self._n_workers == 0:
            _seed_rngs(self._seed, self._epoch, want)
            self._template.seq = list(self._batches[want])
            self._template.cur = 0
            data, label, pad = self._template.next_numpy()
        else:
            if not self._procs:
                raise MXNetError("pipeline is closed")
            t0 = _time.perf_counter()
            while want not in self._done:
                self._pump()
            self.stats.on_wait(_time.perf_counter() - t0)
            data, label, pad = self._done.pop(want)
            self._fill_dispatch()
        self._next_out += 1
        from .. import ndarray as nd
        lw = self._template.label_width
        d = nd.array(data, ctx="cpu", dtype=data.dtype)
        lab = nd.array(label if lw > 1 else label[:, 0], ctx="cpu")
        return DataBatch([d], [lab], pad=pad)

    def iter_next(self):
        raise NotImplementedError("use next()")

    def reset(self):
        self._epoch += 1
        if self._n_workers > 0:
            # stale tasks still queued for workers execute and are dropped
            # by epoch tag on delivery (bounded: <= depth per worker);
            # rebuilding processes every epoch would cost seconds
            while self._pump(block=False):
                pass
            self._done.clear()
        self._begin_epoch()

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        procs, self._procs = self._procs, []
        for p in procs:
            if p is not None and p.is_alive():
                p.terminate()
        for p in procs:
            if p is not None:
                p.join(timeout=5)
        for q in self._task_qs + self._free_qs + \
                getattr(self, "_ready_qs", []):
            if q is not None:
                q.cancel_join_thread()
                q.close()
        self._task_qs, self._free_qs, self._ready_qs = [], [], []
        if self._shm is not None:
            try:
                self._shm.close()
                self._shm.unlink()
            except (FileNotFoundError, OSError):
                pass
            self._shm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
