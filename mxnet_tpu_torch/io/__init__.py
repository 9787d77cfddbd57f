"""Data iterators: the part of ``mxnet_tpu/io/__init__.py`` the symbolic
path and the training feed use — :class:`DataDesc`, :class:`DataBatch`,
:class:`DataIter`, :class:`NDArrayIter` and the device feed
:class:`DeviceFeedIter` (``:438-629``; its training form
:class:`~.prefetch.PrefetchToDeviceIter` is in ``io/prefetch.py``).
``NDArrayIter`` yields host (CPU) NDArrays; the executor moves a feed to
its device, or a ``DeviceFeedIter`` moves it ahead of the consumer.  The
record, image and pipeline iterators, and a device-side transform tail,
are ROADMAP.md queue A, item 3.
"""
from __future__ import annotations

import collections
import queue as _queue
import threading
import time as _time

import numpy as _np
import torch

from ..base import resolve_device
from ..ndarray import NDArray, array as _nd_array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "DeviceFeedIter", "PrefetchToDeviceIter"]


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
    default ``last_batch_handle="pad"``, or dropped with ``"discard"``.
    Shuffling and ``"roll_over"`` are ROADMAP.md queue A, item 3."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        if shuffle or last_batch_handle not in ("pad", "discard"):
            raise NotImplementedError(
                "NDArrayIter(shuffle=True) and last_batch_handle=%r are "
                "ROADMAP.md queue A, item 3" % (last_batch_handle,))
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        if last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
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


def _host_tensor(arr):
    """A batch array (NDArray, tensor or numpy) as a tensor."""
    if isinstance(arr, NDArray):
        return arr._data
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(_np.ascontiguousarray(arr))


class DeviceFeedIter(DataIter):
    """Bounded device feed (reference: ``io/__init__.py:438-629`` over
    ``iter_prefetcher.h:47``).

    A worker thread pulls host batches from ``base`` and moves them to
    ``device`` (default the card; ``"cpu"`` hands the host tensors over
    as they are): each array goes through a pinned host copy to the card
    with ``non_blocking=True`` on a side stream, where an event is
    recorded.  That event is the one fence: ``next()`` makes the
    consumer's stream wait on it (the host never blocks on a transfer)
    and marks each tensor as used there (``record_stream``), so the
    caching allocator never hands a slot the step still reads to a later
    batch.

    ``depth`` is a hard slot ring: at most ``depth`` prefetched batches
    are on the card at once (queued or mid-transfer: a slot semaphore
    gates the worker before it pulls the next batch), so the feed holds at
    most ``depth x batch_bytes`` of device memory.  Feed and stall
    accounting land in ``self.stats`` (``profiler.PipelineStats``).
    ``transform`` (a device-side tail of the data pipeline) is ROADMAP.md
    queue A, item 3, and raises.
    """

    def __init__(self, base, transform=None, depth=2, data_desc=None,
                 device=None):
        if transform is not None:
            raise NotImplementedError(
                "DeviceFeedIter(transform=...): the device tail of the data "
                "pipeline is ROADMAP.md queue A, item 3 (A3)")
        super().__init__(base.batch_size)
        from ..profiler import PipelineStats
        self.base = base
        self.transform = None
        self._device = resolve_device(device)
        self._data_desc = data_desc
        self._depth = max(1, int(depth))
        self.stats = PipelineStats(num_workers=1, name="io.device_feed")
        self._live = 0
        self._live_max = 0
        self._live_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._exhausted = False
        self._base_lock = threading.Lock()
        self._side = (torch.cuda.Stream(self._device)
                      if self._device.type == "cuda" else None)
        self._make_ring()
        self._start()

    def _make_ring(self):
        # +1: the end-of-epoch sentinel never blocks behind a full ring
        self._queue = _queue.Queue(maxsize=self._depth + 1)
        self._slots = threading.Semaphore(self._depth)

    @property
    def depth(self):
        return self._depth

    @property
    def live_slots_max(self):
        """Most prefetched batches on the device at once so far (never
        more than ``depth``)."""
        with self._live_lock:
            return self._live_max

    @property
    def provide_data(self):
        if self._data_desc is not None:
            return self._data_desc
        return self.base.provide_data

    @property
    def provide_label(self):
        return self.base.provide_label

    def _to_device(self, batch):
        """``(DataBatch of device NDArrays, event or None)``; the
        consumer's stream waits on the event in :meth:`next`."""
        arrays = [_host_tensor(a) for a in batch.data]
        labels = [_host_tensor(a) for a in (batch.label or [])]
        event = None
        if self._device.type == "cuda":
            with torch.cuda.stream(self._side):
                outs = [(t if t.is_pinned() else t.pin_memory()).to(
                    self._device, non_blocking=True)
                    for t in arrays + labels]
                event = torch.cuda.Event()
                event.record(self._side)
        else:
            outs = arrays + labels
        n = len(arrays)
        return DataBatch([NDArray(o) for o in outs[:n]],
                         [NDArray(o) for o in outs[n:]] or None,
                         pad=batch.pad, index=batch.index), event

    def _start(self):
        # the worker captures its own stop event, queue, slot ring and error
        # box, so a worker abandoned by reset() cannot touch the new epoch's
        self._error_box = err = [None]
        stop, q, slots = self._stop, self._queue, self._slots

        def run():
            while not stop.is_set():
                # the slot gates before the batch is pulled: at most
                # `depth` batches are ever on the device
                if not slots.acquire(timeout=0.2):
                    continue
                try:
                    with self._base_lock:
                        if stop.is_set():
                            return
                        host_batch = self.base.next()
                    with self._live_lock:
                        self._live += 1
                        self._live_max = max(self._live_max, self._live)
                    t0 = _time.perf_counter()
                    item = self._to_device(host_batch)
                    self.stats.on_batch(0, _time.perf_counter() - t0,
                                        q.qsize() + 1)
                except StopIteration:
                    q.put(None)
                    return
                except BaseException as e:
                    err[0] = e
                    q.put(None)
                    return
                q.put(item)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def reset(self):
        self._stop.set()
        deadline = _time.monotonic() + 10
        while self._thread is not None and self._thread.is_alive():
            try:
                while True:
                    self._queue.get_nowait()
            except _queue.Empty:
                pass
            self._thread.join(timeout=0.25)
            if _time.monotonic() > deadline:
                break
        with self._base_lock:
            self.base.reset()
        self._stop = threading.Event()
        self._make_ring()
        with self._live_lock:
            self._live = 0
        self._exhausted = False
        self._start()

    def next(self):
        if self._exhausted:
            raise StopIteration
        t0 = _time.perf_counter()
        item = self._queue.get()
        self.stats.on_wait(_time.perf_counter() - t0)
        if item is None:
            self._exhausted = True
            if self._error_box[0] is not None:
                err, self._error_box[0] = self._error_box[0], None
                raise err
            raise StopIteration
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for a in list(batch.data) + list(batch.label or []):
                a._data.record_stream(stream)
        # handed over: its slot frees and the worker may pull the next
        with self._live_lock:
            self._live -= 1
        self._slots.release()
        return batch

    def iter_next(self):
        raise NotImplementedError("use next()")


from .prefetch import PrefetchToDeviceIter  # noqa: E402
