"""Data iterators: the `mx.io` namespace, the port of
``mxnet_tpu/io/__init__.py`` (reference: ``python/mxnet/io.py``: DataIter
``:182``, DataBatch ``:118``, NDArrayIter ``:546``, and the C++ iterators
registered in ``src/io/*.cc``).

Iterators are Python on the host and yield CPU NDArrays:
:class:`NDArrayIter`, :class:`CSVIter`, :class:`LibSVMIter`,
:class:`MNISTIter`, the image iterators (``image.ImageIter``,
:class:`~.pipeline.ImagePipelineIter`, the multi-process shared-memory
decode pipeline) and the wrappers :class:`ResizeIter` and
:class:`PrefetchingIter` (a producer thread).  :class:`DeviceFeedIter`
moves each batch to the card ahead of the consumer, through pinned memory
on a side stream, optionally through a device-side ``transform``
(``io/device_tail.py``: normalize, cast and layout on the card, so the
host ships raw uint8 NHWC); :class:`~.prefetch.PrefetchToDeviceIter` is
its training form.  :func:`ImageRecordIter` assembles the record route
the way the C++ iterator's kwargs ask; :func:`ImageDetRecordIter` the
detection route over ``image.detection.ImageDetIter``.
"""
from __future__ import annotations

import collections
import queue as _queue
import threading
import time as _time

import numpy as _np
import torch

from ..base import resolve_device
from ..context import current_context
from ..ndarray import NDArray, array as _nd_array, sparse

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "DeviceFeedIter", "PrefetchToDeviceIter",
           "CSVIter", "MNISTIter",
           "ImageRecordIter", "ImagePipelineIter", "PipelineWorkerStorm",
           "make_device_tail", "LibSVMIter", "ImageDetRecordIter"]


def ImageRecordIter(**kwargs):
    """Name-parity wrapper over the image pipeline (the C++ registered
    iterator `ImageRecordIter`, src/io/iter_image_recordio_2.cc).

    The C iterator kwargs map onto the port's pipeline:

    - ``preprocess_threads`` — number of decode/augment *worker processes*
      (io/pipeline.py; the reference's OMP decode team).  0 keeps decoding
      in-process behind a prefetch thread.
    - ``prefetch_buffer`` — pipeline ring depth (shared-memory slots per
      worker), or the prefetch-thread queue depth when in-process.
    - ``mean_r/g/b``, ``std_r/g/b`` — normalization constants.
    - ``device_tail=True`` — ship raw uint8 NHWC batches and run the
      mean/std normalize + dtype cast + layout transform on the device
      (io/device_tail.py); the returned iterator is then a
      :class:`DeviceFeedIter` onto the current context (the card unless
      ``context.use("cpu")``) that yields already-normalized batches.
    - ``seed`` — deterministic per-batch augmentation (bitwise-identical
      output for any worker count).
    """
    from .device_tail import make_device_tail as _make_tail
    from .pipeline import ImagePipelineIter, pipeline_available
    mean = None
    if any(k in kwargs for k in ("mean_r", "mean_g", "mean_b")):
        mean = _np.array([kwargs.pop("mean_r", 0.0),
                           kwargs.pop("mean_g", 0.0),
                           kwargs.pop("mean_b", 0.0)], dtype=_np.float32)
    std = None
    if any(k in kwargs for k in ("std_r", "std_g", "std_b")):
        std = _np.array([kwargs.pop("std_r", 1.0),
                          kwargs.pop("std_g", 1.0),
                          kwargs.pop("std_b", 1.0)], dtype=_np.float32)
    mean = kwargs.pop("mean", mean)
    std = kwargs.pop("std", std)
    prefetch = max(1, int(kwargs.pop("prefetch_buffer", 2)))
    workers = int(kwargs.pop("preprocess_threads", 0))
    device_tail = bool(kwargs.pop("device_tail", False))
    seed = kwargs.pop("seed", None)
    # C++ round_batch: True wraps/pads the tail batch, False emits it partial
    if kwargs.pop("round_batch", True):
        kwargs.setdefault("last_batch_handle", "pad")
    else:
        kwargs.setdefault("last_batch_handle", "keep")

    out_dtype = kwargs.get("dtype", "float32")
    out_layout = kwargs.get("layout", "NCHW")
    if device_tail:
        # the host ships what the decoder produces — uint8 NHWC — and the
        # normalize/cast/layout tail runs on the device
        kwargs["dtype"] = "uint8"
        kwargs["layout"] = "NHWC"
        host_mean = host_std = None
    else:
        host_mean, host_std = mean, std

    if workers > 0 and not pipeline_available():
        _warn_once(
            "ImageRecordIter: multiprocessing shared memory is "
            "unavailable on this platform; preprocess_threads=%d "
            "falls back to in-process decoding" % workers)
        workers = 0
    if workers > 0 or seed is not None:
        # seeded runs go through the pipeline even in-process: its
        # per-batch RNG discipline is what makes the output reproducible
        # (and identical under any worker count)
        inner = ImagePipelineIter(num_workers=workers,
                                  prefetch_buffer=prefetch, seed=seed,
                                  mean=host_mean, std=host_std, **kwargs)
    else:
        from ..image import ImageIter
        inner = PrefetchingIter(
            ImageIter(mean=host_mean, std=host_std, **kwargs),
            depth=prefetch)
    if not device_tail:
        return inner
    tail = _make_tail(mean, std, dtype=out_dtype, layout=out_layout,
                      input_layout="NHWC")
    d = inner.provide_data[0]
    bsz, h, w, c = d.shape
    shape = (bsz, c, h, w) if out_layout == "NCHW" else (bsz, h, w, c)
    desc = [DataDesc(d.name, shape, _np.dtype(out_dtype)
                     if out_dtype != "bfloat16" else out_dtype,
                     layout=out_layout)]
    return DeviceFeedIter(inner, transform=tail, data_desc=desc)


_WARNED = set()


def _warn_once(msg):
    if msg not in _WARNED:
        _WARNED.add(msg)
        import warnings
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape"])):
    """Name/shape/dtype/layout of one input (reference: io.py:DataDesc)."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


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
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

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
    """Iterate over in-memory arrays (reference: io.py:546), yielding CPU
    NDArrays.  Supports shuffle (one permutation at construction, from
    ``shuffle_seed``), pad/discard/roll_over last-batch handling."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 shuffle_seed=None,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        if shuffle:
            rng = _np.random.RandomState(shuffle_seed)
            idx = rng.permutation(self.num_data)
            self.data = [(k, v[idx]) for k, v in self.data]
            self.label = [(k, v[idx]) for k, v in self.label]
        self.last_batch_handle = last_batch_handle
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
        if self.last_batch_handle == "roll_over" and \
                self.cursor >= self.num_batches:
            self.cursor = -1 - (self.num_batches * self.batch_size
                                - self.num_data)
        else:
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
                # pad by wrapping (reference pads from the beginning)
                pad = self.batch_size - chunk.shape[0]
                chunk = _np.concatenate([chunk, v[:pad]], axis=0)
            out.append(_nd_array(chunk, ctx="cpu", dtype=chunk.dtype))
        return out

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        end = (self.cursor + 1) * self.batch_size
        if self.last_batch_handle == "pad" and end > self.num_data:
            return end - self.num_data
        return 0

    def getindex(self):
        start = self.cursor * self.batch_size
        return _np.arange(start, start + self.batch_size) % self.num_data


class ResizeIter(DataIter):
    """Resize an iterator to a fixed number of batches per epoch
    (reference: io.py ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Producer-thread prefetch over one or more iterators (reference:
    io.py PrefetchingIter / src/io/iter_prefetcher.h:47)."""

    def __init__(self, iters, rename_data=None, rename_label=None, depth=2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._queue = _queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = None
        self._exhausted = False
        self._start()

    def _start(self):
        self._error = None

        def run():
            while not self._stop.is_set():
                try:
                    batches = [it.next() for it in self.iters]
                except StopIteration:
                    self._queue.put(None)
                    return
                except BaseException as e:  # surface at next(), don't hang
                    self._error = e
                    self._queue.put(None)
                    return
                self._queue.put(batches)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r.get(d.name, d.name), d.shape, d.dtype)
                     for d in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r.get(d.name, d.name), d.shape, d.dtype)
                     for d in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except _queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        for it in self.iters:
            it.reset()
        self._stop = threading.Event()
        self._queue = _queue.Queue(maxsize=self._queue.maxsize)
        self._exhausted = False
        self._start()

    def next(self):
        if self._exhausted:
            raise StopIteration
        batches = self._queue.get()
        if batches is None:
            self._exhausted = True
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            raise StopIteration
        b = batches[0]
        if len(batches) > 1:
            data = sum([list(x.data) for x in batches], [])
            label = sum([list(x.label or []) for x in batches], [])
            return DataBatch(data, label or None, pad=b.pad, index=b.index)
        return b

    def iter_next(self):
        raise NotImplementedError("use next()")


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
    ``device`` (default the current context: the card unless
    ``context.use("cpu")``; on the CPU the host tensors are handed over
    as they are): each array goes through a pinned host copy to the card
    with ``non_blocking=True`` on a side stream.  ``transform`` (a
    device-side tail, ``io/device_tail.py``) then runs on the data arrays
    on that same stream; the labels ride along untouched.  An event
    recorded after both is the one fence: ``next()`` makes the consumer's
    stream wait on it (the host never blocks on a transfer) and marks each
    tensor as used there (``record_stream``), so the caching allocator
    never hands a slot the step still reads to a later batch.

    ``depth`` is a hard slot ring: at most ``depth`` prefetched batches
    are on the card at once (queued or mid-transfer: a slot semaphore
    gates the worker before it pulls the next batch), so the feed holds at
    most ``depth x batch_bytes`` of device memory.  Feed and stall
    accounting land in ``self.stats`` (``profiler.PipelineStats``): its
    ``worker_busy_s`` over ``batches`` is the feed thread's seconds per
    batch (pinning, copy and transform).
    """

    def __init__(self, base, transform=None, depth=2, data_desc=None,
                 device=None):
        super().__init__(base.batch_size)
        from ..profiler import PipelineStats
        self.base = base
        self.transform = transform
        self._device = current_context() if device is None \
            else resolve_device(device)
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
                outs = [self._put(t) for t in arrays + labels]
                if self.transform is not None:
                    outs[:len(arrays)] = [self.transform(t)
                                          for t in outs[:len(arrays)]]
                event = torch.cuda.Event()
                event.record(self._side)
        else:
            outs = arrays + labels
            if self.transform is not None:
                outs[:len(arrays)] = [self.transform(t) for t in arrays]
        n = len(arrays)
        return DataBatch([NDArray(o) for o in outs[:n]],
                         [NDArray(o) for o in outs[n:]] or None,
                         pad=batch.pad, index=batch.index), event

    def _put(self, t):
        """``t`` on the card: a host tensor through pinned memory, copied
        on the current (side) stream without blocking the host."""
        if t.device == self._device:
            return t
        if t.device.type == "cpu" and not t.is_pinned():
            t = t.pin_memory()
        return t.to(self._device, non_blocking=True)

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


class CSVIter(DataIter):
    """CSV file iterator (reference: src/io/iter_csv.cc)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = _np.loadtxt(data_csv, delimiter=",", ndmin=2, dtype=_np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", ndmin=2,
                                dtype=_np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[-1] == 1:
                label = label.reshape(label.shape[:-1])
        else:
            label = _np.zeros((data.shape[0],), dtype=_np.float32)
        self._inner = NDArrayIter(
            data, label, batch_size,
            last_batch_handle="roll_over" if round_batch else "pad")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class LibSVMIter(DataIter):
    """LibSVM text-format iterator yielding CSR batches
    (reference: src/io/iter_libsvm.cc — "label idx:val idx:val ..." lines,
    zero-based indices; labels from a separate file when ``label_libsvm``
    is given, else the leading value per line).

    data comes out as CSRNDArray (batch_size, *data_shape) — the sparse
    storage the row-sparse linear models train on."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=(1,), batch_size=1, num_parts=1, part_index=0,
                 round_batch=True, data_name="data",
                 label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        self._data_shape = tuple(data_shape)
        self._feat_dim = 1
        for d in self._data_shape:
            self._feat_dim *= d
        rows, inline_labels = self._parse(data_libsvm, with_label=True)
        if label_libsvm is not None:
            lab_rows, _ = self._parse(label_libsvm, with_label=False)
            labels = _np.asarray([r[1][0] if len(r[1]) else 0.0
                                  for r in lab_rows], _np.float32)
        else:
            labels = _np.asarray(inline_labels, _np.float32)
        # worker sharding, as the reference's num_parts/part_index
        if num_parts > 1:
            n_per = len(rows) // num_parts
            rows = rows[part_index * n_per:(part_index + 1) * n_per]
            labels = labels[part_index * n_per:(part_index + 1) * n_per]
        self._rows = rows
        self._labels = labels
        self._round_batch = round_batch
        self._cursor = 0
        self.data_name = data_name
        self.label_name = label_name
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self._data_shape)]
        self.provide_label = [DataDesc(label_name, (batch_size,))]

    @staticmethod
    def _parse(path, with_label):
        rows, labels = [], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                start = 0
                if with_label:
                    labels.append(float(parts[0]))
                    start = 1
                idx, val = [], []
                for tok in parts[start:]:
                    i, v = tok.split(":")
                    idx.append(int(i))
                    val.append(float(v))
                rows.append((_np.asarray(idx, _np.int64),
                             _np.asarray(val, _np.float32)))
        return rows, labels

    def reset(self):
        self._cursor = 0

    def next(self):
        if self._cursor >= len(self._rows):
            raise StopIteration
        take = self._rows[self._cursor:self._cursor + self.batch_size]
        labs = self._labels[self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        pad = self.batch_size - len(take)
        if pad and self._round_batch:
            take = list(take) + [self._rows[-1]] * pad
            labs = _np.concatenate([labs,
                                    _np.repeat(labs[-1:], pad)])
        else:
            pad = 0
        indptr = _np.zeros(len(take) + 1, _np.int64)
        cols, vals = [], []
        for i, (idx, val) in enumerate(take):
            cols.append(idx)
            vals.append(val)
            indptr[i + 1] = indptr[i] + len(idx)
        cols = _np.concatenate(cols) if cols else _np.zeros(0, _np.int64)
        vals = _np.concatenate(vals) if vals else _np.zeros(0, _np.float32)
        data = sparse.CSRNDArray(
            _nd_array(vals, ctx="cpu"), _nd_array(cols, ctx="cpu",
                                                  dtype="int64"),
            _nd_array(indptr, ctx="cpu", dtype="int64"),
            (len(take), self._feat_dim))
        return DataBatch([data], [_nd_array(labs, ctx="cpu")], pad=pad)


def ImageDetRecordIter(**kwargs):
    """Detection record iterator (reference: src/io/
    iter_image_det_recordio.cc; ``mxnet_tpu/io/__init__.py:759-791``):
    ``image.detection.ImageDetIter`` with the C iterator's kwargs mapped
    (``mean_r/g/b``, ``std_r/g/b``, ``round_batch``), behind a
    :class:`PrefetchingIter` of ``prefetch_buffer`` batches.  Decoding
    runs in-process, as in the reference."""
    from ..image.detection import ImageDetIter
    mean = None
    if any(k in kwargs for k in ("mean_r", "mean_g", "mean_b")):
        mean = _np.array([kwargs.pop("mean_r", 0.0),
                          kwargs.pop("mean_g", 0.0),
                          kwargs.pop("mean_b", 0.0)], dtype=_np.float32)
    std = None
    if any(k in kwargs for k in ("std_r", "std_g", "std_b")):
        std = _np.array([kwargs.pop("std_r", 1.0),
                         kwargs.pop("std_g", 1.0),
                         kwargs.pop("std_b", 1.0)], dtype=_np.float32)
    threads = kwargs.pop("preprocess_threads", None)
    if threads:
        # the detection pipeline decodes in-process (boxes ride the labels
        # through augmenters the worker pool does not ship); say so once
        # instead of silently eating the knob
        _warn_once(
            "ImageDetRecordIter: preprocess_threads=%s is not yet wired "
            "to the multi-process pipeline for detection records; "
            "decoding runs in-process (prefetch_buffer is honored)"
            % threads)
    prefetch = max(1, int(kwargs.pop("prefetch_buffer", 2)))
    if kwargs.pop("round_batch", True):
        kwargs.setdefault("last_batch_handle", "pad")
    else:
        kwargs.setdefault("last_batch_handle", "keep")
    return PrefetchingIter(ImageDetIter(mean=mean, std=std, **kwargs),
                           depth=prefetch)


class MNISTIter(DataIter):
    """MNIST idx-format iterator (reference: src/io/iter_mnist.cc)."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 seed=0, silent=False, input_shape=None, **kwargs):
        super().__init__(batch_size)
        import gzip
        import struct

        def _open(path):
            return gzip.open(path, "rb") if str(path).endswith(".gz") else \
                open(path, "rb")

        with _open(image) as f:
            magic, n, h, w = struct.unpack(">IIII", f.read(16))
            imgs = _np.frombuffer(f.read(), dtype=_np.uint8).reshape(n, h, w)
        with _open(label) as f:
            magic, n2 = struct.unpack(">II", f.read(8))
            labs = _np.frombuffer(f.read(),
                                  dtype=_np.uint8).astype(_np.float32)
        imgs = imgs.astype(_np.float32) / 255.0
        if flat or (input_shape and len(input_shape) == 1):
            imgs = imgs.reshape(n, h * w)
        else:
            imgs = imgs.reshape(n, 1, h, w)
        self._inner = NDArrayIter(imgs, labs, batch_size, shuffle=shuffle,
                                  shuffle_seed=seed,
                                  last_batch_handle="discard")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


# imported at the tail: these modules consume the DataIter/DataBatch/DataDesc
# definitions above (mxnet_tpu_torch.io is already in sys.modules by then)
from .device_tail import make_device_tail  # noqa: E402
from .pipeline import (ImagePipelineIter,  # noqa: E402,F401
                       PipelineWorkerStorm, pipeline_available)
from .prefetch import PrefetchToDeviceIter  # noqa: E402
