"""DataLoader: minibatch loader with multiprocessing workers.

The port of ``mxnet_tpu/gluon/data/dataloader.py`` (reference:
``python/mxnet/gluon/data/dataloader.py`` — worker processes decode and
transform samples and ship batches back through shared-memory NDArrays).

Workers produce *numpy* batches (pickled through the pool's pipe; JPEG
decode and augmentation, not host RAM, are the cost), and after each
batch check that CUDA is uninitialised in them: a worker never holds a
CUDA context.  The main process makes each batch an NDArray on the current
context, the card unless ``context.use("cpu")`` (``pin_memory=True``: from
a pinned copy, without blocking the host).  Workers start from a
forkserver (``fork()`` from a parent with a CUDA context and threads is
unsafe) that preloads the port (``io.pipeline._mp_context``).
``num_workers=0`` is a synchronous in-process loop; ``thread_pool=True``
runs the workers as threads of this process.
"""
from __future__ import annotations

import multiprocessing as mp
import os

import numpy as np
import torch

from ... import ndarray as nd
from ...context import current_context
from ...ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch on the current context (reference:
    dataloader.py default_batchify_fn)."""
    if isinstance(data[0], NDArray):
        return nd.stack(*data, axis=0).as_in_context(current_context())
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    arr = np.asarray(data)
    return nd.array(arr, dtype=arr.dtype)


def _np_batchify(data):
    """Worker-side batchify to numpy (crosses the process boundary)."""
    if isinstance(data[0], NDArray):
        return np.stack([d.asnumpy() for d in data])
    if isinstance(data[0], tuple):
        return [_np_batchify(list(i)) for i in zip(*data)]
    return np.asarray(data)


default_mp_batchify_fn = _np_batchify

_worker_dataset = None


def _worker_init(dataset):
    global _worker_dataset
    _worker_dataset = dataset


def _worker_fn(samples):
    out = _np_batchify([_worker_dataset[i] for i in samples])
    _check_no_cuda()
    return out


def _check_no_cuda():
    from ...io.pipeline import _check_no_cuda as check
    check("DataLoader worker %d" % os.getpid())


def _to_nd(batch, pin=False):
    """A numpy batch (or a list of them) as NDArrays on the current
    context; ``pin``: through a pinned host copy, without blocking."""
    if isinstance(batch, list):
        return [_to_nd(b, pin) for b in batch]
    dev = current_context()
    if pin and dev.type == "cuda":
        t = torch.from_numpy(np.ascontiguousarray(batch)).pin_memory()
        return NDArray(t.to(dev, non_blocking=True))
    return nd.array(batch, ctx=dev, dtype=batch.dtype)


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False):
        self._dataset = dataset
        self._pin_memory = pin_memory
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when no batch_sampler")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_sampler is mutually exclusive with "
                             "batch_size/shuffle/sampler/last_batch")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._batchify_fn = batchify_fn
        self._prefetch = max(0, prefetch or 2 * self._num_workers)
        self._thread_pool = thread_pool
        self._pool = None
        if self._num_workers > 0:
            if thread_pool:
                from multiprocessing.pool import ThreadPool
                self._pool = ThreadPool(self._num_workers)
            else:
                # forkserver (module docstring); the dataset ships to the
                # workers once, by pickle
                from ...io.pipeline import _mp_context
                self._pool = _mp_context().Pool(
                    self._num_workers, initializer=_worker_init,
                    initargs=(dataset,))

    def __iter__(self):
        if self._pool is None:
            batchify = self._batchify_fn or default_batchify_fn
            for batch in self._batch_sampler:
                yield batchify([self._dataset[i] for i in batch])
            return
        # pipelined: keep `prefetch` batches in flight (the ThreadedIter /
        # shared-mem pipeline analogue)
        async_results = []
        it = iter(self._batch_sampler)

        def submit():
            try:
                batch = next(it)
            except StopIteration:
                return False
            if self._thread_pool:
                # threads share this process: pass the dataset explicitly
                # (a module global would be clobbered by a second loader)
                async_results.append(self._pool.apply_async(
                    _thread_worker_fn,
                    (self._dataset, batch, self._batchify_fn)))
            elif self._batchify_fn is not None:
                async_results.append(self._pool.apply_async(
                    _custom_worker_fn, (batch, self._batchify_fn)))
            else:
                async_results.append(self._pool.apply_async(_worker_fn,
                                                            (batch,)))
            return True

        for _ in range(self._prefetch or 1):
            if not submit():
                break
        # bounded waits: a process-pool worker lost to the OOM killer can
        # orphan its AsyncResult, and a bare .get() would then hang this
        # loop forever.  Poll with a timeout and give up loudly at a total
        # deadline instead.
        deadline_s = float(os.environ.get("MXTPU_DATALOADER_TIMEOUT", "600"))
        while async_results:
            res = async_results.pop(0)
            waited = 0.0
            while True:
                try:
                    out = res.get(timeout=5.0)
                    break
                except mp.TimeoutError:
                    waited += 5.0
                    if waited >= deadline_s:
                        raise RuntimeError(
                            "DataLoader batch not produced within %.0fs — "
                            "a pool worker likely died (OOM-killed?); "
                            "raise MXTPU_DATALOADER_TIMEOUT if the "
                            "dataset is genuinely that slow" % deadline_s)
            submit()
            yield _to_nd(out, self._pin_memory) \
                if self._batchify_fn is None else out

    def __len__(self):
        return len(self._batch_sampler)

    def shutdown(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


def _custom_worker_fn(samples, batchify_fn):
    out = batchify_fn([_worker_dataset[i] for i in samples])
    _check_no_cuda()
    return out


def _thread_worker_fn(dataset, samples, batchify_fn):
    fn = batchify_fn or _np_batchify
    return fn([dataset[i] for i in samples])
