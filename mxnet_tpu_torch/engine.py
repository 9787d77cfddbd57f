"""Run-ahead dispatch engine: the port of ``mxnet_tpu/engine.py``
(reference: python/mxnet/engine.py over ``src/engine/threaded_engine.h``).

PyTorch queues CUDA work on a stream and returns at once, so the host may
run ahead of the card; an unbounded run-ahead pins every queued step's
batch and outputs in device memory.  This module is the bound:

- ``set_bulk_size(n)``: the run-ahead window.  A training loop (the
  ``DataParallelTrainer`` in-flight ring of CUDA events) dispatches up to
  ``n`` steps without synchronizing, then waits on the *oldest* in-flight
  step.  Dispatch order is untouched, so numerics are bitwise identical
  at any window size; only synchronization points move.
- ``bulk(size)``: scopes the window and flushes all in-flight work on
  exit, yielding the previous size.
- ``flush()``: runs the ``engine.flush`` chaos probe, drains every
  registered in-flight ring (trainers, prefetchers), then
  ``torch.cuda.synchronize()`` once CUDA is initialized (the reference's
  ``jax.effects_barrier()``).

Components with in-flight device work register a flush callback through
``register_flusher``; it is held weakly, so a dropped trainer
unregisters itself.
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import torch

__all__ = ["bulk", "set_bulk_size", "bulk_size", "flush",
           "register_flusher"]

_bulk_size = 15
_lock = threading.Lock()
# weak refs to the flush callables of components holding in-flight work
_flushers = []


def set_bulk_size(size):
    """Set the run-ahead window; returns the previous size.  ``1`` keeps
    at most one step in flight (the synchronous loop); larger values let
    the host run ahead of the card by up to ``size`` dispatched but
    unfinished steps."""
    global _bulk_size
    size = int(size)
    if size < 1:
        raise ValueError("bulk size must be >= 1, got %d" % size)
    prev = _bulk_size
    _bulk_size = size
    return prev


def bulk_size():
    """The current run-ahead window."""
    return _bulk_size


def register_flusher(fn):
    """Register a flush callback (held weakly) that ``flush()`` and the
    exit of ``bulk`` run; typically a bound method draining an in-flight
    ring (``DataParallelTrainer.flush``)."""
    ref = weakref.WeakMethod(fn) if hasattr(fn, "__self__") \
        else weakref.ref(fn)
    with _lock:
        _flushers.append(ref)


def flush():
    """Wait for all in-flight engine work: drain every registered ring,
    then synchronize the card (reference: ThreadedEngine::WaitForAll)."""
    from .resilience import chaos as _chaos
    # a scheduled kill or stall lands exactly at the segment boundary
    _chaos.maybe_inject("engine.flush")
    with _lock:
        live = [r() for r in _flushers]
        # drop dead components in passing
        _flushers[:] = [r for r, f in zip(list(_flushers), live)
                        if f is not None]
        live = [f for f in live if f is not None]
    for fn in live:
        fn()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def bulk(size):
    """Bulk execution scope: set the run-ahead window inside the block;
    on exit restore the previous size (which the context manager yields)
    and ``flush()``, also when the body raised."""
    prev = set_bulk_size(size)
    try:
        yield prev
    finally:
        set_bulk_size(prev)
        flush()
