"""Profiler counters: the part of ``mxnet_tpu/profiler.py`` serving,
the trainer's run-ahead ring and the data pipeline use.

``serving/stats.py`` keeps its queue depth and recompile count in
:class:`Counter` objects grouped by a :class:`Domain`, as the reference
profiler does.  :class:`PipelineStats` (``profiler.py:318-444``) is the
accumulator of a data pipeline's feed and of a trainer's run-ahead
dispatch (``DataParallelTrainer.dispatch_stats``).  The chrome-trace
recorder and the device timeline of the JAX package are not ported yet
(ROADMAP.md queue A, item A12), so a counter here is a thread-safe number
and nothing more.
"""
from __future__ import annotations

import threading
import time

__all__ = ["Domain", "Counter", "PipelineStats"]


class Domain:
    """Grouping namespace for counters (reference: profiler.Domain)."""

    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return "Domain(%s)" % self.name

    def new_counter(self, name, value=None):
        return Counter(self, name, value)


class Counter:
    """Numeric counter (reference: profiler.Counter).

    Thread-safe: ``increment``/``decrement`` are atomic read-modify-write
    under a per-counter lock — concurrent emitters (serving handler
    threads, the batcher worker) never lose updates."""

    def __init__(self, domain, name, value=None):
        self.name = "%s::%s" % (domain.name, name)
        self._value = 0
        self._vlock = threading.Lock()
        if value is not None:
            self.set_value(value)

    def set_value(self, value):
        with self._vlock:
            self._value = value

    def increment(self, delta=1):
        with self._vlock:
            self._value += delta

    def decrement(self, delta=1):
        self.increment(-delta)


class PipelineStats:
    """Per-stage counters of a data pipeline and of a run-ahead dispatcher
    (reference: ``profiler.PipelineStats``).

    The feed half: batches delivered, the reorder-queue depth, per-worker
    busy time, the consumer's stall time and worker respawns
    (``ImagePipelineIter.stats``, ``DeviceFeedIter.stats``).  The dispatch
    half: ``on_dispatch`` (a step dispatched with ``inflight`` steps now
    unsynchronized) and ``on_backpressure`` (the dispatcher blocked on its
    oldest in-flight step).  One thread-safe accumulator, one
    :meth:`snapshot` with the reference's keys; it is also a collector of
    the telemetry registry (``mxtpu_pipeline_*`` gauges labeled by name,
    held weakly)."""

    def __init__(self, num_workers=0, name="io.pipeline"):
        self._lock = threading.Lock()
        self._name = name
        self._t0 = time.perf_counter()
        self._busy_s = {}
        self._stall_s = 0.0
        self._batches = 0
        self._depth_max = 0
        self._respawns = 0
        self._respawns_epoch = 0     # reset by on_epoch (the storm budget)
        self._num_workers = num_workers
        domain = Domain(name)
        self._counter = domain.new_counter("queue_depth")
        self._dispatched = 0
        self._inflight_max = 0
        self._dispatch_stall_s = 0.0
        self._inflight_counter = domain.new_counter("inflight_steps")
        from . import telemetry as _tele
        _tele.registry().register_collector(self._metrics_samples,
                                            name="pipeline:" + name)

    def _metrics_samples(self):
        from . import telemetry as _tele
        return _tele.flatten_samples("mxtpu_pipeline", self.snapshot(),
                                     labels={"name": self._name})

    def on_batch(self, worker, busy_s, queue_depth):
        with self._lock:
            self._busy_s[worker] = self._busy_s.get(worker, 0.0) + busy_s
            self._batches += 1
            self._depth_max = max(self._depth_max, queue_depth)
        self._counter.set_value(queue_depth)

    def on_wait(self, stall_s):
        with self._lock:
            self._stall_s += stall_s

    def on_respawn(self):
        with self._lock:
            self._respawns += 1
            self._respawns_epoch += 1

    def on_epoch(self):
        """Epoch boundary: reset the per-epoch respawn counter (the unit
        of ``ImagePipelineIter``'s ``max_respawns`` storm budget)."""
        with self._lock:
            self._respawns_epoch = 0

    def on_dispatch(self, inflight):
        """A step was dispatched with ``inflight`` steps now
        unsynchronized (the run-ahead ring's depth at dispatch time)."""
        with self._lock:
            self._dispatched += 1
            self._inflight_max = max(self._inflight_max, inflight)
        self._inflight_counter.set_value(inflight)

    def on_backpressure(self, stall_s):
        """The dispatcher blocked ``stall_s`` seconds waiting on its
        oldest in-flight step (ring full: the card sets the pace)."""
        with self._lock:
            self._dispatch_stall_s += stall_s

    def snapshot(self):
        """Aggregate view: ``worker_utilization`` is busy time over
        (workers x wall); ``stall_pct`` the share of wall time the
        consumer waited for a batch; ``respawns`` (``respawns_epoch``)
        the workers respawned in all (this epoch); ``dispatched_steps``,
        ``inflight_max`` and ``dispatch_stall_s`` the run-ahead ring's."""
        with self._lock:
            wall = max(1e-9, time.perf_counter() - self._t0)
            busy = sum(self._busy_s.values())
            util = busy / (wall * self._num_workers) \
                if self._num_workers else 0.0
            return {
                "batches": self._batches,
                "wall_s": round(wall, 3),
                "worker_busy_s": round(busy, 3),
                "worker_utilization": round(util, 4),
                "stall_s": round(self._stall_s, 3),
                "stall_pct": round(100.0 * self._stall_s / wall, 2),
                "queue_depth_max": self._depth_max,
                "respawns": self._respawns,
                "respawns_epoch": self._respawns_epoch,
                "dispatched_steps": self._dispatched,
                "inflight_max": self._inflight_max,
                "dispatch_stall_s": round(self._dispatch_stall_s, 3),
            }
