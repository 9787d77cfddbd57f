"""Profiler counters: the part of ``mxnet_tpu/profiler.py`` serving uses.

``serving/stats.py`` keeps its queue depth and recompile count in
:class:`Counter` objects grouped by a :class:`Domain`, as the reference
profiler does.  The chrome-trace recorder and the device timeline of the
JAX package are not ported yet (ROADMAP.md queue A, item A12), so a
counter here is a thread-safe number and nothing more.
"""
from __future__ import annotations

import threading

__all__ = ["Domain", "Counter"]


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
