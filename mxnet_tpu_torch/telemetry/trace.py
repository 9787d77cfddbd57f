"""Fleet-wide trace correlation: trace contexts, spans, the wire format
and clock-offset estimation.

The port of ``mxnet_tpu/telemetry/trace.py`` (stdlib only), the part the
parameter server needs: PS RPCs may carry a trace context on the wire as
``("tctx", to_wire(ctx), message)``, and the server installs it
(``set_current``) while it handles the message, so the two packages'
clients and servers talk to each other whether or not the caller traces.

- a :class:`SpanContext` is ``(trace_id, span_id, parent_id, rank,
  incarnation)``; the current context rides a thread-local so nested
  spans chain parent -> child;
- ``to_wire`` / ``from_wire`` is a plain versioned tuple, pickle-friendly
  and tolerant of longer (newer) tuples;
- :func:`estimate_clock_offset` turns a few request round trips into a
  ``server_clock - local_clock`` offset (midpoint method, best of N by
  round-trip time).

A :class:`span` propagates its context; emitting it as a chrome-trace
event is the profiler's trace half, ROADMAP.md queue A, item A12 (with
the flight recorder and the straggler detector).  Timestamps are
``time.perf_counter_ns()``.
"""
from __future__ import annotations

import os
import threading
import time

__all__ = ["SpanContext", "new_trace_id", "current", "set_current",
           "span", "to_wire", "from_wire", "estimate_clock_offset"]

_tls = threading.local()


def new_trace_id():
    """128-bit hex trace id (collision-safe across a fleet; uniqueness,
    not reproducibility, is the contract)."""
    return os.urandom(16).hex()


def _new_span_id():
    return os.urandom(8).hex()


class SpanContext:
    """One span's identity plus the process coordinates that make a
    fleet trace navigable (rank, client incarnation)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "rank", "incarnation")

    def __init__(self, trace_id=None, span_id=None, parent_id=None,
                 rank=None, incarnation=None):
        self.trace_id = trace_id or new_trace_id()
        self.span_id = span_id or _new_span_id()
        self.parent_id = parent_id
        self.rank = rank
        self.incarnation = incarnation

    def child(self):
        """A new span under this trace, parented here."""
        return SpanContext(trace_id=self.trace_id, parent_id=self.span_id,
                           rank=self.rank, incarnation=self.incarnation)

    def args(self):
        """The chrome-trace ``args`` payload linking events to spans."""
        out = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id is not None:
            out["parent_id"] = self.parent_id
        if self.rank is not None:
            out["rank"] = self.rank
        if self.incarnation is not None:
            out["incarnation"] = self.incarnation
        return out

    def __repr__(self):
        return "SpanContext(%s/%s<-%s rank=%s)" % (
            self.trace_id[:8], self.span_id, self.parent_id, self.rank)


def current():
    """The thread's active SpanContext, or None."""
    return getattr(_tls, "ctx", None)


def set_current(ctx):
    """Install ``ctx`` as the thread's active context; returns the
    previous one (caller restores it — the server serve-loop pattern)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


class span:
    """Scoped span: child of the current context (or a fresh trace root),
    installed as current for the duration of the ``with`` block, and its
    duration kept in ``elapsed_ns``."""

    def __init__(self, name, category="telemetry", rank=None,
                 incarnation=None, **extra_args):
        self.name = name
        self.category = category
        self.extra = extra_args
        parent = current()
        self.ctx = parent.child() if parent is not None else SpanContext(
            rank=rank, incarnation=incarnation)
        if rank is not None:
            self.ctx.rank = rank
        if incarnation is not None:
            self.ctx.incarnation = incarnation
        self._prev = None
        self._t0 = None
        self.elapsed_ns = None

    def __enter__(self):
        self._prev = set_current(self.ctx)
        self._t0 = time.perf_counter_ns()
        return self.ctx

    def __exit__(self, *exc):
        set_current(self._prev)
        self.elapsed_ns = time.perf_counter_ns() - self._t0


# -- wire format -------------------------------------------------------------
_WIRE_VERSION = 1


def to_wire(ctx):
    """SpanContext -> tuple for an RPC payload.  Leading version lets a
    newer peer extend the tuple without breaking an older one."""
    return (_WIRE_VERSION, ctx.trace_id, ctx.span_id, ctx.parent_id,
            ctx.rank, ctx.incarnation)


def from_wire(wire):
    """Tuple -> SpanContext; tolerant of longer (newer) tuples."""
    if not wire or wire[0] != _WIRE_VERSION:
        raise ValueError("unknown trace-context wire version %r"
                         % (wire[:1],))
    _, trace_id, span_id, parent_id, rank, incarnation = wire[:6]
    return SpanContext(trace_id=trace_id, span_id=span_id,
                       parent_id=parent_id, rank=rank,
                       incarnation=incarnation)


# -- clock alignment ---------------------------------------------------------
def estimate_clock_offset(probe_fn, n=5):
    """Estimate ``remote_perf_ns - local_perf_ns``.

    ``probe_fn()`` must return the remote process's
    ``time.perf_counter_ns()`` (one RPC round trip).  For each probe the
    midpoint method assumes symmetric network delay: the remote stamp was
    taken near ``(t0 + t1) / 2`` locally.  The sample with the smallest
    RTT bounds the error tightest (classic NTP selection), so that
    sample's offset wins.  Returns ``(offset_ns, rtt_ns)``."""
    best = None
    for _ in range(max(1, int(n))):
        t0 = time.perf_counter_ns()
        remote = int(probe_fn())
        t1 = time.perf_counter_ns()
        rtt = t1 - t0
        offset = remote - (t0 + t1) // 2
        if best is None or rtt < best[1]:
            best = (offset, rtt)
    return best
