"""Worker heartbeats + server-side watchdog for the elastic kvstore tier.

The port of ``mxnet_tpu/resilience/heartbeat.py`` (stdlib only).

Reference: ps-lite's van-level heartbeats behind
``kvstore.h:339 get_num_dead_node`` — workers ping the scheduler, a
silence window marks them dead.  Here the pieces are factored so both
the PS server (``kvstore_ps.PSServer``) and tests can use them directly:

- :class:`HeartbeatMonitor` — server side.  ``beat(rank, step)`` records
  liveness and training progress; a watchdog thread (``start()``)
  declares ranks dead after ``timeout_s`` of silence and runs the
  ``on_dead`` callback (the PS uses it to close the rank's socket and
  reassign its keys).  ``max_step()`` is the staleness reference point
  for the bounded-staleness rejoin gate.
- :class:`HeartbeatSender` — worker side.  A daemon thread calling
  ``beat_fn`` every ``interval_s``; send errors are swallowed (a beat is
  best-effort — the *absence* of beats is the signal).

Both loops poll with bounded waits (``Event.wait(timeout)``) — the exact
discipline the reference's SRC005 lint enforces on its worker loops.
"""
from __future__ import annotations

import logging
import threading
import time

__all__ = ["HeartbeatMonitor", "HeartbeatSender"]


class HeartbeatMonitor:
    """Track per-rank last-beat times; declare silence as death."""

    def __init__(self, timeout_s=10.0, poll_s=None, on_dead=None):
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s) if poll_s else max(0.05,
                                                       self.timeout_s / 4.0)
        self._on_dead = on_dead
        self._lock = threading.Lock()
        self._last = {}      # rank -> monotonic last-beat time
        self._steps = {}     # rank -> last reported step
        self._dead = set()
        self._stop = threading.Event()
        self._thread = None

    # -- recording ---------------------------------------------------------
    def beat(self, rank, step=None):
        """Record a heartbeat; a beat from a dead rank is a rejoin."""
        with self._lock:
            self._last[rank] = time.monotonic()
            self._dead.discard(rank)
            if step is not None:
                self._steps[rank] = max(int(step),
                                        self._steps.get(rank, 0))

    def note_step(self, rank, step):
        """Progress without a liveness claim (e.g. learned from a push)."""
        with self._lock:
            if step is not None:
                self._steps[rank] = max(int(step),
                                        self._steps.get(rank, 0))

    # -- queries -----------------------------------------------------------
    def max_step(self):
        with self._lock:
            return max(self._steps.values()) if self._steps else 0

    def step_of(self, rank):
        with self._lock:
            return self._steps.get(rank, 0)

    def steps(self):
        """Copy of the per-rank step clocks (the PS snapshots this so a
        recovered server's staleness gate keeps its reference points)."""
        with self._lock:
            return dict(self._steps)

    def lag_s(self, now=None):
        """Seconds since each rank's last beat — the telemetry gauge
        (``mxtpu_ps_heartbeat_lag_seconds``) behind the watchdog's
        verdicts: lag approaching ``timeout_s`` is the early warning."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return {rank: now - last for rank, last in self._last.items()}

    def dead(self):
        with self._lock:
            return set(self._dead)

    def live(self):
        with self._lock:
            return {r for r in self._last if r not in self._dead}

    # -- the watchdog ------------------------------------------------------
    def check(self, now=None):
        """One watchdog scan; returns the ranks newly declared dead.
        ``on_dead`` runs outside the lock (it may call back in)."""
        now = time.monotonic() if now is None else now
        newly = []
        with self._lock:
            for rank, last in self._last.items():
                if rank not in self._dead and now - last > self.timeout_s:
                    self._dead.add(rank)
                    newly.append(rank)
        for rank in newly:
            if self._on_dead is not None:
                self._on_dead(rank)
        return newly

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._watch,
                                            name="mxtpu-hb-watchdog",
                                            daemon=True)
            self._thread.start()
        return self

    def _watch(self):
        while not self._stop.wait(self.poll_s):
            try:
                self.check()
            except Exception:
                # an on_dead callback error must not kill the watchdog:
                # with this thread gone, dead-rank detection (and key
                # reassignment) silently stops for the rest of the run
                logging.getLogger(__name__).exception(
                    "heartbeat watchdog scan failed; continuing")

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class HeartbeatSender:
    """Worker-side beat loop: call ``beat_fn()`` every ``interval_s``."""

    def __init__(self, beat_fn, interval_s=2.0):
        self._fn = beat_fn
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="mxtpu-hb-sender", daemon=True)
        self.beats = 0

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self._fn()
                self.beats += 1
            except Exception:
                # best-effort: a failed beat just widens the silence the
                # watchdog measures; the sender must not die of it
                pass

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
