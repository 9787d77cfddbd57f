"""Batcher: coalesce concurrent single requests into bucketed batches,
with SLO tiers, deadline-aware coalescing, and deterministic load shed.

The port's copy of ``mxnet_tpu/serving/batcher.py``: the SLO tiers, the
refusal exceptions the decode tier shares, and the dynamic batcher the
fleet puts in front of a fixed-shape runner.
Requests carry ``(tier, deadline_ms)``; a priority structure feeds one
worker thread, which takes up to ``max_batch`` requests ordered by
``(tier, deadline, arrival)`` — so under contention the gold tier is
coalesced first and, within a tier, near-deadline requests are preferred
into the next bucket — stacks them, and hands the batch to the
runner (``bucket_for`` + ``forward_batch``), which pads to the nearest
bucket.  Results are split back per-request.

Overload answers, in order of preference (the anti-queue-collapse
contract of ``mxnet_tpu/serving/batcher.py``):

- **shed before rot**: when the *modeled* queue wait (queued position /
  ``max_batch`` x the measured-or-hinted per-batch service time) already
  exceeds a request's ``deadline_ms``, the request is refused at
  admission with :class:`RequestShed` carrying a ``retry_after_s`` hint —
  immediately and deterministically, instead of timing out in the queue.
  The worker re-runs the same arithmetic before each batch and sheds
  queued requests that have become hopeless (``shed_at="sweep"``).
  Because lower tiers sort behind higher ones, their modeled wait grows
  first and shedding is confined to the lowest tier until it is empty.
- **evict, lowest tier first**: a submit against a full queue evicts the
  worst-ranked queued request when the newcomer strictly outranks it
  (deterministic: lowest tier, then latest deadline, then newest);
  otherwise the newcomer gets :class:`ServerBusy` (HTTP 429).
- ``drain()`` stops admission, completes everything already queued, and
  joins the worker — the graceful-shutdown half of the contract.

``swap_runner()`` replaces the model *under drain of the in-flight batch
only*: it waits for the batch currently executing to finish (the runner
lock), installs the new runner, and every queued request is served by the
replacement — zero in-flight failures, the hot-swap half of the fleet
contract.  All deadline/latency arithmetic uses ``time.monotonic()``
(wall-clock ``time.time()`` would tear under NTP steps).
"""
from __future__ import annotations

import bisect
import math
import threading
import time

import numpy as _np

from ..base import MXNetError
from .stats import ServingStats

__all__ = ["Batcher", "ServerBusy", "Draining", "RequestShed",
           "TIERS", "DEFAULT_TIER", "tier_rank", "tier_name"]

# SLO tiers, best first.  Integer ranks are accepted anywhere a name is
# (0 = gold).  The *names* are what stats and HTTP payloads speak.
TIERS = {"gold": 0, "silver": 1, "bronze": 2}
_TIER_NAMES = {v: k for k, v in TIERS.items()}
DEFAULT_TIER = "gold"


def tier_rank(tier):
    """Canonical integer rank for a tier name or int (0 is best)."""
    if isinstance(tier, bool):
        raise MXNetError("bad tier %r" % (tier,))
    if isinstance(tier, int):
        if tier < 0:
            raise MXNetError("tier rank must be >= 0, got %d" % tier)
        return tier
    try:
        return TIERS[str(tier).lower()]
    except KeyError:
        raise MXNetError("unknown tier %r (want one of %s or an int rank)"
                         % (tier, sorted(TIERS))) from None


def tier_name(rank):
    """Display name for a rank (falls back to ``tier<rank>``)."""
    return _TIER_NAMES.get(int(rank), "tier%d" % int(rank))


class ServerBusy(MXNetError):
    """Queue full and the request outranks nothing — reject now rather
    than stall (HTTP 429)."""


class Draining(MXNetError):
    """Server is draining — no new admissions (HTTP 503)."""


class RequestShed(MXNetError):
    """Request shed by admission control: the modeled queue wait exceeds
    its deadline, or it was evicted by a higher-tier arrival (HTTP 503
    with ``Retry-After`` = ``retry_after_s``)."""

    def __init__(self, message, tier="gold", retry_after_s=1.0,
                 shed_at="admit"):
        super().__init__(message)
        self.tier = tier
        self.retry_after_s = float(retry_after_s)
        self.shed_at = shed_at  # "admit" | "evict" | "sweep"


class _Pending:
    """One in-flight request: a tiny future (stdlib-only) plus its SLO
    coordinates.  Orders by (tier rank, absolute deadline, arrival)."""

    __slots__ = ("example", "_event", "_result", "_exc", "t_submit",
                 "tier_rank", "deadline_ms", "t_deadline", "seq")

    def __init__(self, example, tier_rank=0, deadline_ms=None, seq=0):
        self.example = example
        self._event = threading.Event()
        self._result = None
        self._exc = None
        self.t_submit = time.monotonic()
        self.tier_rank = tier_rank
        self.deadline_ms = deadline_ms
        self.t_deadline = (self.t_submit + deadline_ms / 1000.0
                           if deadline_ms is not None else None)
        self.seq = seq

    @property
    def tier(self):
        return tier_name(self.tier_rank)

    def _key(self):
        return (self.tier_rank,
                self.t_deadline if self.t_deadline is not None
                else float("inf"),
                self.seq)

    def __lt__(self, other):
        return self._key() < other._key()

    def set_result(self, value):
        self._result = value
        self._event.set()

    def set_exception(self, exc):
        self._exc = exc
        self._event.set()

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("request not served within %ss" % timeout)
        if self._exc is not None:
            raise self._exc
        return self._result


class Batcher:
    """Deadline-aware dynamic batcher over one fixed-shape runner.

    New-in-fleet parameters (all optional, defaults reproduce the
    single-tier behavior):

    service_time_hint_ms : pins the modeled per-batch service time used
        by admission control.  Unset, an EWMA of measured batch times is
        used (admission is optimistic until the first measurement).  A
        pinned hint plus a single submitting thread makes every shed
        decision deterministic — what the chaos tests replay.
    on_batch_success / on_batch_error : callbacks fired after each batch
        (the fleet wires its per-model circuit breaker here).
    model : display name carried into stats/errors (fleet routing key).
    """

    def __init__(self, runner, max_batch=None, batch_timeout_ms=2.0,
                 max_queue=256, stats=None, service_time_hint_ms=None,
                 on_batch_success=None, on_batch_error=None, model=None):
        self.runner = runner
        self._max_batch_req = int(max_batch) if max_batch else None
        self.max_batch = min(self._max_batch_req or runner.max_batch,
                             runner.max_batch)
        self.batch_timeout_s = float(batch_timeout_ms) / 1000.0
        self.max_queue = int(max_queue)
        self.model = model
        self.stats = stats if stats is not None else \
            ServingStats(runner.buckets)
        self.service_time_hint_ms = service_time_hint_ms
        self.on_batch_success = on_batch_success
        self.on_batch_error = on_batch_error
        self._est_ewma_ms = None
        # _cond guards _heap/_seq and serializes admission against drain
        self._cond = threading.Condition()
        self._heap = []        # sorted by _Pending._key()
        self._seq = 0
        # held while a batch executes on the runner: swap_runner acquires
        # it, so a swap waits exactly for the in-flight batch (hot swap
        # under drain with zero in-flight failures)
        self._runner_lock = threading.Lock()
        self._batch_started = None  # monotonic() while a batch executes
        self._draining = threading.Event()
        self._drained = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="mxtpu-batcher", daemon=True)
        self._thread.start()

    # -- admission-control arithmetic --------------------------------------
    @property
    def est_batch_ms(self):
        """Modeled per-batch service time: the pinned hint when set, else
        the EWMA of measured batches (None before any signal)."""
        if self.service_time_hint_ms is not None:
            return float(self.service_time_hint_ms)
        return self._est_ewma_ms

    def _modeled_wait_ms(self, position):
        """Modeled time until a request at 0-based queue ``position`` is
        *served*: full batches ahead of it, plus its own batch, plus the
        batch currently executing (if any), each costing ``est_batch_ms``.
        0.0 when there is no service-time signal yet (admit
        optimistically)."""
        est = self.est_batch_ms
        if est is None:
            return 0.0
        in_flight = 1 if self._batch_started is not None else 0
        return (position // self.max_batch + 1 + in_flight) * est

    def modeled_wait_ms(self):
        """Modeled wait a request submitted *now* at the lowest priority
        would see (the /stats + Retry-After surface)."""
        with self._cond:
            return self._modeled_wait_ms(len(self._heap))

    def stalled(self, threshold_s):
        """True when the in-flight batch has been executing longer than
        ``threshold_s`` — the readiness-probe signal for a wedged runner
        (the process stays live; routing should stop)."""
        started = self._batch_started
        return started is not None and \
            time.monotonic() - started > float(threshold_s)

    # -- client side -------------------------------------------------------
    @property
    def queue_depth(self):
        # len() of a heap mid-sift on another thread can be torn on
        # pypy-likes and is racy in spirit everywhere: read it under
        # the same condition lock submit/sweep mutate it under
        with self._cond:
            return len(self._heap)

    @property
    def draining(self):
        return self._draining.is_set()

    def _retry_after_s(self, wait_ms):
        return max(1.0, math.ceil(wait_ms / 1000.0))

    def submit(self, example, tier=DEFAULT_TIER, deadline_ms=None,
               model=None):
        """Enqueue one example; returns a future-like with ``.result()``.

        ``tier`` orders the request against concurrent load (gold >
        silver > bronze); ``deadline_ms`` arms admission control: when
        the modeled queue wait already exceeds it the request is shed
        *now* (:class:`RequestShed`) instead of timing out queued.
        Raises :class:`ServerBusy` when the queue is full and the request
        outranks nothing, :class:`Draining` after ``drain()`` — never
        blocks the caller."""
        rank = tier_rank(tier)
        if deadline_ms is not None and deadline_ms <= 0:
            raise MXNetError("deadline_ms must be positive, got %r"
                             % (deadline_ms,))
        victim = None
        with self._cond:
            if self._draining.is_set():
                raise Draining("server is draining; request rejected")
            req = _Pending(_np.asarray(example), rank, deadline_ms,
                           self._seq)
            self._seq += 1
            position = bisect.bisect_left(self._heap, req)
            if deadline_ms is not None:
                wait_ms = self._modeled_wait_ms(position)
                if wait_ms > deadline_ms:
                    self.stats.on_shed(req.tier)
                    raise RequestShed(
                        "modeled queue wait %.0fms exceeds deadline %.0fms"
                        " (tier=%s, depth=%d); shed at admission"
                        % (wait_ms, deadline_ms, req.tier, len(self._heap)),
                        tier=req.tier,
                        retry_after_s=self._retry_after_s(wait_ms),
                        shed_at="admit")
            if len(self._heap) >= self.max_queue:
                # full queue: evict the worst-ranked queued request iff
                # the newcomer strictly outranks it (lowest tier, then
                # latest deadline, then newest — deterministic)
                if self._heap and req < self._heap[-1]:
                    victim = self._heap.pop()
                    self.stats.on_dequeue(1)
                    self.stats.on_shed(victim.tier)
                else:
                    self.stats.on_reject()
                    raise ServerBusy(
                        "request queue full (%d deep); retry later"
                        % self.max_queue) from None
            bisect.insort(self._heap, req)
            self._cond.notify_all()
        if victim is not None:
            victim.set_exception(RequestShed(
                "evicted by a higher-tier arrival under a full queue "
                "(tier=%s)" % victim.tier, tier=victim.tier,
                retry_after_s=self._retry_after_s(self.modeled_wait_ms()),
                shed_at="evict"))
        self.stats.on_submit()
        return req

    def infer(self, example, timeout=30.0, tier=DEFAULT_TIER,
              deadline_ms=None):
        """Blocking convenience: submit + wait for the result row."""
        return self.submit(example, tier=tier,
                           deadline_ms=deadline_ms).result(timeout)

    # -- worker side -------------------------------------------------------
    def _sweep_hopeless_locked(self):
        """Shed queued requests whose deadline can no longer be met given
        their current position and the modeled service time (they would
        rot, occupy queue slots, and waste a device call).  Returns the
        shed list; caller resolves them outside the lock.  Positions run
        in priority order, so lower tiers — parked at the back — see the
        largest modeled wait and are shed first by construction."""
        if not self._heap:
            return []
        now = time.monotonic()
        shed, keep = [], []
        for pos, req in enumerate(self._heap):
            if req.t_deadline is not None and \
                    now + self._modeled_wait_ms(pos) / 1000.0 \
                    > req.t_deadline:
                shed.append(req)
            else:
                keep.append(req)
        if shed:
            self._heap = keep
            self.stats.on_dequeue(len(shed))
            for req in shed:
                self.stats.on_shed(req.tier, swept=True)
        return shed

    def _take_batch(self):
        """Block until work is available, honor the coalescing window,
        shed hopeless requests, and return up to ``max_batch`` requests
        in (tier, deadline, arrival) order.  Returns None when drained
        and empty (worker exit)."""
        with self._cond:
            while not self._heap:
                if self._draining.is_set():
                    return None
                self._cond.wait(timeout=0.1)
            # coalescing window: wait for fill, but close early when the
            # batch is full, drain began, or the most urgent deadline
            # would be burned by further waiting (near-deadline requests
            # go into the NEXT bucket, not one more window later)
            window_end = time.monotonic() + self.batch_timeout_s
            while (len(self._heap) < self.max_batch
                   and not self._draining.is_set()):
                now = time.monotonic()
                remaining = window_end - now
                if remaining <= 0:
                    break
                head_deadline = self._heap[0].t_deadline
                if head_deadline is not None:
                    est_s = (self.est_batch_ms or 0.0) / 1000.0
                    slack = head_deadline - est_s - now
                    if slack <= 0:
                        break
                    remaining = min(remaining, slack)
                self._cond.wait(remaining)
            shed = self._sweep_hopeless_locked()
            batch = self._heap[:self.max_batch]
            del self._heap[:len(batch)]
            if batch:
                self.stats.on_dequeue(len(batch))
        for req in shed:
            req.set_exception(RequestShed(
                "deadline %.0fms unreachable from queue (modeled wait "
                "exceeds remaining budget, tier=%s); shed by sweep"
                % (req.deadline_ms, req.tier), tier=req.tier,
                retry_after_s=self._retry_after_s(self.modeled_wait_ms()),
                shed_at="sweep"))
        return batch

    def _run_batch(self, batch):
        from ..resilience import chaos as _chaos
        self._batch_started = time.monotonic()
        try:
            # chaos probe: a scheduled delay here stalls the runner (the
            # serving-overload failure mode); a raise fails the batch and
            # feeds the fleet's circuit breaker
            _chaos.maybe_inject("serving.batch", ctx=batch)
            n = len(batch)
            bucket = 0   # refined under the runner lock below; a
            #              failure before then reports the 0 bucket
            try:
                x = _np.stack([r.example for r in batch])
                with self._runner_lock:
                    # bucket choice and forward must see the SAME
                    # runner: a hot swap between a bare bucket_for and
                    # the locked forward would pad for the old model
                    # and execute on the new one
                    runner = self.runner
                    bucket = runner.bucket_for(n)
                    out = runner.forward_batch(x)
            except Exception as e:  # propagate per-request, keep serving
                for r in batch:
                    r.set_exception(e)
                self.stats.on_batch(bucket, n, [], error=True,
                                    tiers=[r.tier for r in batch])
                if self.on_batch_error is not None:
                    try:
                        self.on_batch_error(e)
                    except Exception:
                        pass
                return
            now = time.monotonic()
            self._observe_batch_ms((now - self._batch_started) * 1000.0)
            lat = []
            for i, r in enumerate(batch):
                r.set_result(out[i])
                lat.append((now - r.t_submit) * 1000.0)
            self.stats.on_batch(bucket, n, lat,
                                tiers=[r.tier for r in batch])
            self.stats.set_recompiles(runner.recompiles_since_warmup())
            if self.on_batch_success is not None:
                try:
                    self.on_batch_success()
                except Exception:
                    pass
        except Exception as e:
            # a failure outside the runner call (e.g. an injected chaos
            # raise) must not kill the worker: fail the batch, keep going
            for r in batch:
                if not r.done():
                    r.set_exception(e)
            self.stats.on_batch(0, len(batch), [], error=True,
                                tiers=[r.tier for r in batch])
            if self.on_batch_error is not None:
                try:
                    self.on_batch_error(e)
                except Exception:
                    pass
        finally:
            self._batch_started = None

    def _observe_batch_ms(self, measured_ms):
        if self._est_ewma_ms is None:
            self._est_ewma_ms = measured_ms
        else:
            self._est_ewma_ms = 0.7 * self._est_ewma_ms + 0.3 * measured_ms

    def _loop(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                break
            if batch:
                self._run_batch(batch)
        self._drained.set()

    # -- hot swap ----------------------------------------------------------
    def swap_runner(self, runner, timeout=30.0):
        """Replace the model under drain of the in-flight batch: waits
        for the batch currently executing (the runner lock), installs
        ``runner``, and every queued + future request is served by the
        replacement — zero in-flight failures.  The new runner must share
        the old one's ``example_shape`` (queued pixels must stay valid).
        Returns the previous runner; raises ``TimeoutError`` when the
        in-flight batch does not finish in ``timeout``."""
        if not self._runner_lock.acquire(timeout=float(timeout)):
            raise TimeoutError(
                "in-flight batch did not complete within %ss; swap aborted"
                % timeout)
        try:
            # compat check INSIDE the lock region: checked against the
            # runner actually being replaced, not one a concurrent swap
            # may itself be replacing
            if tuple(runner.example_shape) != \
                    tuple(self.runner.example_shape):
                raise MXNetError(
                    "swap refused: example_shape %r != %r — queued "
                    "requests would be fed to an incompatible model"
                    % (tuple(runner.example_shape),
                       tuple(self.runner.example_shape)))
            old, self.runner = self.runner, runner
            with self._cond:
                self.max_batch = min(self._max_batch_req or runner.max_batch,
                                     runner.max_batch)
            self.stats.on_swap()
        finally:
            self._runner_lock.release()
        return old

    # -- lifecycle ---------------------------------------------------------
    def drain(self, timeout=60.0):
        """Graceful shutdown: stop admitting, finish every queued request,
        join the worker.  Idempotent.  Raises ``TimeoutError`` when the
        deadline passes with work still in flight — callers that must
        stop anyway (``Server.drain``'s hard ``drain_timeout_s``) follow
        up with :meth:`force_drain`."""
        with self._cond:
            self._draining.set()
            self._cond.notify_all()
        if not self._drained.wait(timeout):
            raise TimeoutError("batcher did not drain within %ss" % timeout)
        self._thread.join(timeout=5.0)
        return True

    def force_drain(self):
        """The hard half of the drain deadline: stop admitting, fail every
        request still queued with :class:`Draining`, and mark the batcher
        drained WITHOUT waiting for a wedged worker (a hung model call's
        requests resolve if/when it returns; the daemon worker thread
        dies with the process).  Idempotent; returns the number of
        requests failed."""
        with self._cond:
            self._draining.set()
            stuck, self._heap = self._heap, []
            self._cond.notify_all()
        failed = 0
        for req in stuck:
            self.stats.on_dequeue(1)
            req.set_exception(Draining(
                "server hit its drain deadline; request not served"))
            failed += 1
        self._drained.set()
        return failed

    close = drain
