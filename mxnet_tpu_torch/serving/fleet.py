"""ModelFleet: N named models behind one endpoint, overload-proof.

The port of ``mxnet_tpu/serving/fleet.py``: one process hosts many
runners, each behind its own batcher — a deadline-aware
:class:`~mxnet_tpu_torch.serving.batcher.Batcher` for a fixed-shape
runner (``register``), a continuous-batching
:class:`~mxnet_tpu_torch.serving.decode.DecodeBatcher` for a
:class:`~mxnet_tpu_torch.serving.decode.DecodeRunner`
(``register_decode``) — with the failure modes of a production fleet
handled explicitly:

- **memory-aware packing (static admission control)**: registration sums
  the *modeled* peak device memory of every hosted model against the
  fleet's cap; an over-cap registration is refused at load time with the
  modeled numbers in the error.
- **SLO-tiered routing**: requests route by model name; each batcher
  sheds deterministically, lowest tier first, before its queue collapses.
- **per-model circuit breaker**: repeated runner failures trip the
  model's :class:`CircuitBreaker` (open durations from
  ``resilience/backoff.py``'s :class:`BackoffPolicy`); while open,
  traffic fails fast (or degrades, below).
- **graceful degradation**: a model registered with ``fallback=``
  absorbs the primary's overflow instead of it being dropped.
- **hot swap under drain** for fixed-shape runners (decode entries drain
  and re-register instead).

The deterministic canary split of the JAX fleet is not ported yet.

Chaos probe sites (``resilience/chaos.py``): ``serving.route`` fires per
routed request (count = request ordinal, ctx = (model, tier)) and
``serving.swap`` per swap (ctx = model name).
"""
from __future__ import annotations

import math
import threading
import time

from ..base import MXNetError
from ..resilience.backoff import BackoffPolicy
from .batcher import Batcher, DEFAULT_TIER, RequestShed, ServerBusy
from .stats import ServingStats

__all__ = ["ModelFleet", "CircuitBreaker", "BreakerOpen", "UnknownModel"]

class BreakerOpen(MXNetError):
    """The model's circuit breaker is open — fail fast (HTTP 503 with
    ``Retry-After`` = ``retry_after_s``)."""

    def __init__(self, message, model=None, retry_after_s=1.0):
        super().__init__(message)
        self.model = model
        self.retry_after_s = float(retry_after_s)


class UnknownModel(MXNetError):
    """Routing key names no registered model (HTTP 404)."""


class CircuitBreaker:
    """Per-model circuit breaker: closed -> open -> half-open -> closed.

    ``failure_threshold`` consecutive batch failures trip it open; the
    open duration is ``policy.delay(trip_count)`` (exponential, from the
    shared :class:`BackoffPolicy` — a repeatedly-sick model backs off
    harder).  After the open window one probe window is allowed
    (half-open): a success closes the breaker and resets the trip count,
    a failure re-opens it with the next backoff delay.  Thread-safe;
    all timing on ``time.monotonic()``.
    """

    def __init__(self, failure_threshold=3, policy=None):
        self.failure_threshold = int(failure_threshold)
        if self.failure_threshold < 1:
            raise MXNetError("failure_threshold must be >= 1")
        # jitter=0: a single server gains nothing from desynchronizing
        # against itself, and deterministic open windows are what the
        # chaos tests replay
        self.policy = policy if policy is not None else BackoffPolicy(
            base_s=0.5, factor=2.0, max_delay_s=30.0, jitter=0.0)
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._trips = 0
        self._open_until = 0.0

    @property
    def state(self):
        with self._lock:
            return self._state_locked()

    def _state_locked(self):
        if self._state == "open" and \
                time.monotonic() >= self._open_until:
            self._state = "half_open"
        return self._state

    def allow(self):
        """May traffic flow?  True while closed or half-open (the probe
        window); False while the open window runs."""
        with self._lock:
            return self._state_locked() != "open"

    def retry_after_s(self):
        with self._lock:
            if self._state_locked() != "open":
                return 0.0
            return max(0.0, self._open_until - time.monotonic())

    def record_success(self):
        with self._lock:
            self._consecutive = 0
            if self._state_locked() == "half_open":
                self._state = "closed"
                self._trips = 0

    def record_failure(self):
        with self._lock:
            state = self._state_locked()
            if state == "half_open":
                self._trip_locked()
                return
            self._consecutive += 1
            if state == "closed" and \
                    self._consecutive >= self.failure_threshold:
                self._trip_locked()

    def _trip_locked(self):
        self._state = "open"
        self._open_until = time.monotonic() + \
            self.policy.delay(min(self._trips, self.policy.max_retries))
        self._trips += 1
        self._consecutive = 0

    def reset(self):
        """Back to pristine closed (wired to hot swap: a fresh runner
        deserves a fresh failure budget)."""
        with self._lock:
            self._state = "closed"
            self._consecutive = 0
            self._trips = 0
            self._open_until = 0.0

    def __repr__(self):
        # one acquisition, raw state: the state property takes the same
        # non-reentrant lock
        with self._lock:
            return "<CircuitBreaker %s trips=%d>" % (
                self._state_locked(), self._trips)


class _Entry:
    """One hosted model: runner (behind its batcher), breaker, packing
    bytes, fallback route, declared SLOs and swap bookkeeping."""

    __slots__ = ("name", "batcher", "breaker", "hbm_bytes", "fallback",
                 "tier_slos", "last_swap_blip_ms")

    def __init__(self, name, batcher, breaker, hbm_bytes, fallback,
                 tier_slos):
        self.name = name
        self.batcher = batcher
        self.breaker = breaker
        self.hbm_bytes = hbm_bytes
        self.fallback = fallback
        self.tier_slos = dict(tier_slos or {})
        self.last_swap_blip_ms = None

    @property
    def runner(self):
        return self.batcher.runner


class ModelFleet:
    """N named runners behind one routing surface.

    Parameters
    ----------
    hbm_cap_bytes : summed modeled device-memory cap for packing
        (default: the ``MXTPU_SERVING_HBM_CAP`` env var; 0/unset
        disables).  Checked statically at every registration.
    stall_threshold_s : a model whose in-flight batch exceeds this is
        reported unready (``/readyz``) while the process stays live.
    batch_timeout_ms / max_queue : per-model Batcher defaults
        (overridable per ``register``).
    """

    def __init__(self, hbm_cap_bytes=None, stall_threshold_s=30.0,
                 batch_timeout_ms=2.0, max_queue=256):
        import os
        if hbm_cap_bytes is None:
            hbm_cap_bytes = int(os.environ.get(
                "MXTPU_SERVING_HBM_CAP", "0")) or None
        self.hbm_cap_bytes = hbm_cap_bytes
        self.stall_threshold_s = float(stall_threshold_s)
        self.batch_timeout_ms = float(batch_timeout_ms)
        self.max_queue = int(max_queue)
        self._lock = threading.Lock()
        self._entries = {}          # name -> _Entry, registration order
        self._default = None
        self._route_seq = 0
        # one pane of glass: per-model serving stats + breaker state +
        # the packing ledger become mxtpu_serving_* gauges at every
        # telemetry scrape (weakly held — a dropped fleet disappears)
        from .. import telemetry as _tele
        _tele.registry().register_collector(self._metrics_samples,
                                            name="serving-fleet")

    _BREAKER_STATE_ENUM = {"closed": 0, "open": 1, "half_open": 2}

    def _metrics_samples(self):
        samples = [
            ("mxtpu_serving_modeled_hbm_total_bytes", {},
             self.modeled_hbm_total()),
            ("mxtpu_serving_hbm_cap_bytes", {}, self.hbm_cap_bytes or 0),
        ]
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            labels = {"model": e.name}
            st = e.batcher.stats
            samples.append(("mxtpu_serving_breaker_state", labels,
                            self._BREAKER_STATE_ENUM.get(e.breaker.state,
                                                         -1)))
            samples.append(("mxtpu_serving_queue_depth", labels,
                            e.batcher.queue_depth))
            for key in ("requests_total", "rejected_total", "errors_total",
                        "shed_total", "degraded_total", "swaps_total",
                        "batches_total", "queue_depth_peak"):
                samples.append(("mxtpu_serving_" + key, labels,
                                getattr(st, key)))
            p50, p99 = st.latency_ms()
            samples.append(("mxtpu_serving_latency_p50_ms", labels, p50))
            samples.append(("mxtpu_serving_latency_p99_ms", labels, p99))
            for tier in ("gold", "silver", "bronze"):
                tp50, tp99 = st.tier_latency_ms(tier)
                tl = dict(labels, tier=tier)
                samples.append(("mxtpu_serving_tier_p50_ms", tl, tp50))
                samples.append(("mxtpu_serving_tier_p99_ms", tl, tp99))
            # decode entries: the per-token surface —
            # token latency percentiles, token/step totals, page-pool
            # occupancy against the pages-based admission bound
            if hasattr(st, "token_latency_ms"):
                kp50, kp99 = st.token_latency_ms()
                samples.append(("mxtpu_decode_token_p50_ms", labels,
                                kp50))
                samples.append(("mxtpu_decode_token_p99_ms", labels,
                                kp99))
                samples.append(("mxtpu_decode_tokens_total", labels,
                                st.tokens_total))
                samples.append(("mxtpu_decode_steps_total", labels,
                                st.steps_total))
                samples.append(("mxtpu_decode_sequences_done_total",
                                labels, st.sequences_done_total))
                pool = getattr(e.runner, "pool", None)
                if pool is not None:
                    samples.append(("mxtpu_decode_pages_in_use", labels,
                                    pool.pages_in_use))
                    samples.append(("mxtpu_decode_pages_free", labels,
                                    pool.available))
        return samples

    # -- registration: admission control as a static problem ---------------
    def models(self):
        with self._lock:
            return list(self._entries)

    @property
    def default_model(self):
        with self._lock:
            return self._default

    def entry(self, name=None):
        with self._lock:
            key = name if name is not None else self._default
            try:
                return self._entries[key]
            except KeyError:
                raise UnknownModel(
                    "no model %r registered (have: %s)"
                    % (key, sorted(self._entries) or "none")) from None

    def runner(self, name=None):
        return self.entry(name).runner

    def batcher(self, name=None):
        return self.entry(name).batcher

    def _check_cap_locked(self, name, candidate):
        """Refuse a registration that would take the summed modeled
        device memory over the cap (models modeled as None are not
        counted)."""
        if not self.hbm_cap_bytes:
            return
        packing = {e.name: e.hbm_bytes for e in self._entries.values()}
        packing[name] = candidate
        known = {n: int(b) for n, b in packing.items() if b}
        total = sum(known.values())
        if total <= int(self.hbm_cap_bytes):
            return
        detail = ", ".join("%s=%.1f MiB" % (n, b / (1 << 20))
                           for n, b in sorted(known.items()))
        raise MXNetError(
            "fleet registration refused — modeled HBM over cap: summed "
            "modeled peak %.1f MiB exceeds the %.1f MiB cap (%s)"
            % (total / (1 << 20), int(self.hbm_cap_bytes) / (1 << 20),
               detail))

    @staticmethod
    def _modeled_hbm(runner, hbm_bytes=None):
        # prefer the runner's own admission bound when it declares one:
        # fixed-shape runners price the max-over-buckets worst case,
        # decode runners price weights + KV page pool + one step's
        # working set — page-granular admission instead of assuming
        # every slot holds a full-context forward
        if hbm_bytes is not None:
            return int(hbm_bytes)
        admission = getattr(runner, "admission_hbm_bytes", None)
        if admission is not None:
            return admission()
        return runner.modeled_peak_hbm()

    def register(self, name, runner, fallback=None, hbm_bytes=None,
                 max_batch=None, batch_timeout_ms=None, max_queue=None,
                 service_time_hint_ms=None, breaker=None, tier_slos=None):
        """Host a fixed-shape ``runner`` (``example_shape``, ``buckets``,
        ``max_batch``, ``bucket_for``, ``forward_batch``,
        ``recompiles_since_warmup``) as ``name``.  Refused
        (``MXNetError`` with the modeled per-model numbers) when the
        fleet's summed modeled peak memory would exceed ``hbm_cap_bytes``
        — over-commit is caught at registration, not at the first OOM.

        ``hbm_bytes`` overrides the modeled figure for runners that
        declare none.
        ``fallback`` names the cheaper variant (registered before or
        after) that absorbs this model's overflow; ``tier_slos`` is the
        declared per-tier p99 budget (ms) surfaced in stats.
        """
        name = str(name)
        candidate = self._modeled_hbm(runner, hbm_bytes)
        with self._lock:
            if name in self._entries:
                raise MXNetError("model %r already registered; use swap()"
                                 % name)
            self._check_cap_locked(name, candidate)
            breaker = breaker if breaker is not None else CircuitBreaker()
            batcher = Batcher(
                runner, max_batch=max_batch,
                batch_timeout_ms=self.batch_timeout_ms
                if batch_timeout_ms is None else batch_timeout_ms,
                max_queue=self.max_queue if max_queue is None
                else max_queue,
                stats=ServingStats(runner.buckets),
                service_time_hint_ms=service_time_hint_ms,
                on_batch_success=breaker.record_success,
                on_batch_error=lambda exc: breaker.record_failure(),
                model=name)
            entry = _Entry(name, batcher, breaker, candidate, fallback,
                           tier_slos)
            self._entries[name] = entry
            if self._default is None:
                self._default = name
        return entry

    def register_decode(self, name, runner, max_queue=None,
                        token_time_hint_ms=None, breaker=None,
                        tier_slos=None, hbm_bytes=None, eos_token=None):
        """Host a :class:`~mxnet_tpu_torch.serving.decode.DecodeRunner` as
        ``name`` behind a continuous-batching
        :class:`~mxnet_tpu_torch.serving.decode.DecodeBatcher`.

        Admission against the cap uses the runner's pages-based
        ``admission_hbm_bytes()`` — weights + the KV page pool + one
        decode step's working set — so a decode model packs at page
        granularity next to fixed-shape models priced at their
        max-over-buckets worst case.  Requests route through
        :meth:`decode` / :meth:`decode_submit`; the fixed-shape
        :meth:`submit` path refuses decode entries.  Decode entries
        never hot-swap (live page tables index one runner's cache
        pool) — drain and re-register instead.
        """
        from .decode import DecodeBatcher, DecodeStats
        name = str(name)
        candidate = self._modeled_hbm(runner, hbm_bytes)
        with self._lock:
            if name in self._entries:
                raise MXNetError("model %r already registered; decode "
                                 "models drain and re-register" % name)
            self._check_cap_locked(name, candidate)
            breaker = breaker if breaker is not None else CircuitBreaker()
            batcher = DecodeBatcher(
                runner,
                max_queue=self.max_queue if max_queue is None
                else max_queue,
                token_time_hint_ms=token_time_hint_ms,
                stats=DecodeStats(runner.buckets),
                on_step_success=breaker.record_success,
                on_step_error=lambda exc: breaker.record_failure(),
                model=name, eos_token=eos_token)
            entry = _Entry(name, batcher, breaker, candidate, None,
                           tier_slos)
            self._entries[name] = entry
            if self._default is None:
                self._default = name
        return entry

    @staticmethod
    def _is_decode(entry):
        return hasattr(entry.batcher, "schedule_events")

    def decode_submit(self, prompt, model=None, max_new_tokens=16,
                      tier=DEFAULT_TIER, deadline_ms=None, on_token=None):
        """Route one prompt to a decode model; returns a future-like
        whose ``result()`` is the generated token array.  Same refusal
        surface as :meth:`submit` (:class:`BreakerOpen` /
        :class:`RequestShed` / :class:`ServerBusy` / :class:`Draining`);
        no fallback rerouting — decode models declare none."""
        entry = self.entry(model)
        if not self._is_decode(entry):
            raise MXNetError(
                "model %r is a fixed-shape model; use fleet.submit()"
                % entry.name)
        if not entry.breaker.allow():
            raise BreakerOpen(
                "model %r breaker is open; failing fast" % entry.name,
                model=entry.name,
                retry_after_s=entry.breaker.retry_after_s())
        return entry.batcher.submit(
            prompt, max_new_tokens=max_new_tokens, tier=tier,
            deadline_ms=deadline_ms, on_token=on_token)

    def decode(self, prompt, model=None, max_new_tokens=16, timeout=60.0,
               tier=DEFAULT_TIER, deadline_ms=None, on_token=None):
        """Blocking decode: submit + wait for the generated tokens."""
        fut = self.decode_submit(prompt, model=model,
                                 max_new_tokens=max_new_tokens,
                                 tier=tier, deadline_ms=deadline_ms,
                                 on_token=on_token)
        return fut.result(timeout)

    def provenance_digests(self):
        """{model: checkpoint digest or None} — the hello-path summary
        of what bytes are live (full provenance rides ``stats_dict``)."""
        with self._lock:
            entries = list(self._entries.values())
        out = {}
        for e in entries:
            prov = getattr(e.runner, "provenance", None)
            out[e.name] = prov.get("digest") if prov else None
        return out

    def modeled_hbm_total(self):
        """Summed modeled peak HBM over registered models (None-modeled
        runners excluded) — the packing ledger /stats exposes."""
        with self._lock:
            return sum(e.hbm_bytes for e in self._entries.values()
                       if e.hbm_bytes)

    # -- routing -----------------------------------------------------------
    def submit(self, example, model=None, tier=DEFAULT_TIER,
               deadline_ms=None):
        """Route one example: returns a future-like with ``.result()``.

        Overload ladder: an open breaker or a shed/full-queue refusal on
        the primary reroutes to its registered ``fallback`` (degraded
        mode) when that variant is warm and closed; only when the
        fallback also refuses does the caller see the original
        :class:`RequestShed` / :class:`BreakerOpen` / :class:`ServerBusy`.
        """
        from ..resilience import chaos as _chaos
        entry = self.entry(model)
        if self._is_decode(entry):
            raise MXNetError(
                "model %r serves autoregressive decode; use "
                "fleet.decode()/decode_submit()" % entry.name)
        with self._lock:
            self._route_seq += 1
            seq = self._route_seq
        _chaos.maybe_inject("serving.route", count=seq,
                            ctx=(entry.name, tier))
        self._check_shape(entry, example)
        return self._submit_entry(entry, example, tier, deadline_ms,
                                  allow_fallback=True)

    def _check_shape(self, entry, example):
        import numpy as _np
        shape = _np.asarray(example).shape
        want = tuple(entry.runner.example_shape)
        if tuple(shape) != want:
            raise MXNetError(
                "example shape %r does not match model %r example_shape "
                "%r" % (tuple(shape), entry.name, want))

    def _fallback_entry(self, entry):
        if not entry.fallback:
            return None
        with self._lock:
            fb = self._entries.get(entry.fallback)
        if fb is None or not getattr(fb.runner, "warmed_up", False):
            return None
        if not fb.breaker.allow() or fb.batcher.draining:
            return None
        return fb

    def _submit_entry(self, entry, example, tier, deadline_ms,
                      allow_fallback):
        if not entry.breaker.allow():
            fb = self._fallback_entry(entry) if allow_fallback else None
            if fb is not None:
                entry.batcher.stats.on_degraded()
                return self._submit_entry(fb, example, tier, deadline_ms,
                                          allow_fallback=False)
            raise BreakerOpen(
                "model %r breaker is open (%d consecutive batch "
                "failures tripped it); retry after %.1fs"
                % (entry.name, entry.breaker.failure_threshold,
                   entry.breaker.retry_after_s()),
                model=entry.name,
                retry_after_s=max(1.0, math.ceil(
                    entry.breaker.retry_after_s())))
        try:
            return entry.batcher.submit(example, tier=tier,
                                        deadline_ms=deadline_ms,
                                        model=entry.name)
        except (RequestShed, ServerBusy):
            fb = self._fallback_entry(entry) if allow_fallback else None
            if fb is None:
                raise
            entry.batcher.stats.on_degraded()
            return self._submit_entry(fb, example, tier, deadline_ms,
                                      allow_fallback=False)

    def infer(self, example, model=None, tier=DEFAULT_TIER,
              deadline_ms=None, timeout=30.0):
        """Blocking convenience: route + wait for the result row."""
        return self.submit(example, model=model, tier=tier,
                           deadline_ms=deadline_ms).result(timeout)

    # -- hot swap ----------------------------------------------------------
    def swap(self, name, runner, warmup=True, timeout=30.0):
        """Replace model ``name``'s runner under drain of its in-flight
        batch: the new runner is warmed first (nothing is routed to a
        cold bucket ladder), the swap waits for the executing batch, and
        queued requests are served by the replacement — zero failed
        in-flight requests.  The breaker resets (a fresh runner deserves
        a fresh failure budget).  Returns the previous runner; the blip
        (ms the swap waited on the in-flight batch) lands in
        ``stats_dict()``."""
        from ..resilience import chaos as _chaos
        entry = self.entry(name)
        _chaos.maybe_inject("serving.swap", ctx=entry.name)
        if warmup and not getattr(runner, "warmed_up", False):
            runner.warmup()
        t0 = time.monotonic()
        old = entry.batcher.swap_runner(runner, timeout=timeout)
        entry.last_swap_blip_ms = (time.monotonic() - t0) * 1000.0
        entry.breaker.reset()
        return old

    # -- readiness ---------------------------------------------------------
    def unready(self):
        """{model: reason} for every model not currently routable:
        ``warming`` (bucket ladder not compiled), ``breaker_open`` /
        ``breaker_half_open`` (tripped on repeated failures), ``stalled``
        (in-flight batch exceeded ``stall_threshold_s``), ``draining``.
        Empty dict == the fleet is ready (the /readyz contract)."""
        out = {}
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            if not getattr(e.runner, "warmed_up", False):
                out[e.name] = "warming"
            elif e.breaker.state != "closed":
                out[e.name] = "breaker_%s" % e.breaker.state
            elif e.batcher.stalled(self.stall_threshold_s):
                out[e.name] = "stalled"
            elif e.batcher.draining:
                out[e.name] = "draining"
        return out

    @property
    def ready(self):
        return not self.unready()

    @property
    def draining(self):
        with self._lock:
            entries = list(self._entries.values())
        return any(e.batcher.draining for e in entries)

    # -- observability -----------------------------------------------------
    def stats_dict(self):
        """Per-model stats + the fleet packing/routing ledger."""
        with self._lock:
            entries = list(self._entries.values())
            cap = self.hbm_cap_bytes
            default = self._default
        models = {}
        for e in entries:
            d = e.batcher.stats.as_dict()
            d["breaker"] = e.breaker.state
            d["fallback"] = e.fallback
            d["tier_slos_ms"] = dict(e.tier_slos)
            d["modeled_peak_hbm_bytes"] = e.hbm_bytes
            d["queue_depth"] = e.batcher.queue_depth
            d["modeled_wait_ms"] = round(e.batcher.modeled_wait_ms(), 3)
            d["recompiles"] = e.runner.recompiles_since_warmup()
            d["buckets_configured"] = list(e.runner.buckets)
            if self._is_decode(e):
                d["page_pool"] = e.runner.pool.describe()
            # checkpoint provenance: which exact bytes this entry serves
            # (digest + epoch/step/train_run_id, or None for untracked
            # runners) — what promotion audit records cross-reference
            d["provenance"] = getattr(e.runner, "provenance", None)
            if e.last_swap_blip_ms is not None:
                d["last_swap_blip_ms"] = round(e.last_swap_blip_ms, 3)
            models[e.name] = d
        return {
            "models": models,
            "default_model": default,
            "hbm_cap_bytes": cap,
            "modeled_hbm_total_bytes": self.modeled_hbm_total(),
            "unready": self.unready(),
        }

    # -- lifecycle ---------------------------------------------------------
    def drain(self, timeout=60.0):
        """Drain every model's batcher against one shared deadline.
        Raises ``TimeoutError`` (after attempting all) when any batcher
        missed it — callers holding a hard deadline follow up with
        :meth:`force_drain`."""
        deadline = time.monotonic() + float(timeout)
        late = []
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            try:
                e.batcher.drain(timeout=max(0.05,
                                            deadline - time.monotonic()))
            except TimeoutError:
                late.append(e.name)
        if late:
            raise TimeoutError("fleet did not drain within %ss "
                               "(stuck: %s)" % (timeout, late))
        return True

    def force_drain(self):
        with self._lock:
            entries = list(self._entries.values())
        return sum(e.batcher.force_drain() for e in entries)

    def __repr__(self):
        with self._lock:
            names, default = list(self._entries), self._default
        return "<ModelFleet %s default=%r>" % (names, default)
