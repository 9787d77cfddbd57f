"""Serving observability: per-bucket latency percentiles, queue depth,
batch-fill ratio and recompile count.

The port's copy of ``mxnet_tpu/serving/stats.py``.  The queue depth and
recompile count ride :mod:`mxnet_tpu_torch.profiler` ``Domain``/``Counter``
objects.  ``as_dict()`` is the stable surface the HTTP ``/stats``
endpoint serializes.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from .. import profiler

__all__ = ["ServingStats", "percentile"]

# latency samples kept per bucket; old samples age out so /stats reflects
# recent traffic, not the whole process lifetime
_WINDOW = 2048


def percentile(samples, q):
    """Nearest-rank percentile of an iterable of floats (no numpy import on
    the request path)."""
    data = sorted(samples)
    if not data:
        return 0.0
    rank = max(0, min(len(data) - 1, int(round(q / 100.0 * (len(data) - 1)))))
    return data[rank]


class ServingStats:
    """Thread-safe serving metrics shared by the batchers and the Server."""

    def __init__(self, buckets=()):
        self._lock = threading.Lock()
        self._domain = profiler.Domain("serving")
        self.queue_depth = self._domain.new_counter("queue_depth", 0)
        self.recompiles = self._domain.new_counter("recompiles", 0)
        self._lat_ms = {int(b): deque(maxlen=_WINDOW) for b in buckets}
        self._tier_lat_ms = {}          # tier name -> latency deque
        self._shed_by_tier = {}         # tier name -> shed count
        self._fill = deque(maxlen=_WINDOW)
        self._t0 = time.monotonic()
        self.requests_total = 0
        self.rejected_total = 0
        self.batches_total = 0
        self.errors_total = 0
        self.shed_total = 0
        self.swept_total = 0
        self.degraded_total = 0
        self.swaps_total = 0
        self._depth = 0
        self.queue_depth_peak = 0

    # -- recording ---------------------------------------------------------
    def on_submit(self):
        with self._lock:
            self.requests_total += 1
            self._depth += 1
            if self._depth > self.queue_depth_peak:
                self.queue_depth_peak = self._depth
        self.queue_depth.increment()

    def on_reject(self):
        with self._lock:
            self.rejected_total += 1

    def on_shed(self, tier, swept=False):
        """One request shed by admission control (tier-confined load
        shedding: shed-at-admit, eviction, or the worker sweep)."""
        with self._lock:
            self.shed_total += 1
            if swept:
                self.swept_total += 1
            self._shed_by_tier[str(tier)] = \
                self._shed_by_tier.get(str(tier), 0) + 1

    def on_degraded(self):
        """One request rerouted to the registered cheaper variant."""
        with self._lock:
            self.degraded_total += 1

    def on_swap(self):
        with self._lock:
            self.swaps_total += 1

    def on_dequeue(self, n=1):
        with self._lock:
            self._depth = max(0, self._depth - n)
        self.queue_depth.decrement(n)

    def on_batch(self, bucket, n_real, latencies_ms, error=False, tiers=()):
        """One executed batch: ``bucket`` padded size, ``n_real`` requests
        in it, per-request end-to-end latencies (``tiers`` aligned with
        ``latencies_ms`` when given)."""
        with self._lock:
            self.batches_total += 1
            if error:
                self.errors_total += n_real
            if bucket:
                self._fill.append(n_real / float(bucket))
                lat = self._lat_ms.setdefault(int(bucket),
                                              deque(maxlen=_WINDOW))
                lat.extend(latencies_ms)
                for t, ms in zip(tiers, latencies_ms):
                    self._tier_lat_ms.setdefault(
                        str(t), deque(maxlen=_WINDOW)).append(ms)

    def set_recompiles(self, n):
        if n != self.recompiles._value:
            self.recompiles.set_value(n)

    # -- reporting ---------------------------------------------------------
    def latency_ms(self, bucket=None):
        """(p50, p99) over one bucket, or over all buckets when None."""
        with self._lock:
            if bucket is None:
                samples = [s for d in self._lat_ms.values() for s in d]
            else:
                samples = list(self._lat_ms.get(int(bucket), ()))
        return percentile(samples, 50), percentile(samples, 99)

    def batch_fill_ratio(self):
        with self._lock:
            return (sum(self._fill) / len(self._fill)) if self._fill else 0.0

    def tier_latency_ms(self, tier):
        """(p50, p99) over one tier's served requests."""
        with self._lock:
            samples = list(self._tier_lat_ms.get(str(tier), ()))
        return percentile(samples, 50), percentile(samples, 99)

    def shed_rate(self):
        """Fraction of arriving requests shed by admission control
        (shed / (admitted + shed))."""
        with self._lock:
            arrived = self.requests_total + self.shed_total
            return (self.shed_total / float(arrived)) if arrived else 0.0

    def as_dict(self):
        p50, p99 = self.latency_ms()
        with self._lock:
            per_bucket = {}
            for b, d in sorted(self._lat_ms.items()):
                samples = list(d)
                per_bucket[str(b)] = {
                    "count": len(samples),
                    "p50_ms": round(percentile(samples, 50), 3),
                    "p99_ms": round(percentile(samples, 99), 3),
                }
            per_tier = {}
            for t in sorted(set(self._tier_lat_ms) | set(self._shed_by_tier)):
                samples = list(self._tier_lat_ms.get(t, ()))
                per_tier[t] = {
                    "count": len(samples),
                    "p50_ms": round(percentile(samples, 50), 3),
                    "p99_ms": round(percentile(samples, 99), 3),
                    "shed": self._shed_by_tier.get(t, 0),
                }
            out = {
                "uptime_s": round(time.monotonic() - self._t0, 3),
                "requests_total": self.requests_total,
                "rejected_total": self.rejected_total,
                "batches_total": self.batches_total,
                "errors_total": self.errors_total,
                "shed_total": self.shed_total,
                "swept_total": self.swept_total,
                "degraded_total": self.degraded_total,
                "swaps_total": self.swaps_total,
                "queue_depth": self.queue_depth._value,
                "queue_depth_peak": self.queue_depth_peak,
                "recompiles": self.recompiles._value,
                "p50_ms": round(p50, 3),
                "p99_ms": round(p99, 3),
                "buckets": per_bucket,
                "tiers": per_tier,
            }
        out["batch_fill_ratio"] = round(self.batch_fill_ratio(), 4)
        out["shed_rate"] = round(self.shed_rate(), 4)
        return out
