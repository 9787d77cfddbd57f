"""Process-wide metrics registry with Prometheus text export.

The PyTorch port's copy of ``mxnet_tpu/telemetry/metrics.py``: one
registry every stat source registers into, scraped two ways —

- :meth:`MetricsRegistry.prometheus_text` renders the standard
  ``text/plain; version=0.0.4`` exposition format the serving ``/metrics``
  route returns (counters, gauges, and histograms-as-summaries with
  p50/p99 quantile rows);
- :meth:`MetricsRegistry.to_json` renders a versioned JSON document
  (``schema_version`` pinned).

Two registration styles:

- **owned instruments**: ``registry().counter(name)`` / ``.gauge(name)``
  / ``.histogram(name)`` return live objects the caller mutates
  (``inc``/``set``/``observe``), optionally per label set;
- **collectors**: ``registry().register_collector(fn)`` polls an existing
  stat surface lazily at scrape time — ``fn`` returns an iterable of
  ``(name, labels_dict, value)`` samples (or a flat ``{name: value}``
  dict).  Bound methods are held through ``weakref.WeakMethod`` so a
  dead stats object silently drops out of the scrape instead of leaking.

Stdlib only (no torch, no numpy, no package-relative imports).
"""
from __future__ import annotations

import json
import math
import threading
import time
import weakref
from collections import deque

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
           "SCHEMA_VERSION", "flatten_samples"]

# bump when the JSON dump layout changes
SCHEMA_VERSION = 1

# bounded reservoir per histogram label set: enough for stable p50/p99,
# small enough that a process with hundreds of histograms stays light
DEFAULT_RESERVOIR = 1024


def _percentile(samples, q):
    """Nearest-rank percentile (mirrors serving.stats.percentile; kept
    local so this module stays import-free)."""
    data = sorted(samples)
    if not data:
        return 0.0
    rank = max(0, min(len(data) - 1,
                      int(round(q / 100.0 * (len(data) - 1)))))
    return data[rank]


def _label_key(labels):
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Shared base: one named metric, one value cell per label set."""

    kind = "untyped"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._cells = {}          # label_key -> value

    def samples(self):
        with self._lock:
            return [(dict(k), v) for k, v in self._cells.items()]


class Counter(_Metric):
    """Monotonic counter; ``inc`` only (Prometheus counter semantics)."""

    kind = "counter"

    def inc(self, delta=1, **labels):
        if delta < 0:
            raise ValueError("counter can only increase")
        key = _label_key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0) + delta

    def value(self, **labels):
        with self._lock:
            return self._cells.get(_label_key(labels), 0)


class Gauge(_Metric):
    """Set-to-current-value instrument."""

    kind = "gauge"

    def set(self, value, **labels):
        with self._lock:
            self._cells[_label_key(labels)] = float(value)

    def inc(self, delta=1, **labels):
        key = _label_key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0.0) + delta

    def value(self, **labels):
        with self._lock:
            return self._cells.get(_label_key(labels), 0.0)


class Histogram(_Metric):
    """Bounded-reservoir distribution: exact count/sum plus p50/p99 over
    the newest ``reservoir`` observations (old samples age out, so the
    quantiles track recent behaviour — the ServingStats window
    discipline).  Exported as a Prometheus *summary* (quantile rows)."""

    kind = "histogram"

    def __init__(self, name, help="", reservoir=DEFAULT_RESERVOIR):
        super().__init__(name, help)
        self._reservoir = int(reservoir)

    def observe(self, value, **labels):
        key = _label_key(labels)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = {
                    "count": 0, "sum": 0.0,
                    "window": deque(maxlen=self._reservoir)}
            cell["count"] += 1
            cell["sum"] += float(value)
            cell["window"].append(float(value))

    def quantiles(self, **labels):
        """(p50, p99) over the reservoir for one label set."""
        with self._lock:
            cell = self._cells.get(_label_key(labels))
            window = list(cell["window"]) if cell else ()
        return _percentile(window, 50), _percentile(window, 99)

    def samples(self):
        with self._lock:
            out = []
            for k, cell in self._cells.items():
                window = list(cell["window"])
                out.append((dict(k), {
                    "count": cell["count"],
                    "sum": cell["sum"],
                    "p50": _percentile(window, 50),
                    "p99": _percentile(window, 99),
                }))
            return out


def flatten_samples(prefix, data, labels=None):
    """Flatten a nested stats dict into ``(name, labels, value)`` samples.

    Numeric leaves become gauges named ``prefix_path_to_leaf``; bools map
    to 0/1; strings and Nones are skipped (a collector that wants a
    string state exported maps it to an enum itself).  The bridge from
    ``snapshot()``/``as_dict()`` surfaces to the registry."""
    labels = dict(labels or {})
    out = []
    for key, value in data.items():
        name = "%s_%s" % (prefix, str(key).replace(".", "_"))
        if isinstance(value, dict):
            out.extend(flatten_samples(name, value, labels))
        elif isinstance(value, bool):
            out.append((name, labels, 1.0 if value else 0.0))
        elif isinstance(value, (int, float)) and not isinstance(value, bool):
            if isinstance(value, float) and not math.isfinite(value):
                continue
            out.append((name, labels, value))
    return out


class MetricsRegistry:
    """Name -> metric map plus lazily-polled collectors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}        # name -> _Metric
        self._collectors = {}     # id -> (name, callable-or-weakmethod)
        self._next_collector = 0

    # -- owned instruments -------------------------------------------------
    def _get_or_create(self, cls, name, help, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kwargs)
            elif not isinstance(m, cls):
                raise ValueError(
                    "metric %r already registered as %s, not %s"
                    % (name, m.kind, cls.kind))
            return m

    def counter(self, name, help=""):
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="", reservoir=DEFAULT_RESERVOIR):
        return self._get_or_create(Histogram, name, help,
                                   reservoir=reservoir)

    # -- collectors --------------------------------------------------------
    def register_collector(self, fn, name=None):
        """Poll ``fn`` at every scrape.  A bound method is held weakly:
        when its object dies the collector is dropped automatically (stat
        surfaces are created per server/fleet/pipeline instance and must
        not be kept alive by the registry).  Returns a handle for
        :meth:`unregister_collector`."""
        ref = fn
        if hasattr(fn, "__self__"):
            ref = weakref.WeakMethod(fn)
        with self._lock:
            handle = self._next_collector
            self._next_collector += 1
            self._collectors[handle] = (name or getattr(fn, "__qualname__",
                                                        "collector"), ref)
        return handle

    def unregister_collector(self, handle):
        with self._lock:
            self._collectors.pop(handle, None)

    def _collected(self):
        """Run every live collector; a raising or dead collector is
        skipped (one broken stat source must not take down /metrics)."""
        with self._lock:
            items = list(self._collectors.items())
        out, dead = [], []
        for handle, (name, ref) in items:
            fn = ref() if isinstance(ref, weakref.WeakMethod) else ref
            if fn is None:
                dead.append(handle)
                continue
            try:
                produced = fn()
            except Exception:
                continue
            if produced is None:
                continue
            if isinstance(produced, dict):
                produced = [(k, {}, v) for k, v in produced.items()]
            for sample in produced:
                sname, labels, value = sample
                if isinstance(value, bool):
                    value = 1.0 if value else 0.0
                if isinstance(value, (int, float)):
                    out.append((str(sname), dict(labels or {}), value))
        if dead:
            with self._lock:
                for handle in dead:
                    self._collectors.pop(handle, None)
        return out

    # -- export ------------------------------------------------------------
    def prometheus_text(self):
        """The standard exposition format (``text/plain; version=0.0.4``):
        HELP/TYPE headers, one line per (metric, label set); histograms
        rendered as summaries with p50/p99 quantile rows."""
        lines = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, metric in metrics:
            if metric.help:
                lines.append("# HELP %s %s"
                             % (name, metric.help.replace("\n", " ")))
            if isinstance(metric, Histogram):
                lines.append("# TYPE %s summary" % name)
                for labels, cell in metric.samples():
                    for q, key in (("0.5", "p50"), ("0.99", "p99")):
                        lines.append("%s %s" % (
                            _fmt_name(name, dict(labels, quantile=q)),
                            _fmt_value(cell[key])))
                    lines.append("%s %s" % (_fmt_name(name + "_count",
                                                      labels),
                                            _fmt_value(cell["count"])))
                    lines.append("%s %s" % (_fmt_name(name + "_sum", labels),
                                            _fmt_value(cell["sum"])))
            else:
                lines.append("# TYPE %s %s" % (name, metric.kind))
                for labels, value in metric.samples():
                    lines.append("%s %s" % (_fmt_name(name, labels),
                                            _fmt_value(value)))
        collected = {}
        for sname, labels, value in self._collected():
            collected.setdefault(sname, []).append((labels, value))
        for sname in sorted(collected):
            lines.append("# TYPE %s gauge" % sname)
            for labels, value in collected[sname]:
                lines.append("%s %s" % (_fmt_name(sname, labels),
                                        _fmt_value(value)))
        return "\n".join(lines) + "\n"

    def to_json(self, source="mxnet_tpu_torch"):
        """Versioned JSON dump of everything a scrape would see;
        ``schema_version`` is the compatibility contract."""
        metrics = {}
        with self._lock:
            owned = sorted(self._metrics.items())
        for name, metric in owned:
            if isinstance(metric, Histogram):
                samples = [{"labels": labels, **cell}
                           for labels, cell in metric.samples()]
            else:
                samples = [{"labels": labels, "value": value}
                           for labels, value in metric.samples()]
            metrics[name] = {"type": metric.kind, "samples": samples}
        for sname, labels, value in self._collected():
            entry = metrics.setdefault(sname, {"type": "gauge",
                                               "samples": []})
            entry["samples"].append({"labels": labels, "value": value})
        return {
            "schema_version": SCHEMA_VERSION,
            "source": source,
            "wall_time_s": time.time(),
            "metrics": metrics,
        }

    def dump_json(self, path, source="mxnet_tpu_torch", extra=None):
        """Write :meth:`to_json` (plus ``extra`` top-level keys) to
        ``path``; returns the payload."""
        payload = self.to_json(source=source)
        if extra:
            payload.update(extra)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        return payload

    def reset(self):
        """Drop every metric and collector (test isolation)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()


def _fmt_name(name, labels):
    if not labels:
        return name
    body = ",".join('%s="%s"' % (k, _escape(v))
                    for k, v in sorted(labels.items()))
    return "%s{%s}" % (name, body)


def _escape(v):
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n",
                                                                   r"\n")


def _fmt_value(v):
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if not isinstance(v, float) else ("%g" % v)


_REGISTRY = MetricsRegistry()


def registry():
    """The process-wide registry every stat source registers into."""
    return _REGISTRY
