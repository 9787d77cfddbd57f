"""mxnet_tpu_torch.telemetry — the metrics pillar of ``mxnet_tpu.telemetry``.

What the serving path needs: the process-wide :func:`registry` that the
fleet's collector and the ``/metrics`` route read, and
:func:`fault_event`, which ``resilience/chaos.py`` calls for every fault
it fires.  The trace contexts, the flight recorder and the performance
doctor of the JAX package are not ported yet (ROADMAP.md queue A, item
A12).
"""
from __future__ import annotations

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      SCHEMA_VERSION, flatten_samples, registry)

__all__ = ["registry", "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "SCHEMA_VERSION", "flatten_samples", "fault_event"]


def fault_event(site, at, action, ctx=None):
    """Count one fired chaos fault by site and action
    (``mxtpu_chaos_faults_total``), before its action runs."""
    registry().counter("mxtpu_chaos_faults_total",
                       "chaos faults fired by site").inc(site=site,
                                                         action=action)
