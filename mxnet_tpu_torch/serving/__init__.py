"""mxnet_tpu_torch.serving — the port of ``mxnet_tpu.serving``.

- :class:`~mxnet_tpu_torch.serving.decode.DecodeRunner` — the paged
  KV-cache prefill/decode ladder on one device;
- :class:`~mxnet_tpu_torch.serving.decode.DecodeBatcher` — continuous
  batching with tokens-remaining SLO arithmetic;
- :class:`~mxnet_tpu_torch.serving.runner.ModelRunner` — a bound Module
  behind fixed padded batch buckets (the ``POST /predict`` route);
- :class:`~mxnet_tpu_torch.serving.batcher.Batcher` — the deadline-aware
  batcher for fixed-shape runners;
- :class:`~mxnet_tpu_torch.serving.fleet.ModelFleet` — named models,
  packing, breakers, fallback and drain;
- :class:`~mxnet_tpu_torch.serving.server.Server` — the HTTP front end
  (``/decode``, ``/predict``, ``/healthz``, ``/livez``, ``/readyz``,
  ``/stats``, ``/metrics``);
- ``serving.quantize`` — :func:`ptq_quantize_module`, int8 PTQ of a
  Module checkpoint.
"""
from __future__ import annotations

from .batcher import (Batcher, ServerBusy, Draining, RequestShed,
                      TIERS, DEFAULT_TIER, tier_rank, tier_name)
from .fleet import ModelFleet, CircuitBreaker, BreakerOpen, UnknownModel
from .server import Server
from .stats import ServingStats, percentile
from .decode import (PagePool, NoPagesFree, DecodeRunner, DecodeBatcher,
                     DecodeStats)
from .runner import ModelRunner, DEFAULT_BUCKETS

__all__ = ["Batcher", "ServerBusy", "Draining", "RequestShed", "TIERS",
           "DEFAULT_TIER", "tier_rank", "tier_name", "ModelFleet",
           "CircuitBreaker", "BreakerOpen", "UnknownModel", "Server",
           "ServingStats", "percentile", "PagePool", "NoPagesFree",
           "DecodeRunner", "DecodeBatcher", "DecodeStats", "ModelRunner",
           "DEFAULT_BUCKETS"]
