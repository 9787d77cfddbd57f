"""HTTP front end: /predict with multi-model routing and SLO tiers,
/healthz, /livez, /readyz (per-model), /stats.

The port of ``mxnet_tpu/serving/server.py``: stdlib ``http.server`` over
a :class:`~mxnet_tpu_torch.serving.fleet.ModelFleet` (bounded, blocking,
per-connection threads).  A bare fixed-shape runner is accepted too and
wrapped as a one-model fleet named ``default``.  Contract:

- ``POST /predict``  body ``{"data": <nested list>, "model": <name>,
  "tier": "gold"|"silver"|"bronze", "deadline_ms": <number>}`` (model/
  tier/deadline optional — defaults: the fleet's default model, gold, no
  deadline).  ``data`` is one example when the shape matches the routed
  model's ``example_shape``, else a batch of examples (each coalesced
  independently).  200 → ``{"outputs": ..., "model": name}``.
- ``POST /decode``  body ``{"prompt": [token ids], "model": <name>,
  "max_new_tokens": <int>, "tier": ..., "deadline_ms": ...}`` against a
  registered :class:`~mxnet_tpu_torch.serving.decode.DecodeRunner` — 200 →
  ``{"tokens": [...], "model": name}``; 400 when the routed model is
  fixed-shape.  Refusal codes match ``/predict``.
- ``429`` + ``Retry-After`` when the admission queue is full
  (backpressure), ``503`` + ``Retry-After`` when admission control sheds
  the request (modeled queue wait past its deadline, eviction by a
  higher tier, or an open circuit breaker) or while draining, ``404`` on
  an unknown model, ``400`` on malformed bodies, ``413`` when the body
  exceeds ``max_body_bytes`` (the handler never buffers an unbounded
  POST), ``500`` on model errors.
- ``GET /livez`` — liveness alone: 200 while the process serves HTTP at
  all (the restart signal).  ``GET /readyz`` — the routing signal, now
  per-model: 503 with ``{"unready": {model: reason}}`` until every
  registered model is warm, its breaker closed, and nothing is stalled
  or draining.  ``GET /healthz`` keeps the readiness-gated summary.
- ``GET /stats`` — the default model's ServingStats dict (back-compat
  flat keys) plus ``models`` with every model's stats, breaker state,
  per-tier p50/p99/shed, modeled memory packing ledger and swap blips.
- ``GET /metrics`` — the process-wide telemetry registry in Prometheus
  text exposition format (``text/plain; version=0.0.4``): the same
  serving numbers as gauges plus every other registered source.
- ``drain()`` — stop admissions, finish all in-flight requests, then
  stop the listener (graceful shutdown).  Honors a hard deadline
  (``drain_timeout_s``).

All latency/drain arithmetic is ``time.monotonic()``-based (audited: no
wall-clock ``time.time()`` in the serving path — an NTP step must never
expire a deadline or a drain early).
"""
from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as _np

from ..base import MXNetError
from .batcher import Draining, RequestShed, ServerBusy, tier_rank
from .fleet import BreakerOpen, ModelFleet, UnknownModel

__all__ = ["Server"]

# bound on request bodies the handler will buffer; an oversized POST gets
# 413 without reading the payload (OOM-proofing the handler thread)
DEFAULT_MAX_BODY_BYTES = 16 << 20


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # the stdlib default TCP accept backlog is 5: a modest connection
    # burst (tens of clients dialing at once) gets kernel-level RSTs
    # before the app ever sees the requests.  Admission control belongs
    # to the Batcher's bounded queue (429), not the SYN queue.
    request_queue_size = 128


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "mxtpu-serving/0.2"

    # the Server instance is attached to the HTTPServer as `.serving`
    @property
    def _srv(self):
        return self.server.serving

    def log_message(self, fmt, *args):  # quiet by default
        if self._srv.verbose:
            super().log_message(fmt, *args)

    def _reply(self, code, payload, headers=()):
        body = json.dumps(payload).encode()
        self._reply_raw(code, body, "application/json", headers)

    def _reply_raw(self, code, body, content_type, headers=()):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        srv = self._srv
        if self.path == "/healthz":
            body = {"status": srv.status, "alive": True, "ready": srv.ready,
                    # the hello-path provenance surface: which checkpoint
                    # bytes each model serves (digest or null) — the
                    # quick answer to "what is live right now?"
                    "provenance": srv.fleet.provenance_digests()}
            self._reply(200 if srv.ready else 503, body)
        elif self.path == "/livez":
            # liveness: answering at all IS the signal — never 503 here,
            # or a fleet manager would restart a server that is merely
            # warming/draining/tripped
            self._reply(200, {"alive": True})
        elif self.path == "/readyz":
            # the routing signal, per-model: a fleet scheduler must not
            # send traffic while any registered model is cold, tripped,
            # stalled or draining — but must not restart the process
            unready = srv.fleet.unready()
            if srv.draining:
                unready = dict(unready, **{
                    m: "draining" for m in srv.fleet.models()
                    if m not in unready})
            ready = not unready and not srv.draining
            body = {"ready": ready, "status": srv.status}
            if unready:   # per-model detail only when something is wrong
                body["unready"] = unready
            self._reply(200 if ready else 503, body)
        elif self.path == "/stats":
            fleet_stats = srv.fleet.stats_dict()
            # back-compat flat surface: the default model's numbers at
            # the top level, exactly what single-model dashboards read
            default = srv.fleet.entry()
            stats = default.batcher.stats.as_dict()
            stats["recompiles"] = default.runner.recompiles_since_warmup()
            stats["buckets_configured"] = list(default.runner.buckets)
            # a runner's static per-bucket cost model, when it declares
            # one (decode runners price admission by pages instead)
            if hasattr(default.runner, "modeled_cost"):
                stats["modeled_cost"] = {
                    str(b): row
                    for b, row in
                    sorted(default.runner.modeled_cost().items())}
            stats.update(fleet_stats)
            self._reply(200, stats)
        elif self.path == "/metrics":
            # the one-pane scrape surface: the process-wide telemetry
            # registry (serving stats, breakers, pipeline/dispatch
            # counters, PS gauges — whatever registered) in Prometheus
            # text exposition format
            from .. import telemetry as _tele
            self._reply_raw(200, _tele.registry().prometheus_text()
                            .encode(), "text/plain; version=0.0.4")
        else:
            self._reply(404, {"error": "unknown path %s" % self.path})

    def do_POST(self):
        if self.path not in ("/predict", "/decode"):
            self._reply(404, {"error": "unknown path %s" % self.path})
            return
        srv = self._srv
        try:
            n = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            self._reply(400, {"error": "bad Content-Length"})
            return
        if n > srv.max_body_bytes:
            # refuse BEFORE reading: an unbounded read here is how an
            # oversized POST OOMs the handler thread.  The unread body
            # makes the connection unreusable — close it.
            self.close_connection = True
            self._reply(413, {
                "error": "request body %d bytes exceeds the %d-byte cap"
                         % (n, srv.max_body_bytes)},
                headers=[("Connection", "close")])
            return
        try:
            payload = json.loads(self.rfile.read(n) or b"{}")
        except ValueError as e:
            self._reply(400, {"error": "bad request: %s" % e})
            return
        if self.path == "/decode":
            self._do_decode(payload)
            return
        try:
            data = _np.asarray(payload["data"], dtype=_np.float64)
            model = payload.get("model")
            tier = payload.get("tier", "gold")
            deadline_ms = payload.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)
            tier_rank(tier)  # validate before routing: bad tier is a 400
        except (ValueError, KeyError, TypeError, MXNetError) as e:
            self._reply(400, {"error": "bad request: %s" % e})
            return
        try:
            entry = srv.fleet.entry(model)
        except UnknownModel as e:
            self._reply(404, {"error": str(e)})
            return
        if getattr(entry.runner, "example_shape", None) is None:
            # decode runners take variable-length token prompts, not
            # fixed-shape examples — route them to /decode
            self._reply(400, {
                "error": "model %r is an autoregressive decode model; "
                         "POST /decode" % entry.name})
            return
        example_shape = tuple(entry.runner.example_shape)
        single = data.shape == example_shape
        batch = data[None] if single else data
        if batch.ndim != len(example_shape) + 1 or \
                batch.shape[1:] != example_shape:
            self._reply(400, {
                "error": "shape %r does not match model %r example_shape "
                         "%r" % (data.shape, entry.name, example_shape)})
            return
        try:
            pending = [srv.fleet.submit(row, model=entry.name, tier=tier,
                                        deadline_ms=deadline_ms)
                       for row in batch]
            outs = [p.result(srv.request_timeout_s) for p in pending]
        except ServerBusy as e:
            self._reply(429, {"error": str(e)},
                        headers=[("Retry-After", "1")])
            return
        except (RequestShed, BreakerOpen) as e:
            retry = max(1, int(math.ceil(getattr(e, "retry_after_s", 1.0))))
            self._reply(503, {"error": str(e),
                              "tier": getattr(e, "tier", tier)},
                        headers=[("Retry-After", str(retry))])
            return
        except Draining as e:
            self._reply(503, {"error": str(e)})
            return
        except Exception as e:  # model error / timeout
            self._reply(500, {"error": str(e)[:500]})
            return
        out = _np.stack(outs)
        self._reply(200, {"outputs": (out[0] if single else out).tolist(),
                          "model": entry.name})

    def _do_decode(self, payload):
        """``POST /decode`` — the autoregressive route: ``{"prompt":
        [token ids], "model": <name>, "max_new_tokens": <int>, "tier":
        ..., "deadline_ms": ...}`` → 200 ``{"tokens": [...], "model":
        name}``.  Same refusal surface as ``/predict`` (429 queue-full,
        503 shed/breaker/draining, 404 unknown model) plus 400 when the
        routed model is a fixed-shape one — decode requests only make
        sense against a registered DecodeRunner."""
        srv = self._srv
        try:
            prompt = _np.asarray(payload["prompt"], dtype=_np.int32)
            if prompt.ndim != 1 or prompt.size < 1:
                raise ValueError("prompt must be a non-empty 1-D "
                                 "token-id list")
            model = payload.get("model")
            tier = payload.get("tier", "gold")
            max_new = int(payload.get("max_new_tokens", 16))
            deadline_ms = payload.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)
            tier_rank(tier)
        except (ValueError, KeyError, TypeError) as e:
            self._reply(400, {"error": "bad request: %s" % e})
            return
        try:
            entry = srv.fleet.entry(model)
        except UnknownModel as e:
            self._reply(404, {"error": str(e)})
            return
        try:
            out = srv.fleet.decode(prompt, model=entry.name,
                                   max_new_tokens=max_new,
                                   timeout=srv.request_timeout_s,
                                   tier=tier, deadline_ms=deadline_ms)
        except ServerBusy as e:
            self._reply(429, {"error": str(e)},
                        headers=[("Retry-After", "1")])
            return
        except (RequestShed, BreakerOpen) as e:
            retry = max(1, int(math.ceil(getattr(e, "retry_after_s", 1.0))))
            self._reply(503, {"error": str(e),
                              "tier": getattr(e, "tier", tier)},
                        headers=[("Retry-After", str(retry))])
            return
        except Draining as e:
            self._reply(503, {"error": str(e)})
            return
        except MXNetError as e:
            # a fixed-shape model on the decode route (or vice versa)
            self._reply(400, {"error": str(e)})
            return
        except Exception as e:  # model error / timeout
            self._reply(500, {"error": str(e)[:500]})
            return
        self._reply(200, {"tokens": _np.asarray(out).tolist(),
                          "model": entry.name})


class Server:
    """Ties Fleet (or a single Runner) + HTTP listener into one serving
    process.  With a bare runner, ``max_batch``/``batch_timeout_ms``/
    ``max_queue`` configure its batcher exactly as before; with a
    pre-built :class:`ModelFleet` those knobs live on the fleet's
    registrations and are ignored here."""

    def __init__(self, model, host="127.0.0.1", port=8080, max_batch=None,
                 batch_timeout_ms=2.0, max_queue=256,
                 request_timeout_s=30.0, drain_timeout_s=60.0,
                 max_body_bytes=DEFAULT_MAX_BODY_BYTES, verbose=False):
        if isinstance(model, ModelFleet):
            self.fleet = model
        else:
            self.fleet = ModelFleet(batch_timeout_ms=batch_timeout_ms,
                                    max_queue=max_queue)
            self.fleet.register("default", model, max_batch=max_batch)
        self.request_timeout_s = float(request_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.max_body_bytes = int(max_body_bytes)
        self.verbose = verbose
        self._httpd = _HTTPServer((host, port), _Handler)
        self._httpd.serving = self
        self._thread = None
        self._drained = False
        self.drain_forced = False

    # single-model surface: the default model's runner/batcher,
    # following hot swaps
    @property
    def runner(self):
        return self.fleet.entry().runner

    @property
    def batcher(self):
        return self.fleet.entry().batcher

    @property
    def address(self):
        """(host, port) actually bound — port 0 resolves to a real one."""
        return self._httpd.server_address[:2]

    @property
    def draining(self):
        return self.fleet.draining

    @property
    def ready(self):
        """Readiness: every registered model warm, breaker closed, not
        stalled, and nothing draining — the per-model liveness/readiness
        split ``/readyz`` serves."""
        return not self.draining and self.fleet.ready

    @property
    def status(self):
        if self.draining:
            return "draining"
        return "ok" if self.ready else "warming"

    def start(self):
        """Serve in a background thread; returns the bound (host, port)."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
                name="mxtpu-http", daemon=True)
            self._thread.start()
        return self.address

    def serve_forever(self):
        """Foreground serve."""
        self._httpd.serve_forever(poll_interval=0.1)

    def drain(self, timeout=None):
        """Graceful shutdown with a hard deadline: new requests get 503
        and everything already admitted completes — but only for
        ``drain_timeout_s`` (or ``timeout``).  Past the deadline the
        remaining queues are failed with 503s and the listener stops
        anyway (``drain_forced`` records it): shutdown always finishes.
        Returns True for a clean drain, False when forced."""
        timeout = self.drain_timeout_s if timeout is None else float(timeout)
        try:
            self.fleet.drain(timeout=timeout)
        except TimeoutError:
            self.fleet.force_drain()
            self.drain_forced = True
        if not self._drained:
            self._drained = True
            # shutdown() blocks until serve_forever exits; in-flight
            # handler threads (daemon, already answered by the drained
            # batcher) finish their writes independently
            threading.Thread(target=self._httpd.shutdown,
                             daemon=True).start()
            if self._thread is not None:
                self._thread.join(timeout=5.0)
            self._httpd.server_close()
        return not self.drain_forced

    stop = drain
