"""KVStore server entry point: the port of ``mxnet_tpu/kvstore_server.py``
(reference: python/mxnet/kvstore_server.py, the process ps-lite spawns
with ``DMLC_ROLE=server`` running the optimizer).

The synchronous types need no server (``dist_sync`` sums over
``torch.distributed``, kvstore.py).  Two server shapes remain, both host
roles by design:

- ``dist_async``'s rank-0-embedded ``PSServer`` thread (kvstore.py
  ``_start_ps``);
- a **standalone** PS process for launchers that spawn a dedicated
  server rank: ``DMLC_ROLE=server`` + ``MXTPU_PS_PORT`` makes
  :func:`_init_kvstore_server_module` host a ``PSServer`` with the
  elasticity tier armed (heartbeat watchdog, dead-worker key
  reassignment, bounded staleness) and block until SIGTERM/SIGINT, which
  flush a final snapshot.  A server or scheduler role with only the
  legacy ``DMLC_PS_ROOT_URI`` set exits at once (the collective types
  have nothing for it to do).
"""
from __future__ import annotations

import os
import signal
import sys
import threading

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


def _elasticity_env():
    """(heartbeat_timeout_s, max_staleness) from the MXTPU_* env knobs —
    the same knobs kvstore.py's embedded server reads."""
    hb_interval = float(os.environ.get("MXTPU_HEARTBEAT_INTERVAL_S", "2.0"))
    hb_timeout = float(os.environ.get("MXTPU_HEARTBEAT_TIMEOUT_S",
                                      str(hb_interval * 5)))
    staleness = os.environ.get("MXTPU_MAX_STALENESS")
    return (hb_timeout if hb_interval > 0 else None,
            int(staleness) if staleness else None)


def _durability_env():
    """(state_dir, snapshot_every, snapshot_keep) from the MXTPU_* env
    knobs.  With a state dir but no explicit cadence, snapshot every 100
    applied pushes — the WAL between snapshots stays a few MB for
    typical keys and replay is milliseconds."""
    state_dir = os.environ.get("MXTPU_PS_STATE_DIR") or None
    every = os.environ.get("MXTPU_PS_SNAPSHOT_EVERY")
    keep = int(os.environ.get("MXTPU_PS_SNAPSHOT_KEEP", "3"))
    if every:
        every = int(every)
    else:
        every = 100 if state_dir else None
    return state_dir, every, keep


def _serve_ps(port, num_workers):
    """Host a standalone PSServer until SIGTERM/SIGINT.

    The wait loop is bounded (Event.wait with a timeout), so a missed
    signal can never wedge the process beyond one poll interval after
    ``stop`` is set some other way.  Shutdown is graceful: the signal
    flushes one final snapshot before exit, so a drained server never
    leans on WAL replay, and a SIGKILLed one recovers through it
    (``MXTPU_CHAOS`` faults are armed here so the chaos harness can
    schedule exactly that kill)."""
    from . import kvstore_ps
    from .resilience import chaos as _chaos
    _chaos.install_from_env()
    hb_timeout, max_staleness = _elasticity_env()
    state_dir, snapshot_every, keep = _durability_env()
    server = kvstore_ps.PSServer(port=port, num_workers=num_workers,
                                 heartbeat_timeout_s=hb_timeout,
                                 max_staleness=max_staleness,
                                 state_dir=state_dir,
                                 snapshot_every=snapshot_every,
                                 snapshot_keep=keep)
    print("mxnet_tpu_torch: standalone PS serving on port %d, on the host "
          "by design (workers=%d, heartbeat_timeout=%s, max_staleness=%s, "
          "state_dir=%s, generation=%d, recovered_wal=%d, "
          "recovery_s=%.6f)"
          % (server.port, num_workers, hb_timeout, max_staleness,
             state_dir, server.generation, server.recovered_wal_records,
             server.recovery_replay_s),
          file=sys.stderr)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:  # non-main thread (tests)
            break
    while not stop.wait(0.5):
        pass
    server.stop(final_snapshot=True)


class KVStoreServer:
    def __init__(self, kvstore):
        self.kvstore = kvstore
        self.handle = kvstore

    def run(self):
        """Host the standalone PS when the launcher env asks for one;
        otherwise return immediately (collectives have no server loop)."""
        port = int(os.environ.get("MXTPU_PS_PORT", "0"))
        if os.environ.get("DMLC_ROLE") == "server" and port:
            _serve_ps(port, int(os.environ.get("DMLC_NUM_WORKER", "1")))
        return


def _init_kvstore_server_module():
    """Explicit entry for launcher scripts (NOT run at import: a stray
    exported DMLC_ROLE must not kill every `import mxnet_tpu_torch`).

    - role=server + MXTPU_PS_PORT: host the standalone elastic PS until
      signalled, then exit 0;
    - role=server/scheduler + DMLC_PS_ROOT_URI (legacy ps-lite spawn):
      nothing to do, exit 0."""
    role = os.environ.get("DMLC_ROLE", "worker")
    port = int(os.environ.get("MXTPU_PS_PORT", "0"))
    if role == "server" and port:
        _serve_ps(port, int(os.environ.get("DMLC_NUM_WORKER", "1")))
        sys.exit(0)
    if role in ("server", "scheduler") and os.environ.get("DMLC_PS_ROOT_URI"):
        print("mxnet_tpu_torch: '%s' role has no work (the synchronous "
              "stores reduce over torch.distributed); exiting" % role,
              file=sys.stderr)
        sys.exit(0)
