"""Fault injection, retry policy, checkpoints and the parameter server's
liveness and durability of the port (host-only), as
``mxnet_tpu/resilience/__init__.py`` exports them:

- :mod:`.chaos`: deterministic fault injection at named probe sites;
- :mod:`.backoff`: the shared exponential-backoff-with-jitter policy;
- :mod:`.checkpoint`: atomic snapshots, sharded ZeRO-1 snapshots with
  resize-on-resume;
- :mod:`.heartbeat`: worker heartbeats and the server-side watchdog;
- :mod:`.server_state`: the parameter server's snapshots + write-ahead
  log.

The elastic supervisor (``supervisor.py``) is ROADMAP.md queue A, item
A12.
"""
from . import backoff, chaos, checkpoint, heartbeat, server_state
from .backoff import BackoffPolicy, RetriesExhausted, retry_call
from .chaos import (ChaosError, ChaosSchedule, Fault, install,
                    install_from_env, maybe_inject, triggered, uninstall)
from .checkpoint import (ShardIntegrityError, latest_checkpoint,
                         latest_sharded_checkpoint, list_checkpoints,
                         load_checkpoint, load_sharded_checkpoint,
                         save_checkpoint, save_sharded_checkpoint)
from .heartbeat import HeartbeatMonitor, HeartbeatSender
from .server_state import ServerStateStore

__all__ = [
    "backoff", "chaos", "checkpoint", "heartbeat", "server_state",
    "BackoffPolicy", "RetriesExhausted", "retry_call",
    "ChaosError", "ChaosSchedule", "Fault", "install", "install_from_env",
    "maybe_inject", "triggered", "uninstall",
    "ShardIntegrityError", "latest_checkpoint", "latest_sharded_checkpoint",
    "list_checkpoints", "load_checkpoint", "load_sharded_checkpoint",
    "save_checkpoint", "save_sharded_checkpoint",
    "HeartbeatMonitor", "HeartbeatSender", "ServerStateStore",
]
