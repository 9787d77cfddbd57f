"""Fault injection, retry policy and training checkpoints of the port
(host-only): ``chaos``, ``backoff`` and ``checkpoint`` (atomic
snapshots, sharded ZeRO-1 snapshots with resize-on-resume)."""
from . import backoff, chaos, checkpoint
from .checkpoint import (ShardIntegrityError, latest_checkpoint,
                         latest_sharded_checkpoint, list_checkpoints,
                         load_checkpoint, load_sharded_checkpoint,
                         save_checkpoint, save_sharded_checkpoint)

__all__ = ["backoff", "chaos", "checkpoint", "ShardIntegrityError",
           "latest_checkpoint", "latest_sharded_checkpoint",
           "list_checkpoints", "load_checkpoint", "load_sharded_checkpoint",
           "save_checkpoint", "save_sharded_checkpoint"]
