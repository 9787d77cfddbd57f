"""Device contexts as ``torch.device``: the port of ``mxnet_tpu/context.py``.

``cpu()`` and ``gpu(i)`` return ``torch.device`` objects, and every
default goes through :func:`~mxnet_tpu_torch.base.resolve_device`: the
CUDA device unless the caller asks for the CPU.  ``gpu()`` with no card
raises instead of quietly running on the host.  ``with use(cpu()):``
makes the CPU the default of :func:`current_context` in this thread (the
reference's ``with mx.cpu():``).
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .base import MXNetError, resolve_device

__all__ = ["cpu", "gpu", "num_gpus", "current_context", "use"]

_default = threading.local()


def cpu(device_id=0):
    """The host: ``torch.device("cpu")`` (one host, whatever the id)."""
    return torch.device("cpu")


def gpu(device_id=0):
    """CUDA device ``device_id``; raises :class:`MXNetError` without one."""
    dev = resolve_device(torch.device("cuda", int(device_id)))
    if dev.index >= torch.cuda.device_count():
        raise MXNetError("gpu(%d): only %d CUDA device(s)"
                         % (device_id, torch.cuda.device_count()))
    return dev


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context():
    """The default device: the one set by :func:`use` in this thread, else
    CUDA (raising when there is no card)."""
    return resolve_device(getattr(_default, "value", None))


@contextlib.contextmanager
def use(device):
    """Make ``device`` the default of :func:`current_context` inside the
    ``with`` block, in this thread."""
    old = getattr(_default, "value", None)
    _default.value = resolve_device(device)
    try:
        yield _default.value
    finally:
        _default.value = old
