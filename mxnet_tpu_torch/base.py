"""Base utilities of the PyTorch port: the error type and the device rule.

The counterpart of ``mxnet_tpu/base.py``.  Only what the port uses is
here: :class:`MXNetError` and :func:`resolve_device`, the one place that
decides where an entry point runs (it takes a ``torch.device``, a string
or a :class:`~mxnet_tpu_torch.context.Context`).  The rule: an entry point runs on the
CUDA device unless its caller asks for the CPU by name; with no CUDA
device present, a default or CUDA request raises instead of quietly
running on the host.
"""
from __future__ import annotations

import torch

__all__ = ["MXNetError", "resolve_device", "as_torch_device"]


class MXNetError(RuntimeError):
    """Error raised by the framework (reference: python/mxnet/base.py:83)."""


def as_torch_device(device):
    """``device`` with a ``Context`` converted to its ``torch.device`` (not
    checked against the machine); anything else as it is."""
    convert = getattr(device, "torch_device", None)
    return convert() if convert is not None else device


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on.

    ``None`` means ``cuda`` (the current CUDA device).  ``"cpu"`` (or a
    CPU ``torch.device``) is honoured as asked — the CPU tests use it.
    A CUDA request with no CUDA device raises :class:`MXNetError`.  A
    ``Context`` (``mx.cpu()``, ``mx.gpu(i)``) converts to its device."""
    dev = torch.device("cuda" if device is None else as_torch_device(device))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise MXNetError("unsupported device %r (want cuda or cpu)"
                         % (device,))
    return dev
