"""The device tail of the data pipeline: normalize + cast + layout on the
batch's device.

The port of ``mxnet_tpu/io/device_tail.py``.  The reference normalizes on
the host (``mean_r/std_r`` inside the C++ augmenter chain,
``image_aug_default.cc``); here the host ships the batch as raw uint8 NHWC,
a quarter of float32's bytes, and the mean/std subtract, the dtype cast
and the layout transpose run on the card, in torch ops on the batch's
device: elementwise passes (widen to float32, subtract, divide, and the
cast for an output that is not float32) and, for an NCHW output, the
transpose.  The order
is the reference's ``jax.jit`` tail: widen to float32, subtract ``mean``,
divide by ``std`` (a division, not a product with its reciprocal), then
cast once from float32, so a bf16 output rounds once, to nearest even.
Tensors on the CPU go through the same ops (the plain version the tests
hold against the reference).

Every distinct ``(mean, std, dtype, layout, input_layout)`` tail is built
once and cached module-wide, keyed as in the reference, so two iterators
with the same normalization share one callable.  The reference's
``tail_cache_sizes`` counts XLA traces; eager torch ops trace nothing, so
here it counts the distinct input geometries (shape, dtype, device) each
tail has seen: steady feeding holds it at 1 per geometry, as the
reference's trace count.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

__all__ = ["make_device_tail", "tail_cache_keys", "tail_cache_sizes",
           "clear_tail_cache"]

_CACHE = {}
_LOCK = threading.Lock()


def _key(mean, std, dtype, layout, input_layout):
    def tup(v):
        if v is None:
            return None
        return tuple(float(x) for x in _np.asarray(v).reshape(-1))
    return (tup(mean), tup(std), str(dtype), str(layout), str(input_layout))


def _torch_dtype(dtype):
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(_np.zeros(0, _np.dtype(dtype))).dtype


class _Tail:
    """``uint8[B,H,W,C] -> dtype[batch]`` on the input's device."""

    def __init__(self, key, mean, std, dtype, layout, input_layout):
        self.tail_key = key
        self._mean = None if mean is None else \
            torch.from_numpy(_np.asarray(mean, _np.float32).copy())
        self._std = None if std is None else \
            torch.from_numpy(_np.asarray(std, _np.float32).copy())
        self._dtype = _torch_dtype(dtype)
        self._perm = None
        if layout == "NCHW" and input_layout == "NHWC":
            self._perm = (0, 3, 1, 2)
        elif layout == "NHWC" and input_layout == "NCHW":
            self._perm = (0, 2, 3, 1)
        self._consts = {}
        self._seen = set()
        self._lock = threading.Lock()

    def _on(self, device):
        """The constants on ``device`` (copied there once)."""
        got = self._consts.get(device)
        if got is None:
            got = tuple(None if c is None else c.to(device)
                        for c in (self._mean, self._std))
            with self._lock:
                self._consts[device] = got
        return got

    def __call__(self, x):
        with self._lock:
            self._seen.add((tuple(x.shape), x.dtype, x.device))
        mean, std = self._on(x.device)
        y = x.to(torch.float32)
        if mean is not None:
            y = y - mean
        if std is not None:
            y = y / std
        y = y.to(self._dtype)
        if self._perm is not None:
            y = y.permute(self._perm).contiguous()
        return y

    def _geometries(self):
        with self._lock:
            return len(self._seen)


def make_device_tail(mean=None, std=None, dtype="float32", layout="NHWC",
                     input_layout="NHWC"):
    """Build (or fetch) the tail ``uint8[B,H,W,C] -> dtype[batch]``.

    mean, std : per-channel (or scalar) normalization constants, applied in
        float32 before the cast so bf16 targets round once, not twice.
    dtype : output dtype (``bfloat16`` for the mixed-precision trainer).
    layout : output layout; ``NCHW`` adds the transpose on the device.
    input_layout : layout the host ships (``NHWC`` — the decoder's own).

    The returned callable runs on a tensor's own device: applied by
    ``DeviceFeedIter`` on its side stream, or first in a step by
    ``DataParallelTrainer(input_transform=...)``.
    """
    key = _key(mean, std, dtype, layout, input_layout)
    with _LOCK:
        fn = _CACHE.get(key)
        if fn is not None:
            return fn
    fn = _Tail(key, mean, std, dtype, layout, input_layout)
    with _LOCK:
        # a racing builder may have landed first; keep the canonical one
        fn = _CACHE.setdefault(key, fn)
    return fn


def tail_cache_keys():
    """The set of distinct tail configurations built so far."""
    with _LOCK:
        return set(_CACHE)


def tail_cache_sizes():
    """{tail key: distinct input geometries it has seen}.  Steady-state
    feeding holds every count at 1 per input geometry."""
    with _LOCK:
        items = list(_CACHE.items())
    return {key: fn._geometries() for key, fn in items}


def clear_tail_cache():
    with _LOCK:
        _CACHE.clear()
