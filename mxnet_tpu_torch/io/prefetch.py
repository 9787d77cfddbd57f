"""Device prefetch for training loops: the port of
``mxnet_tpu/io/prefetch.py`` — ship batch *k+1* while step *k* runs.

:class:`PrefetchToDeviceIter` is the training form of
:class:`~mxnet_tpu_torch.io.DeviceFeedIter`: a worker thread moves each
host batch (data and labels) to the card through pinned memory on a side
stream, behind a ring of ``depth`` slots, so the trainer's step finds its
batch already there (``DataParallelTrainer.step`` uses a tensor on its
device as it is).  :meth:`hbm_bound_bytes` reports the ring's cap on
device memory, ``depth x batch_bytes``, from the batch descriptors.
``transform`` (a device tail, ``io/device_tail.py``) runs on the data on
the card, on the feed's side stream, as in ``DeviceFeedIter``; give
``data_desc`` its output's geometry so ``batch_bytes`` counts what stays
on the card.

``sharding`` (a data-parallel batch layout) is ROADMAP.md queue A, item 6,
and raises.
"""
from __future__ import annotations

import numpy as _np

from . import DeviceFeedIter

__all__ = ["PrefetchToDeviceIter"]


class PrefetchToDeviceIter(DeviceFeedIter):
    """Prefetch host batches onto ``device`` through a ``depth``-slot
    ring (default device: the current context, the card unless
    ``context.use("cpu")``; on the CPU host tensors are handed over)."""

    def __init__(self, base, sharding=None, depth=2, transform=None,
                 data_desc=None, device=None):
        if sharding is not None:
            raise NotImplementedError(
                "PrefetchToDeviceIter(sharding=...): a data-parallel batch "
                "layout is ROADMAP.md queue A, item 6")
        super().__init__(base, transform=transform, depth=depth,
                         data_desc=data_desc, device=device)

    def batch_bytes(self):
        """Bytes one prefetched batch keeps on the device (data + labels),
        from the provide_data / provide_label descriptors."""
        total = 0
        for desc in list(self.provide_data) + list(self.provide_label or []):
            n = 1
            for d in desc.shape:
                n *= int(d)
            dtype = getattr(desc, "dtype", _np.float32)
            try:
                itemsize = _np.dtype(dtype).itemsize
            except TypeError:  # e.g. the string "bfloat16"
                itemsize = 2 if "16" in str(dtype) else 4
            total += n * itemsize
        return total

    def hbm_bound_bytes(self):
        """The ring's cap on device memory: ``depth x batch_bytes``, the
        most this iterator ever holds there, by the slot semaphore."""
        return self.depth * self.batch_bytes()
