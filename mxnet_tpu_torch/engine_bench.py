"""The run-ahead overlap bench: the port of ``mxnet_tpu/engine_bench.py``.

    python -m mxnet_tpu_torch.engine_bench [--device cpu]

Runs on the card unless given ``--device cpu`` (without a card and
without the flag it raises).  It measures what the run-ahead window buys:
the wall time of a *stepped* training loop (feed, step, ``float(loss)``
every step, fully serialized) against the *bulk* loop
(``PrefetchToDeviceIter`` moves batch k+1 to the card on a thread while
step k runs, ``engine.bulk(depth)`` keeps up to ``depth`` steps queued,
the loss sums on the device and is read once).  The host feed's latency
is a sleep equal to the measured step time (the stand-in for a decode
pipeline whose cost is paid in worker processes, GIL-free), so a fully
overlapped loop approaches 2x the stepped one.

Prints one JSON line with the reference's keys
(``train_loop_overlap_ratio``, ``dispatch_depth``, ``overlap_step_ms``,
``overlap_feed_ms``, ``overlap_stepped_steps_per_sec``,
``overlap_bulk_steps_per_sec``, ``overlap_inflight_max``,
``overlap_dispatch_stall_s``, ``overlap_prefetch_slots_max``,
``overlap_prefetch_hbm_bound_bytes``) and ``device``.  The sizes follow
the reference's environment variables (``MXTPU_OVERLAP_STEPS``,
``_DEPTH``, ``_BATCH``, ``_HIDDEN``, ``_FEED_MULT``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


class _SlowFeedIter:
    """Host iterator with a fixed per-batch latency (decode stand-in)."""

    def __init__(self, inner, delay_s):
        self.inner = inner
        self.delay_s = delay_s
        self.batch_size = inner.batch_size

    @property
    def provide_data(self):
        return self.inner.provide_data

    @property
    def provide_label(self):
        return self.inner.provide_label

    def reset(self):
        self.inner.reset()

    def next(self):
        batch = self.inner.next()   # raises StopIteration at the end
        time.sleep(self.delay_s)
        return batch

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    import torch

    from . import engine, initializer
    from .base import resolve_device
    from .gluon import loss as gloss
    from .gluon import nn
    from .io import NDArrayIter, PrefetchToDeviceIter
    from .parallel import DataParallelTrainer

    ap = argparse.ArgumentParser(prog="python -m mxnet_tpu_torch.engine_bench")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the host; default the card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    steps = int(os.environ.get("MXTPU_OVERLAP_STEPS", "24"))
    depth = int(os.environ.get("MXTPU_OVERLAP_DEPTH", "4"))
    batch = int(os.environ.get("MXTPU_OVERLAP_BATCH", "128"))
    hidden = int(os.environ.get("MXTPU_OVERLAP_HIDDEN", "1024"))
    feat = 784

    rng = np.random.RandomState(0)
    X = rng.rand(steps * batch, feat).astype(np.float32)
    y = (np.arange(steps * batch) % 10).astype(np.float32)

    def build_trainer():
        net = nn.HybridSequential()
        net.add(nn.Dense(hidden, activation="relu"),
                nn.Dense(hidden, activation="relu"), nn.Dense(10))
        net.initialize(initializer.Xavier(), ctx=device,
                       rng=np.random.RandomState(7))
        return DataParallelTrainer(net, gloss.SoftmaxCrossEntropyLoss(),
                                   "sgd", {"learning_rate": 0.05},
                                   device=device)

    xb, yb = X[:batch], y[:batch]
    # -- calibrate: the step's synchronous latency
    tr = build_trainer()
    float(tr.step(xb, yb))
    t0 = time.perf_counter()
    calib_iters = 8
    for _ in range(calib_iters):
        float(tr.step(xb, yb))
    step_s = (time.perf_counter() - t0) / calib_iters
    feed_s = step_s * float(os.environ.get("MXTPU_OVERLAP_FEED_MULT",
                                           "1.0"))

    def make_iter():
        return _SlowFeedIter(NDArrayIter(X, y, batch,
                                         last_batch_handle="discard"),
                             feed_s)

    # -- stepped: feed, step, read the loss, every batch (the baseline
    # under test, not a recommendation)
    tr = build_trainer()
    float(tr.step(xb, yb))
    it = make_iter()
    t0 = time.perf_counter()
    n_stepped = 0
    for b in it:
        float(tr.step(b.data[0], b.label[0]))
        n_stepped += 1
    stepped_s = time.perf_counter() - t0

    # -- bulk: the prefetch thread, the run-ahead window, the loss summed
    # on the device
    tr = build_trainer()
    float(tr.step(xb, yb))
    _sync(device)
    pf = PrefetchToDeviceIter(make_iter(), depth=2, device=device)
    tot = None
    t0 = time.perf_counter()
    n_bulk = 0
    with engine.bulk(depth):
        for b in pf:
            loss = tr.step(b.data[0], b.label[0])
            tot = loss if tot is None else tot + loss
            n_bulk += 1
    float(tot)   # the window's one read
    bulk_s = time.perf_counter() - t0

    snap = tr.dispatch_stats.snapshot()
    out = {
        "train_loop_overlap_ratio": round(stepped_s / bulk_s, 3),
        "dispatch_depth": depth,
        "overlap_step_ms": round(step_s * 1000, 3),
        "overlap_feed_ms": round(feed_s * 1000, 3),
        "overlap_stepped_steps_per_sec": round(n_stepped / stepped_s, 2),
        "overlap_bulk_steps_per_sec": round(n_bulk / bulk_s, 2),
        "overlap_inflight_max": snap["inflight_max"],
        "overlap_dispatch_stall_s": snap["dispatch_stall_s"],
        "overlap_prefetch_slots_max": pf.live_slots_max,
        "overlap_prefetch_hbm_bound_bytes": pf.hbm_bound_bytes(),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
