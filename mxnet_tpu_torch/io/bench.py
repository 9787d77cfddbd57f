"""Host-only input-pipeline micro-bench:
``python -m mxnet_tpu_torch.io.bench``.

The port of ``mxnet_tpu/io/bench.py``.  Measures what the host can FEED,
with no card in the loop: every iterator here feeds the CPU
(``context.use("cpu")``), so the number is the host's whatever the card.

``fed`` here means: decode + augment + hand-over by the device feed +
the normalization tail applied, per batch, measured over a steady-state
epoch (workers up, first-batch costs paid in a warm-up epoch, as in
steady training).  Three variants:

- legacy: the in-process float path — host-side mean/std normalize,
  float32 NCHW batches;
- new: the multi-process shared-memory pipeline shipping raw uint8 NHWC
  with the device tail (``device_tail=True``; the tail runs on the CPU
  here);
- a worker-scaling curve for the new pipeline (0 = in-process), from
  which the headline ``pipeline_fed_imgs_per_sec`` takes the best
  config on this host (reported in ``pipeline_best_workers``).

The ``.rec`` is packed from the JPEG fixtures of
``tests/data/torch_io/`` (500 x 375, quality 90), cycled with distinct
labels, so no encoder is needed.  Sizes come from the reference's
environment variables: ``MXTPU_PIPE_BENCH_N`` records (768),
``MXTPU_PIPE_BENCH_BATCH`` (128), ``MXTPU_PIPE_BENCH_SIZE`` (224) and
``MXTPU_PIPE_BENCH_WORKERS`` (``0,1,2``).  Prints one JSON line.
"""
from __future__ import annotations

import glob
import json
import os
import shutil
import sys
import tempfile
import time

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "data", "torch_io")
MEAN_STD = dict(mean_r=123.68, mean_g=116.28, mean_b=103.53,
                std_r=58.395, std_g=57.12, std_b=57.375)


def fixture_jpegs():
    """The fixture JPEGs' bytes, in name order."""
    paths = sorted(glob.glob(os.path.join(FIXTURES, "img_*.jpg")))
    if not paths:
        raise FileNotFoundError("no JPEG fixtures under %s (write them with "
                                "tests/data/torch_io/make_fixtures.py)"
                                % FIXTURES)
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(f.read())
    return out


def fixture_rec(n, tmpdir):
    """Pack ``n`` records cycling the fixtures, record ``i`` labelled
    ``i % 1000`` with id ``i``, into ``tmpdir``; returns (rec, idx)."""
    from .. import recordio
    jpegs = fixture_jpegs()
    rec = os.path.join(tmpdir, "fixtures.rec")
    idx = os.path.join(tmpdir, "fixtures.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        w.write_idx(i, recordio.pack(
            recordio.IRHeader(0, float(i % 1000), i, 0),
            jpegs[i % len(jpegs)]))
    w.close()
    return rec, idx


def _timed_epoch(make_iter, consume):
    """Steady-state epoch rate: epoch 1 warms (workers, prefetch), epoch 2
    is timed.  Returns (images/s, stats snapshot or None)."""
    it = make_iter()
    n_img = 0
    for b in it:
        consume(b)
    it.reset()
    t0 = time.perf_counter()
    for b in it:
        consume(b)
        n_img += b.data[0].shape[0]
    dt = time.perf_counter() - t0
    # prefer the decode pipeline's stats (worker pool utilization) over
    # the DeviceFeedIter wrapper's own feed-thread stats
    if hasattr(getattr(it, "base", None), "stats"):
        stats = it.base.stats.snapshot()
    elif hasattr(it, "stats"):
        stats = it.stats.snapshot()
    else:
        stats = None
    close = getattr(it, "close", None) or getattr(
        getattr(it, "base", None), "close", None)
    if close:
        close()
    return n_img / dt, stats


def _consume(b):
    """The consumer: one reduction per batch, a stand-in for "the device
    accepted this batch" that costs the same for every variant."""
    float(b.data[0]._data.float().sum())


def run(n, batch, size, workers_curve, resize=0):
    """The bench's record (a dict) at these sizes; ``resize`` > 0 resizes
    the short side first (``main`` crops at the decoded size, as the
    reference's bench does)."""
    from .. import _native, context, recordio
    from .. import io as mxio
    tmpdir = tempfile.mkdtemp(prefix="mxtt_pipe_bench_")
    out = {"pipeline_device": "cpu", "pipeline_host_cores": os.cpu_count(),
           "pipeline_batch": batch, "pipeline_n_records": n,
           "pipeline_decode_threads": _native.default_threads(),
           "pipeline_resize": resize}
    try:
        rec, idx = fixture_rec(n, tmpdir)
        # raw native decode rate: the host's physical ceiling
        if _native.available():
            r = recordio.MXIndexedRecordIO(idx, rec, "r")
            bufs = [recordio.unpack(r.read_idx(i))[1] for i in range(n)]
            r.close()
            t0 = time.perf_counter()
            _native.decode_batch(bufs, size, size, 3, resize_short=resize)
            out["pipeline_decode_imgs_per_sec"] = round(
                n / (time.perf_counter() - t0), 2)
            del bufs
        with context.use("cpu"):
            # legacy: in-process float path, host normalize, NCHW float32
            def legacy():
                return mxio.DeviceFeedIter(mxio.ImageRecordIter(
                    path_imgrec=rec, path_imgidx=idx, batch_size=batch,
                    data_shape=(3, size, size), shuffle=False, resize=resize,
                    **MEAN_STD))
            rate, _ = _timed_epoch(legacy, _consume)
            out["pipeline_fed_legacy_imgs_per_sec"] = round(rate, 2)

            # new: uint8 NHWC + the device tail, over the worker curve
            scaling = {}
            best, best_w, best_stats = 0.0, 0, None
            for w in workers_curve:
                def new_pipe(w=w):
                    return mxio.ImageRecordIter(
                        path_imgrec=rec, path_imgidx=idx, batch_size=batch,
                        data_shape=(3, size, size), shuffle=False,
                        resize=resize, layout="NHWC", device_tail=True,
                        seed=0,
                        preprocess_threads=w, prefetch_buffer=2,
                        **MEAN_STD)
                rate, stats = _timed_epoch(new_pipe, _consume)
                scaling[str(w)] = round(rate, 2)
                if rate > best:
                    best, best_w, best_stats = rate, w, stats
        out["pipeline_worker_scaling"] = scaling
        out["pipeline_fed_imgs_per_sec"] = round(best, 2)
        out["pipeline_best_workers"] = best_w
        if out.get("pipeline_fed_legacy_imgs_per_sec"):
            out["pipeline_speedup_vs_legacy"] = round(
                best / out["pipeline_fed_legacy_imgs_per_sec"], 2)
        if best_stats:
            out["pipeline_stall_pct"] = best_stats["stall_pct"]
            out["pipeline_worker_utilization"] = \
                best_stats["worker_utilization"]
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out


def main():
    n = int(os.environ.get("MXTPU_PIPE_BENCH_N", "768"))
    batch = int(os.environ.get("MXTPU_PIPE_BENCH_BATCH", "128"))
    size = int(os.environ.get("MXTPU_PIPE_BENCH_SIZE", "224"))
    workers_curve = [int(w) for w in os.environ.get(
        "MXTPU_PIPE_BENCH_WORKERS", "0,1,2").split(",")]
    print(json.dumps(run(n, batch, size, workers_curve)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
