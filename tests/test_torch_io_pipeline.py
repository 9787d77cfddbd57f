"""mxnet_tpu_torch.io.pipeline and io.device_tail held against mxnet_tpu's,
and the pipeline's own contracts held on the port.

- ``ImagePipelineIter`` in-process (W = 0) and over two worker processes
  (W = 2) gives bitwise the reference's in-process stream, over two
  shuffled epochs, on the OpenCV augmenting path and on the native
  decoder's path (the reference's W = 0 stream is the one its own tests
  hold every W to).
- The device tail against the reference's ``jax.jit`` tail, f32 and bf16,
  NCHW and NHWC: the port divides by ``std``; XLA's CPU build rewrites the
  reference's ``/ std`` into ``* (1 / std)`` (its HLO shows the multiply),
  so float32 outputs are held within one float32 ulp of the reference and
  bitwise to the true division in numpy, bf16 within one bf16 ulp of the
  reference and bitwise to the true division rounded once to bf16.
- A worker SIGKILLed through the ``pipeline.dispatch`` chaos site gives
  exactly one respawn and no batch lost or repeated; crashes past the
  ``max_respawns`` budget raise ``PipelineWorkerStorm``; a slow consumer
  keeps the ring bounded;
  a reset mid-epoch leaks no batch, and ``close`` leaves no process and no
  shared memory; ``PipelineStats`` has the reference's keys; a worker
  that initialised CUDA fails its batch.

The forkserver preloads the port once per test process, so each worker
starts as a fork, not a fresh import of torch.
"""
import os
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.io.device_tail import make_device_tail as jtail
from mxnet_tpu.io.pipeline import ImagePipelineIter as JaxPipe
from mxnet_tpu.profiler import PipelineStats as JaxPipelineStats
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch import io
from mxnet_tpu_torch.gluon.data import dataloader
from mxnet_tpu_torch.io import device_tail, pipeline
from mxnet_tpu_torch.io.pipeline import (ImagePipelineIter,
                                         PipelineWorkerStorm)
from mxnet_tpu_torch.resilience import chaos

import torch_io_cases as cases

cv2 = pytest.importorskip("cv2")

pytestmark = pytest.mark.skipif(not pipeline.pipeline_available(),
                                reason="no multiprocessing shared memory")

AUG = dict(batch_size=cases.BATCH, data_shape=(3, 28, 28), rand_crop=True,
           rand_mirror=True, brightness=0.2, native_decode=False)
NATIVE = dict(batch_size=cases.BATCH, data_shape=(3, 32, 32), resize=34,
              mean=np.array(cases.MEAN), std=np.array(cases.STD))


@pytest.fixture
def rec(tmp_path):
    return cases.make_rec(tmp_path, n=22)


def _pipe(rec, **kw):
    return ImagePipelineIter(path_imgrec=rec[0], path_imgidx=rec[1], **kw)


@pytest.mark.parametrize("chain", ["augment", "native"])
def test_w0_and_w2_match_the_reference_bitwise(rec, chain):
    kw = dict(AUG if chain == "augment" else NATIVE, seed=7, shuffle=True)
    ref = JaxPipe(num_workers=0, path_imgrec=rec[0], path_imgidx=rec[1],
                  **kw)
    w0 = _pipe(rec, num_workers=0, **kw)
    w2 = _pipe(rec, num_workers=2, prefetch_buffer=3, **kw)
    try:
        assert w2._n_workers == 2 and w2._depth == 3
        assert len(w2._procs) == 2
        native = w0._template._native_tail is not None
        assert native == (chain == "native")
        epochs = []
        for _ in range(2):
            want = cases.drain(ref)
            assert len(want) == 6
            cases.assert_same_stream(cases.drain(w0), want)
            cases.assert_same_stream(cases.drain(w2), want)
            epochs.append(want)
            for it in (ref, w0, w2):
                it.reset()
        # each epoch reshuffles, identically in every pipeline
        assert not all(np.array_equal(a[1], b[1])
                       for a, b in zip(*epochs))
        b = w2.next()
        assert b.data[0].context.type == "cpu"
    finally:
        w2.close()


def _bf16_ulps(got, want):
    """Largest distance in bf16 ulps (at ``want``'s magnitude)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    # a bf16 ulp is 2^(e - 7) for a value in [2^e, 2^(e + 1))
    e = np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
    return float(np.max(np.abs(got - want) / 2.0 ** (e - 7)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_device_tail_matches_reference(dtype, layout):
    rng = np.random.RandomState(0)
    u8 = rng.randint(0, 256, (cases.BATCH, 6, 5, 3)).astype(np.uint8)
    tail = device_tail.make_device_tail(cases.MEAN, cases.STD, dtype,
                                        layout)
    ref = jtail(np.array(cases.MEAN), np.array(cases.STD), dtype, layout)
    assert tail.tail_key == ref.tail_key
    got = tail(torch.from_numpy(u8))
    want = np.asarray(ref(jnp.asarray(u8)).astype(jnp.float32))
    exact = cases.host_tail(u8)
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        exact = exact.astype(ml_dtypes.bfloat16).astype(np.float32)
    got = got.float().numpy()
    if layout == "NCHW":
        exact = exact.transpose(0, 3, 1, 2)
        assert got.shape == (cases.BATCH, 3, 6, 5)
    np.testing.assert_array_equal(got, exact)
    if dtype == "float32":
        assert cases.f32_ulps(got, want) <= 1
    else:
        assert _bf16_ulps(got, want) <= 1


def test_device_tail_cache():
    device_tail.clear_tail_cache()
    a = device_tail.make_device_tail((1.0, 2.0, 3.0), (4.0, 5.0, 6.0),
                                     "float32", "NCHW")
    assert device_tail.make_device_tail(np.array([1.0, 2.0, 3.0]),
                                        [4.0, 5.0, 6.0], "float32",
                                        "NCHW") is a
    b = device_tail.make_device_tail(None, None, "bfloat16", "NHWC")
    assert device_tail.tail_cache_keys() == {a.tail_key, b.tail_key}
    x = torch.zeros((2, 4, 4, 3), dtype=torch.uint8)
    for _ in range(5):
        a(x)
    assert device_tail.tail_cache_sizes()[a.tail_key] == 1
    a(torch.zeros((3, 4, 4, 3), dtype=torch.uint8))
    assert device_tail.tail_cache_sizes() == {a.tail_key: 2, b.tail_key: 0}
    device_tail.clear_tail_cache()
    assert not device_tail.tail_cache_keys()


def test_worker_crash_respawns_exactly_once(rec):
    """SIGKILL worker 1 when batch 3 is dispatched, through the chaos
    site: one respawn, and the stream is the in-process one, bitwise."""
    kw = dict(AUG, seed=3, shuffle=False)
    want = cases.drain(_pipe(rec, num_workers=0, **kw))

    def kill(ctx):
        it, wid, _ = ctx
        it._procs[wid].kill()
        it._procs[wid].join(timeout=10)

    chaos.install([chaos.Fault("pipeline.dispatch", 4, "call", kill)])
    try:
        it = _pipe(rec, num_workers=2, prefetch_buffer=1, **kw)
        got = cases.drain(it)
        snap = it.stats.snapshot()
        it.close()
    finally:
        fired = chaos.triggered()
        chaos.uninstall()
    assert len(fired) == 1
    cases.assert_same_stream(got, want)
    assert sorted(np.concatenate([g[1] for g in got]).tolist()) == \
        [float(i) for i in range(22)] + [21.0] * 2
    assert snap["respawns"] == snap["respawns_epoch"] == 1


def test_crashes_past_the_budget_raise_a_storm(rec):
    def kill(ctx):
        it, wid, _ = ctx
        if wid == 0:
            it._procs[0].kill()
            it._procs[0].join(timeout=10)

    chaos.install([chaos.Fault("pipeline.dispatch", 1, "call", kill)])
    it = _pipe(rec, num_workers=1, prefetch_buffer=1, max_respawns=0,
               seed=1, **AUG)
    try:
        with pytest.raises(PipelineWorkerStorm, match="died 1 times"):
            cases.drain(it)
    finally:
        chaos.uninstall()
        it.close()


def test_slow_consumer_keeps_the_ring_bounded(rec):
    depth = 2
    it = _pipe(rec, num_workers=1, prefetch_buffer=depth, seed=1, **AUG)
    try:
        time.sleep(1.0)     # let the worker run ahead as far as it can
        seen = 0
        for _ in it:
            seen += 1
            assert len(it._done) <= depth
            assert len(it._in_flight[0]) <= depth
            time.sleep(0.05)
        snap = it.stats.snapshot()
        assert seen == 6 and snap["batches"] == 6
        assert snap["queue_depth_max"] <= 2 * depth
    finally:
        it.close()


def test_reset_mid_epoch_leaks_nothing(rec):
    it = _pipe(rec, num_workers=2, seed=5, shuffle=False, **AUG)
    procs, shm = list(it._procs), it._shm.name
    try:
        it.next()
        it.next()
        it.reset()
        labels = np.concatenate([b[1] for b in cases.drain(it)])
        assert sorted(labels.tolist()) == \
            [float(i) for i in range(22)] + [21.0] * 2
        assert not it._done
    finally:
        it.close()
    assert not any(p.is_alive() for p in procs)
    assert not os.path.exists(os.path.join("/dev/shm", shm))


def test_pipeline_stats_has_the_reference_keys(rec):
    it = _pipe(rec, num_workers=1, seed=0, **AUG)
    try:
        cases.drain(it)
        snap = it.stats.snapshot()
    finally:
        it.close()
    assert set(snap) == set(JaxPipelineStats(name="x").snapshot())
    assert snap["batches"] == 6 and snap["respawns"] == 0


def test_a_worker_that_initialised_cuda_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(MXNetError, match="initialised CUDA"):
        pipeline._check_no_cuda("pipeline worker 0")
    dataloader._worker_init([np.zeros(2)])
    with pytest.raises(MXNetError, match="initialised CUDA"):
        dataloader._worker_fn([0])


def test_image_record_iter_maps_its_knobs(rec):
    """``preprocess_threads`` is the worker count and ``prefetch_buffer``
    the ring depth, as in the reference."""
    got = io.ImageRecordIter(path_imgrec=rec[0], path_imgidx=rec[1],
                             batch_size=cases.BATCH, data_shape=(3, 28, 28),
                             preprocess_threads=2, prefetch_buffer=3, seed=0)
    try:
        assert isinstance(got, ImagePipelineIter)
        assert got._n_workers == 2 and got._depth == 3
        assert got.next().data[0].shape == (cases.BATCH, 3, 28, 28)
    finally:
        got.close()
