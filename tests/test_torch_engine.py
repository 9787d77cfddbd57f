"""The port's run-ahead engine (``mxnet_tpu_torch.engine``), the trainer's
in-flight ring, the device feed (``io.DeviceFeedIter`` /
``io.PrefetchToDeviceIter``) and ``engine_bench``, against
``tests/test_engine.py``'s contract for mxnet_tpu.

The engine reorders no math, only synchronization points, so training
at any window is bitwise the synchronous loop: losses and parameters at
depth 1, depth 4 and inside ``engine.bulk`` are held bitwise equal (on
both trainer tiers, f32 and bf16), and the depth-1 run is held to the
reference's trainer at 1e-5 (the f32 tolerance of
``tests/test_torch_train.py``).  The ring never holds more than
``engine.bulk_size()`` steps, and ``dispatch_stats`` has the reference's
keys, the worker-respawn counters among them (they count the data
pipeline's respawns, A3, and stay 0 on a trainer).  On the CPU a step has run when it returns, so
the ring holds the loss tensors in place of CUDA events; the
``cuda``-marked test holds the same on the card.
"""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import engine as jengine
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.parallel import DataParallelTrainer as JaxTrainer
from mxnet_tpu.profiler import PipelineStats as JaxPipelineStats
from mxnet_tpu_torch import engine, gluon
from mxnet_tpu_torch.gluon.utils import from_jax_params
from mxnet_tpu_torch.io import (DeviceFeedIter, NDArrayIter,
                                PrefetchToDeviceIter)
from mxnet_tpu_torch.parallel import DataParallelTrainer, MeshPlan
from mxnet_tpu_torch.profiler import PipelineStats
from mxnet_tpu_torch.resilience import chaos
from mxnet_tpu_torch.transformer import TransformerLM, TransformerLMConfig

BATCH, FEAT, NCLS = 16, 8, 4
STEPS = 10
TOL = 1e-5
# the reference's snapshot keys the port left out until A3 ported the
# pipeline that respawns workers
RESPAWN_KEYS = {"respawns", "respawns_epoch"}


def _data(n=160, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, FEAT).astype(np.float32)
    y = (np.arange(n) % NCLS).astype(np.float32)
    return X, y


def _net(g):
    net = g.nn.HybridSequential()
    with net.name_scope():
        net.add(g.nn.Dense(16, activation="relu"), g.nn.Dense(NCLS))
    return net


def _reference_init():
    np.random.seed(0)
    net = _net(jgluon)
    net.initialize(mx.init.Xavier())
    net(mx.nd.array(np.zeros((1, FEAT), np.float32)))
    return net, {n: p.data().asnumpy()
                 for n, p in net.collect_params().items()}


def _trainer(dtype=None):
    _, init = _reference_init()
    net = from_jax_params(_net(gluon), init, device="cpu")
    return net, DataParallelTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.1, "momentum": 0.9}, dtype=dtype, device="cpu")


def _lm_trainer(dtype=None):
    cfg = TransformerLMConfig(vocab_size=32, d_model=16, n_heads=4,
                              n_layers=1, d_ff=32, seq_len=16)
    return None, DataParallelTrainer(
        TransformerLM(cfg), None, "sgd",
        {"learning_rate": 0.1, "momentum": 0.9},
        mesh_plan=MeshPlan(sequence=2), dtype=dtype, device="cpu")


def _batch(tier):
    if tier == "mesh":
        rng = np.random.RandomState(1)
        x = rng.randint(0, 32, size=(4, 16)).astype(np.int32)
        return x, np.roll(x, -1, axis=1).astype(np.int32)
    X, y = _data()
    return X[:BATCH], y[:BATCH]


def _params(net, tr):
    if net is None:
        return list(tr.mesh_params().values())
    return [p.tensor().detach().numpy().copy()
            for p in net.collect_params().values()]


def _run_steps(mode, tier="replicated", dtype=None, nsteps=STEPS):
    """``nsteps`` fixed steps under a dispatch mode: (losses, params)."""
    net, tr = (_lm_trainer if tier == "mesh" else _trainer)(dtype)
    xb, yb = _batch(tier)
    losses = []
    if mode == "bulk":
        with engine.bulk(4) as prev:
            assert isinstance(prev, int) and prev >= 1
            for _ in range(nsteps):
                losses.append(tr.step(xb, yb))
                assert len(tr._inflight) <= 4
    else:
        prev = engine.set_bulk_size(mode)
        try:
            for _ in range(nsteps):
                losses.append(tr.step(xb, yb))
                assert len(tr._inflight) <= mode
        finally:
            engine.set_bulk_size(prev)
            engine.flush()
    assert not tr._inflight
    return [float(l) for l in losses], _params(net, tr)


# -- the engine surface ------------------------------------------------------
def test_set_bulk_size_returns_prev_and_validates():
    prev = engine.set_bulk_size(3)
    try:
        assert engine.bulk_size() == 3
        assert engine.set_bulk_size(5) == 3
        with pytest.raises(ValueError):
            engine.set_bulk_size(0)
    finally:
        engine.set_bulk_size(prev)
    assert engine.bulk_size() == jengine.bulk_size() == 15


def test_bulk_yields_prev_and_restores_on_exception():
    base = engine.bulk_size()
    with engine.bulk(7) as prev:
        assert prev == base
        assert engine.bulk_size() == 7
    assert engine.bulk_size() == base
    with pytest.raises(RuntimeError):
        with engine.bulk(3):
            assert engine.bulk_size() == 3
            raise RuntimeError("boom")
    assert engine.bulk_size() == base


def test_flush_drains_registered_ring_held_weakly():
    drained = []

    class Ring:
        def flush(self):
            drained.append(True)

    r = Ring()
    engine.register_flusher(r.flush)
    engine.flush()
    assert drained
    del r
    n = len(drained)
    engine.flush()
    assert len(drained) == n
    # a plain function is held weakly too
    calls = []

    def fn():
        calls.append(1)

    engine.register_flusher(fn)
    engine.flush()
    assert calls == [1]


def test_flush_runs_the_chaos_probe():
    chaos.install([chaos.Fault("engine.flush", 1, action="raise")])
    try:
        with pytest.raises(chaos.ChaosError):
            engine.flush()
    finally:
        chaos.uninstall()
    engine.flush()


# -- exactness: run-ahead changes not one bit ---------------------------------
@pytest.mark.parametrize("tier,dtype", [("replicated", None),
                                        ("replicated", "bf16"),
                                        ("mesh", None), ("mesh", "bf16")])
def test_runahead_bitwise_identical_depth_1_vs_4_vs_bulk(tier, dtype):
    l1, p1 = _run_steps(1, tier, dtype)
    l4, p4 = _run_steps(4, tier, dtype)
    lb, pb = _run_steps("bulk", tier, dtype)
    assert l1 == l4 == lb
    for a, b, c in zip(p1, p4, pb):
        assert a.tobytes() == b.tobytes() == c.tobytes()


def test_runahead_depth_1_matches_reference():
    jnet, _ = _reference_init()
    tr = JaxTrainer(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                    {"learning_rate": 0.1, "momentum": 0.9})
    xb, yb = _batch("replicated")
    want = [float(tr.step(mx.nd.array(xb), mx.nd.array(yb)).asnumpy())
            for _ in range(STEPS)]
    tr.flush()
    got, params = _run_steps(1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for a, p in zip(params, jnet.collect_params().values()):
        np.testing.assert_allclose(a, p.data().asnumpy(), rtol=0, atol=TOL)


# -- backpressure -------------------------------------------------------------
def test_backpressure_bounds_inflight_ring():
    _, tr = _trainer()
    xb, yb = _batch("replicated")
    prev = engine.set_bulk_size(2)
    try:
        for _ in range(12):
            tr.step(xb, yb)
            assert len(tr._inflight) <= 2
    finally:
        engine.set_bulk_size(prev)
        engine.flush()
    assert not tr._inflight
    snap = tr.dispatch_stats.snapshot()
    assert set(snap) == set(JaxPipelineStats(name="x").snapshot())
    assert {k: snap[k] for k in RESPAWN_KEYS} == dict.fromkeys(RESPAWN_KEYS,
                                                               0)
    assert snap["dispatched_steps"] == 12
    assert 1 <= snap["inflight_max"] <= 2
    assert snap["dispatch_stall_s"] >= 0.0


def test_backpressure_keeps_window_full_on_both_tiers():
    """The ring sits at the window (the queue stays full) and never
    beyond it, on the replicated tier and the mesh tier."""
    for make, tier in ((_trainer, "replicated"), (_lm_trainer, "mesh")):
        _, tr = make()
        xb, yb = _batch(tier)
        with engine.bulk(3):
            for _ in range(8):
                tr.step(xb, yb)
                assert len(tr._inflight) <= 3
        assert not tr._inflight
        assert tr.dispatch_stats.snapshot()["inflight_max"] == 3


def test_pipeline_stats_snapshot_keys_match_reference():
    mine, ref = PipelineStats(name="t"), JaxPipelineStats(name="t")
    for s in (mine, ref):
        s.on_batch(0, 0.01, 2)
        s.on_wait(0.001)
        s.on_dispatch(3)
        s.on_backpressure(0.002)
        s.on_respawn()
        s.on_respawn()
        s.on_epoch()
        s.on_respawn()
    a, b = mine.snapshot(), ref.snapshot()
    assert set(a) == set(b) and RESPAWN_KEYS <= set(a)
    for k in ("batches", "queue_depth_max", "dispatched_steps",
              "inflight_max", "dispatch_stall_s", "stall_s", "respawns",
              "respawns_epoch"):
        assert a[k] == b[k], k
    assert (a["respawns"], a["respawns_epoch"]) == (3, 1)


# -- the device feed ----------------------------------------------------------
def test_prefetch_ring_bounds_live_batches():
    X, y = _data(n=12 * BATCH)
    produced = []

    class Counting(NDArrayIter):
        def next(self):
            b = super().next()
            produced.append(1)
            return b

    depth = 2
    pf = PrefetchToDeviceIter(Counting(X, y, BATCH,
                                       last_batch_handle="discard"),
                              depth=depth, device="cpu")
    consumed = overdraft = 0
    for b in pf:
        time.sleep(0.01)    # the worker may run ahead; the ring stops it
        consumed += 1
        overdraft = max(overdraft, len(produced) - consumed)
        assert b.data[0].shape == (BATCH, FEAT)
    assert consumed == 12
    assert pf.live_slots_max <= depth
    assert overdraft <= depth + 1
    assert pf.stats.snapshot()["batches"] == 12


def test_prefetch_hbm_bound_reported_and_batches_train():
    X, y = _data()
    pf = PrefetchToDeviceIter(NDArrayIter(X, y, BATCH), depth=3,
                              device="cpu")
    per_batch = BATCH * FEAT * 4 + BATCH * 4
    assert pf.batch_bytes() == per_batch
    assert pf.hbm_bound_bytes() == 3 * per_batch
    # prefetched batches feed the trainer as they are, and give the
    # numbers of the host batches
    _, tr = _trainer()
    _, tr_host = _trainer()
    for b, s in zip(pf, range(0, len(X), BATCH)):
        a = float(tr.step(b.data[0], b.label[0]))
        h = float(tr_host.step(X[s:s + BATCH], y[s:s + BATCH]))
        assert a == h


def test_device_feed_refusals_and_reset():
    """``sharding`` (A6) still raises; ``transform`` and ``"roll_over"``
    are ported (A3): the feed applies the transform to the data alone,
    and ``roll_over`` gives the reference's batches over two epochs."""
    X, y = _data(n=4 * BATCH)
    feed = DeviceFeedIter(NDArrayIter(-X, y, BATCH), transform=abs,
                          device="cpu")
    got = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in feed]
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got]), X)
    np.testing.assert_array_equal(np.concatenate([g[1] for g in got]), y)
    with pytest.raises(NotImplementedError, match="item 6"):
        PrefetchToDeviceIter(NDArrayIter(X, y, BATCH), sharding=object(),
                             device="cpu")
    rolls = []
    for it in (NDArrayIter(X[:-3], y[:-3], BATCH,
                           last_batch_handle="roll_over"),
               mx.io.NDArrayIter(X[:-3], y[:-3], BATCH,
                                 last_batch_handle="roll_over")):
        rolls.append([])
        for _ in range(2):
            rolls[-1] += [(b.data[0].asnumpy(), b.pad) for b in it]
            it.reset()
    assert len(rolls[0]) == len(rolls[1]) > 4
    for (a, pa), (b, pb) in zip(*rolls):
        np.testing.assert_array_equal(a, b)
        assert pa == pb
    feed = DeviceFeedIter(NDArrayIter(X, y, BATCH), depth=2, device="cpu")
    assert len(list(feed)) == 4
    feed.reset()
    assert len(list(feed)) == 4


def test_feed_defaults_to_the_card(monkeypatch):
    from mxnet_tpu_torch.base import MXNetError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _data(n=BATCH)
    with pytest.raises(MXNetError, match="no CUDA device"):
        PrefetchToDeviceIter(NDArrayIter(X, y, BATCH))


# -- the bench ----------------------------------------------------------------
def test_engine_bench_prints_reference_keys(monkeypatch, capsys):
    import json
    from mxnet_tpu_torch import engine_bench
    for k, v in (("STEPS", "6"), ("HIDDEN", "32"), ("BATCH", "16")):
        monkeypatch.setenv("MXTPU_OVERLAP_" + k, v)
    assert engine_bench.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("train_loop_overlap_ratio", "dispatch_depth",
                "overlap_step_ms", "overlap_feed_ms",
                "overlap_stepped_steps_per_sec",
                "overlap_bulk_steps_per_sec", "overlap_inflight_max",
                "overlap_dispatch_stall_s", "overlap_prefetch_slots_max",
                "overlap_prefetch_hbm_bound_bytes"):
        assert key in out, key
    assert out["device"] == "cpu"
    assert 1 <= out["overlap_inflight_max"] <= out["dispatch_depth"]
    assert out["overlap_prefetch_slots_max"] <= 2


@pytest.mark.cuda
def test_runahead_bitwise_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ring waits on CUDA events")
    _, init = _reference_init()
    X, y = _data()
    xb, yb = torch.from_numpy(X[:BATCH]).cuda(), torch.from_numpy(
        y[:BATCH]).cuda()
    runs = []
    for depth in (1, 4):
        net = from_jax_params(_net(gluon), init)
        tr = DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9}, dtype="bf16")
        with engine.bulk(depth):
            losses = [tr.step(xb, yb) for _ in range(STEPS)]
            assert all(isinstance(e, torch.cuda.Event)
                       for e in tr._inflight)
        runs.append(([float(l) for l in losses],
                     [p.tensor().cpu().numpy()
                      for p in net.collect_params().values()]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert a.tobytes() == b.tobytes()
