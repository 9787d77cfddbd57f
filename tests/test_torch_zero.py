"""ZeRO-1 and gradient accumulation in the port
(``mxnet_tpu_torch.parallel.zero``, ``DataParallelTrainer(mesh=,
zero=1, grad_accum=)``) held against mxnet_tpu's on the CPU.

The reference runs on the virtual CPU devices of ``tests/conftest.py`` at
``make_mesh((k,), ("data",), jax.devices()[:k])``, as
``tests/test_elastic.py:_zero_trainer`` does; the port runs K in-process
ranks on the CPU (``make_mesh((k,), ("data",), ["cpu"] * k)``).  Both
start from the same weights (the reference's, carried by position) and
train 3 steps of SGD+momentum (lr 0.1, momentum 0.9) on the same seeded
batches.  Models: ``_zero_trainer``'s MLP (16 -> 32 relu -> 10, batch
24) and a small conv net with BatchNorm (conv 3x3 8 -> BN -> relu ->
global pool -> dense 10, batch 16 x 3 x 8 x 8), whose per-rank batch
statistics are the case that separates the ZeRO-1 tier from the
replicated one.

Tolerances: losses 2e-5, parameters and the flat optimizer states 5e-6
(absolute), the padding tail exactly 0, BatchNorm's running statistics
1e-6; the reductions (reduce-scatter, batch statistics, matmuls) are
summed in other orders, nothing else differs.  The port's zero=1 against
its own zero=0 is held to ``test_zero1_matches_replicated_numerics``'
tolerances (loss 1e-4, parameters and momentum rtol 3e-5, atol 3e-6).
bf16 ZeRO-1 is held to the limits of ``tests/test_torch_precision.py``
(losses 7e-3 relative, masters and moving statistics 8e-3 absolute).
``grad_accum`` is held bitwise to the left fold of independently computed
microbatch gradients (``parallel.functional.accumulate_grads``).

Wall at ``-n 6``: ~27 s (seven reference trainers compiled in one
module-scope cache).
"""
import functools

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.parallel import zero as jzero
from mxnet_tpu.parallel.mesh import make_mesh as jmake_mesh
from mxnet_tpu.parallel.trainer import DataParallelTrainer as JaxTrainer
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.ops import fused_optimizer as F
from mxnet_tpu_torch.parallel import DataParallelTrainer, Mesh, make_mesh
from mxnet_tpu_torch.parallel import zero as tzero
from mxnet_tpu_torch.parallel.functional import accumulate_grads

SGD = {"learning_rate": 0.1, "momentum": 0.9}
STEPS = 3
LOSS_TOL, PARAM_TOL, STAT_TOL = 2e-5, 5e-6, 1e-6
BF16_LOSS_RTOL, BF16_ATOL = 7e-3, 8e-3
SHAPES = {"mlp": ((24, 16), 10), "conv": ((16, 3, 8, 8), 10)}


def _net(g, model):
    net = g.nn.HybridSequential()
    if model == "mlp":
        net.add(g.nn.Dense(32, activation="relu"))
        net.add(g.nn.Dense(10))
    else:
        net.add(g.nn.Conv2D(8, 3, padding=1))
        net.add(g.nn.BatchNorm())
        net.add(g.nn.Activation("relu"))
        net.add(g.nn.GlobalAvgPool2D())
        net.add(g.nn.Dense(10))
    return net


def _batches(model, n=STEPS, seed=0):
    shape, classes = SHAPES[model]
    rng = np.random.RandomState(seed)
    return [(rng.rand(*shape).astype(np.float32),
             rng.randint(0, classes, shape[0]).astype(np.int64))
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _reference(model, k, zero=1, grad_accum=1, dtype=None):
    """(initial arrays, losses, final arrays, full flat states or None,
    plan description or None) of the reference trainer."""
    mx.random.seed(3)
    np.random.seed(3)
    net = _net(jgluon, model)
    net.initialize(mx.init.Xavier())
    x0 = _batches(model)[0][0]
    net(mx.nd.array(x0[:1]))
    init = [p.data().asnumpy().copy() for p in net.collect_params().values()]
    tr = JaxTrainer(net, jgluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                    dict(SGD), mesh=jmake_mesh((k,), ("data",),
                                               jax.devices()[:k]),
                    zero=zero, grad_accum=grad_accum, dtype=dtype)
    losses = [float(tr.step(mx.nd.array(x), mx.nd.array(y)).asnumpy())
              for x, y in _batches(model)]
    tr.flush()
    final = [np.asarray(p.data()._data).astype(np.float32)
             for p in net.collect_params().values()]
    states = plan = None
    if zero:
        states = [np.asarray(v) for v in tr._zero_leaves()]
        plan = tr._zero_plan.describe()
        if dtype is not None:
            states.append(np.asarray(tr._zero_master))
    return init, losses, final, states, plan


def _port(model, k, zero=1, grad_accum=1, dtype=None, init=None):
    net = _net(gluon, model)
    net.initialize(ctx="cpu")
    x0 = _batches(model)[0][0]
    net(torch.from_numpy(x0[:1]))
    if init is None:
        init = _reference(model, k, zero, grad_accum, dtype)[0]
    for p, a in zip(net.collect_params().values(), init):
        p.set_data(a)
    tr = DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                             "sgd", dict(SGD),
                             mesh=make_mesh((k,), ("data",), ["cpu"] * k),
                             zero=zero, grad_accum=grad_accum, dtype=dtype)
    return net, tr


def _run(tr, model, steps=STEPS):
    losses = [float(tr.step(x, y)) for x, y in _batches(model)[:steps]]
    tr.flush()
    return losses


def _arrays(net):
    return [p.tensor().detach().float().numpy()
            for p in net.collect_params().values()]


def _full_states(tr):
    return [v.numpy() for v in tr._zero_leaves()]


# -- the layout -----------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_zero1_plan_and_reshard_round_trip_match_reference(k):
    names = ["a", "b", "c"]
    shapes = [(3, 5), (7,), (2, 2, 3)]
    dtypes = ["float32"] * 3
    mine = tzero.Zero1Plan(names, shapes, dtypes, "data", k)
    theirs = jzero.Zero1Plan(names, shapes, dtypes, "data", k)
    assert mine.describe() == theirs.describe()
    assert mine.padded % k == 0 and mine.padded - mine.total < k
    full = np.random.RandomState(k).randn(mine.total).astype(np.float32)
    shards = tzero.reshard_full(full, k)
    for a, b in zip(shards, jzero.reshard_full(full, k)):
        assert a.tobytes() == b.tobytes()
    back = tzero.reassemble_state(shards, mine.total)
    assert back.tobytes() == full.tobytes()
    # every other fleet size round-trips bitwise too
    for k2 in (1, 2, 3, 4):
        again = tzero.reassemble_state(
            tzero.reshard_full(back, k2), mine.total)
        assert again.tobytes() == full.tobytes()
    flat = tzero._flatten_pad([torch.from_numpy(full[:15]).view(3, 5),
                               torch.from_numpy(full[15:22]),
                               torch.from_numpy(full[22:]).view(2, 2, 3)],
                              mine)
    assert flat.shape == (mine.padded,) and not flat[mine.total:].any()
    for t, s in zip(tzero._unflatten(flat, mine), shapes):
        assert tuple(t.shape) == s


# -- zero=1 against the reference's zero=1 ----------------------------------
@pytest.mark.parametrize("model", ["mlp", "conv"])
@pytest.mark.parametrize("k", [2, 4])
def test_zero1_matches_reference(model, k):
    init, ref_losses, ref_final, ref_states, ref_plan = _reference(model, k)
    net, tr = _port(model, k)
    before = F.launch_counts()
    losses = _run(tr, model)
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=LOSS_TOL)
    names = list(net.collect_params())
    aux = {i for i, n in enumerate(names) if "running" in n}
    for i, (a, b) in enumerate(zip(_arrays(net), ref_final)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=STAT_TOL if i in aux else PARAM_TOL,
                                   err_msg=names[i])
    plan = tr._zero_plan
    mine = dict(plan.describe(), names=None)
    assert mine == dict(ref_plan, names=None)
    for a, b in zip(_full_states(tr), ref_states):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_TOL)
        assert not a[plan.total:].any() and not b[plan.total:].any()
    # every rank holds a (shard,) state of its own, in its own storage
    ptrs = set()
    for i in range(k):
        for leaf in tr._zero_leaves(i):
            assert tuple(leaf.shape) == (plan.shard,)
            ptrs.add(leaf.data_ptr())
    assert len(ptrs) == k
    # the parameters are views of the flat live buffer, padding zero
    flat = tr._zero_flat
    assert not flat[plan.total:].any()
    assert all(flat.data_ptr() <= t.data_ptr() < flat.data_ptr()
               + 4 * plan.padded for t in tr._zero_tensors)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert F.launch_counts() == before


def test_zero1_matches_replicated_numerics():
    """The port's zero=1 lands on its zero=0's parameters and momentum
    (``tests/test_elastic.py::test_zero1_matches_replicated_numerics``'
    tolerances); the MLP has no batch statistics, so the per-rank
    forwards and the one whole-batch forward agree."""
    init = _reference("mlp", 4)[0]
    net0, t0 = _port("mlp", 4, zero=0, init=init)
    net1, t1 = _port("mlp", 4, zero=1, init=init)
    l0, l1 = _run(t0, "mlp", 4)[-1], _run(t1, "mlp", 4)[-1]
    assert abs(l0 - l1) < 1e-4
    for a, b in zip(_arrays(net0), _arrays(net1)):
        np.testing.assert_allclose(a, b, rtol=3e-5, atol=3e-6)
    flat = np.concatenate([v.numpy() for v in t1._zero_leaves()])
    per = np.concatenate([s.numpy().ravel() for s in t0._states])
    total = t1._zero_plan.total
    np.testing.assert_allclose(flat[:total], per, rtol=3e-5, atol=3e-6)
    assert np.all(flat[total:] == 0.0)


# -- grad_accum ------------------------------------------------------------
@pytest.mark.parametrize("zero", [0, 1])
def test_grad_accum_matches_reference(zero):
    init, ref_losses, ref_final, ref_states, _ = _reference(
        "conv", 2, zero=zero, grad_accum=2)
    net, tr = _port("conv", 2, zero=zero, grad_accum=2, init=init)
    losses = _run(tr, "conv")
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=LOSS_TOL)
    names = list(net.collect_params())
    for i, (a, b) in enumerate(zip(_arrays(net), ref_final)):
        np.testing.assert_allclose(
            a, b, rtol=0, atol=STAT_TOL if "running" in names[i]
            else PARAM_TOL, err_msg=names[i])
    if zero:
        for a, b in zip(_full_states(tr), ref_states):
            np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_TOL)


@pytest.mark.parametrize("zero", [0, 1])
def test_grad_accum_is_the_left_fold_of_microbatch_gradients(zero):
    """One grad_accum=2 step's gradient is bitwise ``(g1 + g2) / 2`` of
    the two half-batch gradients computed apart (``accumulate_grads``),
    on both tiers; so is its SGD update (momentum 0, lr 1)."""
    x, y = _batches("mlp", 1)[0]
    init = _reference("mlp", 2)[0]
    grads = []
    for xm, ym in ((x[:12], y[:12]), (x[12:], y[12:])):
        net, _ = _port("mlp", 1, zero=0, init=init)
        params = [p.tensor() for p in net.collect_params().values()]
        out = net(torch.from_numpy(xm))
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            out, torch.from_numpy(ym)).mean()
        grads.append(torch.autograd.grad(loss, params))
    it = iter(grads)
    summed, _, _ = accumulate_grads(
        lambda xm, ym: (torch.zeros(()), (), next(it)), x, y, 2)
    want = [g / 2 for g in summed]
    net, tr = _port("mlp", 1, zero=zero, grad_accum=2, init=init)
    tr._opt.momentum = 0.0
    tr._opt.lr = 1.0
    before = [p.tensor().detach().clone()
              for p in net.collect_params().values()]
    tr.step(x, y)
    rows = tr._zero_rows[0] if zero else tr._g_flat[0]
    flat = torch.cat([g.reshape(-1) for g in want])
    assert rows[:flat.numel()].numpy().tobytes() == flat.numpy().tobytes()
    for p, w0, g in zip(net.collect_params().values(), before, want):
        assert p.tensor().detach().numpy().tobytes() == \
            (w0 - g).numpy().tobytes()


# -- bf16 ------------------------------------------------------------------
def test_bf16_zero1_within_precision_limits():
    init, ref_losses, ref_final, ref_states, _ = _reference(
        "conv", 2, dtype="bf16")
    net, tr = _port("conv", 2, dtype="bf16", init=init)
    losses = _run(tr, "conv")
    np.testing.assert_allclose(losses, ref_losses, rtol=BF16_LOSS_RTOL)
    # live parameters are bf16 views of the flat buffer; the f32 masters
    # exist only as each rank's (shard,) slice
    plan = tr._zero_plan
    assert tr._zero_flat.dtype == torch.bfloat16
    assert [tuple(m.shape) for m in tr._zero_master] == [(plan.shard,)] * 2
    masters = torch.cat(tr._zero_master).numpy()
    np.testing.assert_allclose(masters, ref_states[-1], rtol=0,
                               atol=BF16_ATOL)
    names = list(net.collect_params())
    for i, (a, b) in enumerate(zip(_arrays(net), ref_final)):
        if "running" in names[i]:
            np.testing.assert_allclose(a, b, rtol=0, atol=BF16_ATOL,
                                       err_msg=names[i])
    assert tr.loss_scale_state()[2] == 0


# -- refusals --------------------------------------------------------------
def test_zero1_rejects_bad_configs():
    net = gluon.nn.Dense(4)
    net.initialize(ctx="cpu")
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    with pytest.raises(ValueError, match="elementwise"):
        DataParallelTrainer(net, loss, "lbsgd", {}, zero=1, device="cpu")
    with pytest.raises(ValueError, match="zero"):
        DataParallelTrainer(net, loss, "sgd", {}, zero=2, device="cpu")
    with pytest.raises(ValueError, match="grad_accum"):
        DataParallelTrainer(net, loss, "sgd", {}, grad_accum=2,
                            dtype="bf16", device="cpu")
    with pytest.raises(ValueError, match="grad_accum must be"):
        DataParallelTrainer(net, loss, "sgd", {}, grad_accum=0,
                            device="cpu")
    # a multi-process store (item 6(b)) refuses what the reference's does
    from mxnet_tpu_torch import kvstore as kvs

    def store(kind="dist_sync", **set_up):
        kv = kvs.create(kind)
        kv._num_workers = 2          # as under a launcher of 2 workers
        for k, v in set_up.items():
            getattr(kv, k)(v)
        return kv
    for kw, match in (({"zero": 1}, "zero=1"), ({"grad_accum": 2},
                                                 "grad_accum"),
                      ({"dtype": "bf16"}, "bf16")):
        with pytest.raises(ValueError, match=match):
            DataParallelTrainer(net, loss, "sgd", {}, kvstore=store(),
                                device="cpu", **kw)
    for kv, match in ((store("dist_async"), "synchronous"),
                      (store(set_optimizer="sgd"), "updater"),
                      (store(set_gradient_compression={"type": "2bit"}),
                       "compression")):
        with pytest.raises(ValueError, match=match):
            DataParallelTrainer(net, loss, "sgd", {}, kvstore=kv,
                                device="cpu")
    # one process: the store is rank 0 of 1 and the plain tier trains
    assert DataParallelTrainer(net, loss, "sgd", {}, kvstore="dist_sync",
                               device="cpu")._kv is None
    with pytest.raises(ValueError, match="divide by the data axis"):
        _, tr = _port("mlp", 4)
        tr.step(np.zeros((6, 16), np.float32), np.zeros(6, np.int64))
    # per-parameter multipliers cannot ride one flat update
    net2 = _net(gluon, "mlp")
    net2.initialize(ctx="cpu")
    net2(torch.zeros(1, 16))
    list(net2.collect_params().values())[0].lr_mult = 2.0
    tr = DataParallelTrainer(net2, loss, "sgd", dict(SGD), zero=1,
                             mesh=make_mesh((2,), ("data",), ["cpu"] * 2))
    with pytest.raises(ValueError, match="lr_mult"):
        tr.step(*_batches("mlp", 1)[0])
    # in-process ranks run in turn on one device
    devs = np.empty(2, dtype=object)
    devs[:] = [torch.device("cpu"), torch.device("meta")]
    with pytest.raises(ValueError, match="one device"):
        Mesh(devs, ("data",)).comm()
