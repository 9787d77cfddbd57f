"""One rank per process: ``DataParallelTrainer`` over a
``torch.distributed`` process group (gloo on the CPU) against the same
trainer over in-process ranks.

Two processes, each holding one rank of ``data_parallel_mesh()`` and
feeding its own half of every batch, train ``_zero_trainer``'s MLP 3
steps on both tiers (replicated: buckets, loss and mutated state
all-reduced; ZeRO-1: ``reduce_scatter_tensor`` / ``all_gather_into_tensor``,
each process holding one ``(shard,)`` state).  Their losses and
parameters are held to in-process K = 2 at 1e-6 (the same sums, in other
groupings).  A sharded checkpoint written by the process group (rank 0
writes every shard, gathered) restores into an in-process K = 2 trainer
bitwise.  At world size 1 the process-group ZeRO-1 step equals the
in-process K = 1 step bitwise (what ``chip_smoke.py`` phase 32 (f)
checks over NCCL on the card).  The process group rendezvous through a
file store: no network.

Wall at ``-n 6``: ~20 s (three subprocesses of the port).
"""
import os
import subprocess
import sys

import numpy as np

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SGD = {"learning_rate": 0.1, "momentum": 0.9}
TOL = 1e-6

_SCRIPT = """
import sys
import numpy as np
import torch.distributed as dist
rank, world, store, out, ck = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.parallel import DataParallelTrainer, data_parallel_mesh
from mxnet_tpu_torch.parallel.comm import ProcessGroupComm
res = {}
for zero in (0, 1):
    mxt.random.seed(3); np.random.seed(3)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(32, activation="relu"))
    net.add(gluon.nn.Dense(10))
    net.initialize(mxt.init.Xavier(), ctx="cpu")
    mesh = data_parallel_mesh()
    assert mesh.process_group and mesh.size == world
    tr = DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                             "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                             mesh=mesh, zero=zero)
    assert isinstance(tr._comm, ProcessGroupComm)
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(3):
        x = rng.rand(24, 16).astype(np.float32)
        y = rng.randint(0, 10, 24).astype(np.int64)
        b = 24 // world
        rows = slice(rank * b, (rank + 1) * b)
        losses.append(float(tr.step(x[rows], y[rows])))
    tr.flush()
    res["loss%d" % zero] = np.array(losses)
    for i, p in enumerate(net.collect_params().values()):
        res["p%d_%d" % (zero, i)] = p.tensor().detach().numpy()
    if zero:
        assert len(tr._zero_states) == 1
        res["shard"] = np.array(tr._zero_plan.shard)
        res["state_numel"] = np.array(tr._zero_leaves(0)[0].numel())
        path = tr.save_checkpoint(ck, epoch=0, nbatch=2)
        assert (path is None) == (rank != 0)
np.savez(out, **res)
dist.destroy_process_group()
"""


def _run_world(tmp_path, world):
    store = str(tmp_path / ("store%d" % world))
    ck = str(tmp_path / ("ck%d" % world))
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    outs = [str(tmp_path / ("out%d_%d.npz" % (world, r)))
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SCRIPT, str(r), str(world), store, outs[r],
         ck], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return [dict(np.load(o)) for o in outs], ck


def _in_process(k, zero):
    mxt.random.seed(3)
    np.random.seed(3)
    net = _mlp()
    tr = DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                             "sgd", dict(SGD),
                             mesh=make_mesh((k,), ("data",), ["cpu"] * k),
                             zero=zero)
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(3):
        x = rng.rand(24, 16).astype(np.float32)
        y = rng.randint(0, 10, 24).astype(np.int64)
        losses.append(float(tr.step(x, y)))
    tr.flush()
    return tr, np.array(losses), [p.tensor().detach().numpy()
                                  for p in net.collect_params().values()]


def test_two_gloo_processes_match_in_process_ranks(tmp_path):
    res, ck = _run_world(tmp_path, 2)
    for zero in (0, 1):
        _, losses, params = _in_process(2, zero)
        for r in res:
            np.testing.assert_allclose(r["loss%d" % zero], losses, rtol=0,
                                       atol=TOL)
            for i, p in enumerate(params):
                np.testing.assert_allclose(r["p%d_%d" % (zero, i)], p,
                                           rtol=0, atol=TOL)
        # every process holds the same parameters, bitwise
        for i in range(len(params)):
            assert res[0]["p%d_%d" % (zero, i)].tobytes() == \
                res[1]["p%d_%d" % (zero, i)].tobytes()
    assert int(res[0]["state_numel"]) == int(res[0]["shard"])
    # the process group's sharded checkpoint restores in process, bitwise
    fresh = DataParallelTrainer(
        _mlp(), gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        dict(SGD), mesh=make_mesh((2,), ("data",), ["cpu"] * 2), zero=1)
    fresh.restore_checkpoint(ck)
    for i, p in enumerate(fresh._params_by_name.values()):
        assert p.tensor().detach().numpy().tobytes() == \
            res[0]["p1_%d" % i].tobytes()


def _mlp():
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(32, activation="relu"))
    net.add(gluon.nn.Dense(10))
    net.initialize(mxt.init.Xavier(), ctx="cpu")
    return net


def test_world_size_one_equals_in_process_k1_bitwise(tmp_path):
    (res,), _ = _run_world(tmp_path, 1)
    for zero in (0, 1):
        _, losses, params = _in_process(1, zero)
        assert res["loss%d" % zero].tobytes() == losses.tobytes()
        for i, p in enumerate(params):
            assert res["p%d_%d" % (zero, i)].tobytes() == p.tobytes()
