"""mxnet_tpu_torch.parallel.DataParallelTrainer held against
mxnet_tpu.parallel.trainer.DataParallelTrainer.

A narrow bottleneck ResNet v1 (``[1, 1, 1, 1]`` blocks, widths
16-256, 10 classes, thumbnail) on a 4 × 3 × 16 × 16 batch.  The
reference is initialized with Xavier under ``np.random.seed(0)``; its
weights and BatchNorm moving statistics are carried into the port, and
both train 3 steps on the same seeded batches.  The reference runs its
fused Pallas update in interpret mode (``MXTPU_FUSED_OPTIMIZER=1``, as
``tests/test_fusion.py`` does) on a one-device mesh; the port runs on the
CPU, where each fused wrapper takes its plain version.

Tolerances (f32), after 3 steps: losses, every parameter and the moving
statistics within 1e-5 absolute — convolution and BatchNorm reductions
are summed in other orders, nothing else differs.  Adam runs with
``epsilon=1e-3``: its step divides each gradient element by its own
magnitude, so with the default 1e-8 an element whose gradient is at the
rounding level (the 1×1 conv biases before a BatchNorm have a gradient
that is zero in exact arithmetic) would turn each framework's rounding
noise into a step of up to ``lr`` of either sign.  An epsilon above the
noise keeps that step proportional to the gradient; every other element
takes the ordinary Adam step.
"""
import functools

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.parallel.mesh import make_mesh
from mxnet_tpu.parallel.trainer import DataParallelTrainer as JaxTrainer
from mxnet_tpu_torch import gluon, lr_scheduler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.utils import from_jax_params, relative_names
from mxnet_tpu_torch.ops import fused_optimizer as F
from mxnet_tpu_torch.parallel import DataParallelTrainer

TOL = 1e-5
STEPS = 3
SHAPE = (4, 3, 16, 16)

CONFIGS = {
    "sgd_momentum": ("sgd", {"learning_rate": 0.05, "momentum": 0.9,
                             "wd": 1e-4}),
    "sgd": ("sgd", {"learning_rate": 0.05, "wd": 1e-4}),
    "adam": ("adam", {"learning_rate": 1e-3, "wd": 1e-4, "epsilon": 1e-3}),
    # lr halves every step: the scheduler is read on the host per step
    "sgd_momentum_factor": ("sgd", {"learning_rate": 0.05, "momentum": 0.9,
                                    "wd": 1e-4, "scheduler": (1, 0.5)}),
}
KERNEL = {"sgd_momentum": "fused_sgd_momentum", "sgd": "fused_sgd",
          "adam": "fused_adam", "sgd_momentum_factor": "fused_sgd_momentum"}


def _make(pkg):
    v = vision if pkg == "port" else jvision
    return v.ResNetV1(v.BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                      classes=10, thumbnail=True)


def _opt_args(config, sched_mod):
    name, params = CONFIGS[config]
    params = dict(params)
    sched = params.pop("scheduler", None)
    if sched is not None:
        params["lr_scheduler"] = sched_mod.FactorScheduler(*sched)
    return name, params


def _batches():
    rng = np.random.RandomState(7)
    return [(rng.rand(*SHAPE).astype(np.float32),
             rng.randint(0, 10, SHAPE[0])) for _ in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _reference(config, fused):
    """(initial arrays, losses, final arrays, groups by relative name) of
    the reference trainer."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXTPU_FUSED_OPTIMIZER", "1" if fused else "0")
        np.random.seed(0)
        net = _make("ref")
        net.initialize(mx.init.Xavier())
        net(mx.nd.array(np.zeros((1,) + SHAPE[1:], np.float32)))
        init = {n: p.data().asnumpy()
                for n, p in net.collect_params().items()}
        name, params = _opt_args(config, jsched)
        tr = JaxTrainer(net, jgluon.loss.SoftmaxCrossEntropyLoss(), name,
                        params, mesh=make_mesh((1,), ("data",),
                                               jax.devices()[:1]))
        losses = [float(tr.step(mx.nd.array(x), mx.nd.array(y)).asnumpy())
                  for x, y in _batches()]
        tr.flush()
        final = {n: p.data().asnumpy()
                 for n, p in net.collect_params().items()}
        rel = relative_names(list(final), net.prefix)
        back = {v: k for k, v in rel.items()}
        groups = [[back[n] for n in g] for g in tr._groups]
    return init, losses, final, groups, net.prefix


def _port_run(config):
    init, _, _, _, _ = _reference(config, True)
    net = _make("port")
    from_jax_params(net, init, device="cpu")
    name, params = _opt_args(config, lr_scheduler)
    tr = DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(), name,
                             params, device="cpu")
    losses, ptrs = [], []
    for x, y in _batches():
        loss = tr.step(x, y)
        assert loss.shape == () and loss.device.type == "cpu"
        losses.append(float(loss))
        ptrs.append([tr._params_by_name[n].tensor().data_ptr()
                     for n in tr._train_names])
    return net, tr, losses, ptrs


def _assert_params(config, net, ref_final, ref_prefix):
    got = {n: p.tensor().detach().numpy()
           for n, p in net.collect_params().items()}
    mine = relative_names(list(got), net.prefix)
    theirs = relative_names(list(ref_final), ref_prefix)
    assert sorted(mine) == sorted(theirs)
    for rel in mine:
        np.testing.assert_allclose(got[mine[rel]], ref_final[theirs[rel]],
                                   rtol=0, atol=TOL, err_msg=rel)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_trainer_matches_reference_fused_trainer(config):
    init, ref_losses, ref_final, ref_groups, ref_prefix = _reference(
        config, True)
    before = F.launch_counts()
    net, tr, losses, ptrs = _port_run(config)
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=TOL)
    assert np.isfinite(losses).all()
    _assert_params(config, net, ref_final, ref_prefix)
    # one bucket, the reference's, in the reference's order
    mine = relative_names(tr._train_names, net.prefix)
    back = {v: k for k, v in mine.items()}
    assert [[back[n] for n in g] for g in tr._groups] == ref_groups
    assert len(tr._groups) == 1
    # the bucket's parameters stay views of its flat buffer across steps
    assert ptrs[0] == ptrs[1] == ptrs[2]
    base = tr._w_flat[0].data_ptr()
    end = base + 4 * tr._w_flat[0].numel()
    assert all(base <= p < end for p in ptrs[0])
    grads = [tr._params_by_name[n].tensor().grad.data_ptr()
             for n in tr._train_names]
    gbase = tr._g_flat[0].data_ptr()
    assert all(gbase <= p < gbase + 4 * tr._g_flat[0].numel()
               for p in grads)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert F.launch_counts() == before


def test_trainer_matches_reference_unfused_trainer():
    """The reference's unfused update (``MXTPU_FUSED_OPTIMIZER=0``) lands
    on the same numbers as its fused kernel and the port."""
    _, ref_losses, ref_final, _, ref_prefix = _reference("sgd_momentum",
                                                         False)
    net, _, losses, _ = _port_run("sgd_momentum")
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=TOL)
    _assert_params("sgd_momentum", net, ref_final, ref_prefix)


def test_trainer_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = _make("port")
    with pytest.raises(MXNetError, match="no CUDA device"):
        DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd")
    with pytest.raises(MXNetError, match="no CUDA device"):
        net.initialize()


@pytest.mark.parametrize("arg,value,item", [
    ("kvstore", "dist_sync", "item 6"), ("zero", 1, "item 6"),
    ("mesh_plan", {"model": 2}, "item 7"),
    ("grad_accum", 2, "item 6"), ("input_transform", abs, "item 3")])
def test_unported_trainer_tiers_raise(arg, value, item):
    if arg == "input_transform":
        # ported by item 3 (A3): the transform runs on the batch first in
        # every step, so a step on -x through abs is the step on x
        x, y = _batches()[0]
        losses = []
        for kw, batch in (({arg: value}, -x), ({}, x)):
            net = _make("port")
            net.initialize(ctx="cpu", rng=np.random.RandomState(0))
            tr = DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                     "sgd", device="cpu", **kw)
            losses.append(float(tr.step(batch, y)))
        assert losses[0] == losses[1]
        return
    with pytest.raises(NotImplementedError, match=item):
        DataParallelTrainer(_make("port"),
                            gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                            device="cpu", **{arg: value})


def test_trainer_refuses_parameters_on_another_device():
    net = _make("port")
    net.initialize(ctx="cpu", rng=np.random.RandomState(0))
    tr = DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                             "sgd", device="cpu")
    tr._device = torch.device("meta")
    x, y = _batches()[0]
    with pytest.raises(MXNetError, match="initialize the block"):
        tr._setup(torch.from_numpy(x))


def test_unfused_route_matches_fused_bucket():
    """An optimizer the fused kernels do not take (a subclass of SGD)
    keeps one group per parameter and the unfused rule
    (``functional_optimizer_update``): same numbers as the fused bucket."""
    from mxnet_tpu_torch import optimizer as topt

    class SubSGD(topt.SGD):
        pass

    init = _reference("sgd_momentum", True)[0]
    nets = []
    for opt in ("sgd", SubSGD(**CONFIGS["sgd_momentum"][1])):
        net = from_jax_params(_make("port"), init, device="cpu")
        tr = DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 opt, CONFIGS["sgd_momentum"][1],
                                 device="cpu")
        losses = [float(tr.step(x, y)) for x, y in _batches()]
        nets.append((net, tr, losses))
    (fused, tf, lf), (unfused, tu, lu) = nets
    assert len(tf._groups) == 1 and len(tu._groups) == len(tu._train_names)
    np.testing.assert_allclose(lu, lf, rtol=0, atol=TOL)
    for a, b in zip(fused.collect_params().values(),
                    unfused.collect_params().values()):
        np.testing.assert_allclose(b.tensor().detach().numpy(),
                                   a.tensor().detach().numpy(), rtol=0,
                                   atol=TOL)


def test_float64_block_trains_on_the_unfused_route():
    init = _reference("sgd_momentum", True)[0]
    net = from_jax_params(_make("port"), init, device="cpu")
    net.cast("float64")
    tr = DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                             "sgd", CONFIGS["sgd_momentum"][1], device="cpu")
    before = F.launch_counts()
    losses = [float(tr.step(x.astype(np.float64), y)) for x, y in _batches()]
    assert np.isfinite(losses).all()
    assert tr._w_flat[0].dtype == torch.float64
    assert all(p.tensor().dtype == torch.float64
               for p in net.collect_params().values())
    assert F.launch_counts() == before
    # the half types are ported: the block casts in place
    net.cast("float16")
    assert all(p.tensor().dtype == torch.float16
               for p in net.collect_params().values())
