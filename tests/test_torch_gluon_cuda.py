"""The Gluon imperative path of mxnet_tpu_torch on the card (marked
``cuda``; skipped without one).  This file imports no JAX, so it runs on
the GPU host:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_gluon_cuda.py

An NDArray and a block's parameters are created on the card when no
``ctx`` is given, ``backward`` runs there, and a ``Trainer`` step
launches none of the port's hand kernels (B1-B10): the reference's
Gluon update goes per parameter through ``sgd_mom_update`` and reaches
no ``pallas_call``.  Without a card the same entry points raise (the
CPU half of that rule is in ``tests/test_torch_ndarray.py``).  A
channels-last ``Conv2D`` runs on cuDNN with no layout transpose, and its
OHWI weight's gradient comes back in the weight's own layout.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch import autograd, gluon, initializer, nd
from mxnet_tpu_torch.ops import fused_optimizer, generated_kernels
from mxnet_tpu_torch.ops import pallas_kernels

COUNTERS = (fused_optimizer, pallas_kernels, generated_kernels)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _convnet():
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(gluon.nn.Conv2D(8, 3, padding=1), gluon.nn.BatchNorm(),
                gluon.nn.Activation("relu"), gluon.nn.GlobalAvgPool2D(),
                gluon.nn.Dense(5))
    return net


@pytest.mark.cuda
def test_arrays_and_parameters_are_made_on_the_card(card):
    x = nd.array(np.ones((2, 3)))
    assert x.context.type == "cuda"
    assert nd.zeros((2,)).context.type == "cuda"
    net = _convnet()
    net.initialize(initializer.Xavier(), rng=np.random.RandomState(0))
    net(nd.array(np.random.RandomState(1).rand(2, 3, 8, 8)))
    assert {p.data().context.type
            for p in net.collect_params().values()} == {"cuda"}


@pytest.mark.cuda
def test_backward_on_the_card_matches_the_cpu(card):
    a = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    grads = []
    for ctx in ("cuda", "cpu"):
        x = nd.array(a, ctx=ctx)
        x.attach_grad()
        with autograd.record():
            y = (x.exp() * x).sum()
        y.backward()
        assert x.grad.context.type == ctx
        grads.append(x.grad.asnumpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_trainer_step_launches_no_hand_kernel(card):
    net = _convnet()
    net.initialize(initializer.Xavier(), rng=np.random.RandomState(0))
    x = nd.array(np.random.RandomState(3).rand(4, 3, 8, 8))
    y = nd.array([0, 1, 2, 3])
    net(x)
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    before = [m.launch_counts() for m in COUNTERS]
    w0 = net.collect_params()[net.prefix + "dense0_weight"].data().asnumpy()
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    loss.backward()
    tr.step(4)
    torch.cuda.synchronize()
    assert [m.launch_counts() for m in COUNTERS] == before
    w = net.collect_params()[net.prefix + "dense0_weight"]
    assert w.grad().context.type == "cuda" and w.grad().asnumpy().any()
    assert not np.array_equal(w.data().asnumpy(), w0)


# cuDNN's layout transposes, by kernel name
TRANSPOSES = ("nchwtonhwc", "nhwctonchw", "transpose")


@pytest.mark.cuda
def test_nhwc_conv_runs_channels_last_without_transposes(card):
    """A channels-last ``Conv2D`` on the card: the output is contiguous
    NHWC (channels-last strides as the NCHW view cuDNN sees), no layout
    transpose kernel runs in its forward and backward, and the OHWI
    weight's gradient has the weight's shape and strides."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    conv = gluon.nn.Conv2D(64, 3, padding=1, layout="NHWC", in_channels=64)
    conv.initialize(initializer.Xavier(), rng=np.random.RandomState(0))
    rng = np.random.RandomState(4)
    x = nd.array(rng.rand(8, 28, 28, 64))
    head = nd.array(rng.randn(8, 28, 28, 64))

    def step():
        with autograd.record():
            y = conv(x)
            total = (y * head).sum()
        total.backward()
        return y

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = step()
        torch.cuda.synchronize()
    names = [e.key.lower() for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    assert names, "the profiler recorded no device kernel"
    assert not [n for n in names if any(t in n for t in TRANSPOSES)], names
    out = y._data
    assert out.shape == (8, 28, 28, 64) and out.is_contiguous()
    assert out.movedim(-1, 1).is_contiguous(
        memory_format=torch.channels_last)
    w = conv.weight.tensor()
    assert w.shape == (64, 3, 3, 64) and w.grad.shape == w.shape
    assert w.grad.is_contiguous() and w.grad.stride() == w.stride()
