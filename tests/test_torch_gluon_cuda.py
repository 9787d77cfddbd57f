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
CPU half of that rule is in ``tests/test_torch_ndarray.py``).
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
