"""Training through Symbol, Executor and Module in mxnet_tpu_torch on the
card (marked ``cuda``; skipped without one).  This file imports no JAX,
so it runs on the GPU host:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_module_cuda.py

``Module(context=None)`` binds on the card; one ``forward_backward`` +
``update`` there is held to the same step on the CPU of the card's host
(TF32 off: outputs, gradients and updated parameters within 1e-5), and
launches none of the port's hand kernels (B1-B10): the reference's
Module update goes per parameter through the optimizer's updater and
reaches no ``pallas_call``.  ``Executor.backward`` of a fixed-gamma
BatchNorm gives zeros for gamma on the card too.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import fused_optimizer, generated_kernels
from mxnet_tpu_torch.ops import pallas_kernels

COUNTERS = (fused_optimizer, pallas_kernels, generated_kernels)
TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _net():
    data = mx.sym.Variable("data")
    c = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                           name="conv")
    b = mx.sym.BatchNorm(c, fix_gamma=True, name="bn")
    a = mx.sym.Activation(b, act_type="relu", name="relu")
    p = mx.sym.Pooling(a, global_pool=True, kernel=(1, 1), pool_type="avg",
                       name="pool")
    f = mx.sym.FullyConnected(mx.sym.Flatten(p, name="flat"), num_hidden=5,
                              name="fc")
    return mx.sym.SoftmaxOutput(f, name="softmax")


def _step(context, arg, x, y):
    mod = mx.mod.Module(_net(), context=context)
    mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
    mod.init_params(arg_params=arg)
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9, "wd": 1e-4})
    for m in COUNTERS:
        m.reset_launch_counts()
    batch = mx.io.DataBatch([mx.nd.array(x, ctx="cpu")],
                            [mx.nd.array(y, ctx="cpu")])
    mod.forward_backward(batch)
    grads = {k: v.asnumpy() for k, v in mod._exec.grad_dict.items()}
    out = mod.get_outputs()[0].asnumpy()
    mod.update()
    launched = {k: v for m in COUNTERS for k, v in m.launch_counts().items()
                if v}
    return mod, out, grads, {k: v.asnumpy() for k, v in
                             mod.get_params()[0].items()}, launched


@pytest.mark.cuda
def test_module_step_on_the_card_matches_the_cpu(card):
    rng = np.random.RandomState(0)
    x = rng.rand(4, 3, 8, 8).astype(np.float32)
    y = rng.randint(0, 5, 4).astype(np.float32)
    ref = mx.mod.Module(_net(), context="cpu")
    ref.bind([("data", x.shape)], [("softmax_label", y.shape)])
    ref.init_params(mx.init.Xavier(), rng=np.random.RandomState(1))
    arg = {k: v.asnumpy() for k, v in ref.get_params()[0].items()}
    card_run = _step(None, arg, x, y)
    cpu_run = _step("cpu", arg, x, y)
    assert card_run[0].context.type == "cuda"
    assert card_run[4] == {}, "a hand kernel launched: %r" % card_run[4]
    np.testing.assert_allclose(card_run[1], cpu_run[1], rtol=TOL, atol=TOL)
    for n in cpu_run[2]:
        np.testing.assert_allclose(card_run[2][n], cpu_run[2][n], rtol=TOL,
                                   atol=TOL, err_msg=n)
        np.testing.assert_allclose(card_run[3][n], cpu_run[3][n], rtol=TOL,
                                   atol=TOL, err_msg=n)
    assert not card_run[2]["bn_gamma"].any()
