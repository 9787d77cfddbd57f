"""mxnet_tpu_torch.gluon: layers, the loss and ResNet-50 v1 held against
mxnet_tpu.gluon.

Each layer is built in both packages; the reference's parameters (made
non-trivial with seeded numpy values) are carried into the port with
``gluon.utils.from_jax_params``, and the same seeded input goes through
both.  The reference differentiates with its autograd (``jax.vjp``
underneath), the port with torch autograd, both from the same head
gradient.

Tolerances (f32): layers 1e-5 absolute — the two frameworks sum the
convolution, matmul and BatchNorm reductions in different orders,
nothing else differs.  ResNet-50 logits 1e-4 absolute: 53 convolutions
and BatchNorms in a row carry those rounding differences forward.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.utils import from_jax_params, relative_names

TOL = 1e-5
LOGIT_TOL = 1e-4


def _carry(jblock, tblock, x, seed):
    """Resolve the reference's deferred shapes with one inference
    forward, give every parameter seeded values (running_var > 0), and
    load them into the port's block on the CPU."""
    jblock(mx.nd.array(x))
    rng = np.random.RandomState(seed)
    for name, p in jblock.collect_params().items():
        v = rng.randn(*p.shape).astype(np.float32) * 0.5
        if name.endswith("running_var"):
            v = np.abs(v) + 0.5
        p.set_data(mx.nd.array(v))
    arrays = {n: p.data().asnumpy()
              for n, p in jblock.collect_params().items()}
    from_jax_params(tblock, arrays, device="cpu")
    return arrays


def _both(jblock, tblock, x, train, seed=0):
    """Forward + backward of both blocks from one head gradient:
    ``[(ref, port)]`` pairs for the output, the input gradient and each
    trainable parameter's gradient, then the aux states after the call."""
    head = np.random.RandomState(seed + 1).randn(
        *jblock(mx.nd.array(x)).shape).astype(np.float32)
    xj = mx.nd.array(x)
    xj.attach_grad()
    with mx.autograd.record(train_mode=train):
        yj = jblock(xj)
    yj.backward(mx.nd.array(head))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    tblock.train(train)
    yt = tblock(xt)
    yt.backward(torch.from_numpy(head))
    pairs = [(yj.asnumpy(), yt.detach().numpy()),
             (xj.grad.asnumpy(), xt.grad.numpy())]
    jp, tp = jblock.collect_params(), tblock.collect_params()
    jrel = relative_names(list(jp.keys()), jblock.prefix)
    trel = relative_names(list(tp.keys()), tblock.prefix)
    assert sorted(jrel) == sorted(trel)
    aux = []
    for rel in sorted(jrel):
        pj, pt = jp[jrel[rel]], tp[trel[rel]]
        if pj.grad_req == "null":
            aux.append((pj.data().asnumpy(), pt.tensor().numpy()))
        else:
            pairs.append((pj.grad().asnumpy(), pt.grad().asnumpy()))
    return pairs, aux


def _close(pairs):
    for want, got in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


LAYERS = {
    "dense": (lambda g: g.nn.Dense(7), (3, 4, 2, 2)),
    "dense_relu": (lambda g: g.nn.Dense(5, activation="relu", in_units=6),
                   (4, 6)),
    "conv": (lambda g: g.nn.Conv2D(6, 3, strides=2, padding=1), (2, 3, 9, 9)),
    "conv_1x1": (lambda g: g.nn.Conv2D(4, 1, use_bias=False), (2, 5, 6, 6)),
    "maxpool": (lambda g: g.nn.MaxPool2D(3, 2, 1), (2, 3, 9, 9)),
    "maxpool_ceil": (lambda g: g.nn.MaxPool2D(2, 2, 1, ceil_mode=True),
                     (2, 3, 7, 7)),
    "avgpool_ceil": (lambda g: g.nn.AvgPool2D(3, 3, 1, ceil_mode=True),
                     (2, 3, 9, 9)),
    "global_avgpool": (lambda g: g.nn.GlobalAvgPool2D(), (2, 3, 5, 7)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_forward_and_grads_match_reference(name):
    make, shape = LAYERS[name]
    jblock, tblock = make(jgluon), make(gluon)
    jblock.initialize(mx.init.Xavier())
    x = np.random.RandomState(len(name)).randn(*shape).astype(np.float32)
    _carry(jblock, tblock, x, seed=3)
    pairs, aux = _both(jblock, tblock, x, train=True)
    assert not aux
    _close(pairs)


# (n, k, s, p): the reference's "full" output size ceil((n + 2p - k)/s) + 1
# has no clamp, so a last window may lie wholly in the padding
POOL_GEOMETRIES = [(3, 2, 2, 1), (112, 3, 2, 1), (5, 2, 2, 0), (9, 3, 3, 1)]


@pytest.mark.parametrize("pool_type,count_include_pad",
                         [("max", True), ("avg", True), ("avg", False)],
                         ids=["max", "avg_incl_pad", "avg_excl_pad"])
@pytest.mark.parametrize("convention", ["full", "valid"])
@pytest.mark.parametrize("geometry", POOL_GEOMETRIES,
                         ids=["%d_%d_%d_%d" % g for g in POOL_GEOMETRIES])
def test_pooling_convention_matches_reference(geometry, convention,
                                              pool_type, count_include_pad):
    from mxnet_tpu_torch.ops import nn as tnn
    n, k, s, p = geometry
    x = np.random.RandomState(n + k).rand(2, 3, n, n).astype(np.float32)
    params = dict(kernel=(k, k), stride=(s, s), pad=(p, p),
                  pool_type=pool_type, pooling_convention=convention,
                  count_include_pad=count_include_pad)
    want = mx.nd.Pooling(mx.nd.array(x), **params).asnumpy()
    got = tnn.Pooling(torch.from_numpy(x), **params).numpy()
    assert got.shape == want.shape
    # a window wholly in the padding: -inf (max) or 0/0 (avg without the
    # padding) on both sides
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
def test_batchnorm_matches_reference_with_moving_stats(train):
    """Train mode: batch statistics (biased variance), the output, the
    gradients and the moving update ``0.9*moving + 0.1*batch``.  Inference
    mode: the moving statistics, unchanged."""
    jblock, tblock = jgluon.nn.BatchNorm(), gluon.nn.BatchNorm()
    jblock.initialize()
    x = (np.random.RandomState(2).randn(4, 5, 3, 3) * 2 + 1).astype(
        np.float32)
    before = _carry(jblock, tblock, x, seed=4)
    pairs, aux = _both(jblock, tblock, x, train=train)
    _close(pairs + aux)
    mean_name = [n for n in before if n.endswith("running_mean")][0]
    moved = not np.array_equal(aux[0][1], before[mean_name])
    assert moved == train
    if train:
        want = 0.9 * before[mean_name] + 0.1 * x.mean(axis=(0, 2, 3))
        np.testing.assert_allclose(aux[0][1], want, rtol=0, atol=TOL)


def test_softmax_cross_entropy_matches_reference():
    rng = np.random.RandomState(9)
    pred = rng.randn(6, 11).astype(np.float32) * 3
    label = rng.randint(0, 11, 6)
    pj = mx.nd.array(pred)
    pj.attach_grad()
    with mx.autograd.record():
        lj = jgluon.loss.SoftmaxCrossEntropyLoss()(pj, mx.nd.array(label))
    lj.backward()
    pt = torch.from_numpy(pred).requires_grad_()
    lt = gluon.loss.SoftmaxCrossEntropyLoss()(pt, torch.from_numpy(label))
    lt.backward(torch.ones_like(lt))
    assert lt.shape == (6,)
    _close([(lj.asnumpy(), lt.detach().numpy()),
            (pj.grad.asnumpy(), pt.grad.numpy())])


@pytest.fixture(scope="module")
def resnet50_pair():
    np.random.seed(0)
    jnet = jvision.resnet50_v1()
    jnet.initialize(mx.init.Xavier())
    return jnet, vision.resnet50_v1()


def test_resnet50_names_and_shapes_equal_reference(resnet50_pair):
    jnet, tnet = resnet50_pair
    x = np.zeros((1, 3, 64, 64), np.float32)
    jnet(mx.nd.array(x))
    tnet.initialize(ctx="cpu", rng=np.random.RandomState(0))
    with torch.no_grad():
        tnet(torch.from_numpy(x))
    jp, tp = jnet.collect_params(), tnet.collect_params()
    jrel = relative_names(list(jp.keys()), jnet.prefix)
    trel = relative_names(list(tp.keys()), tnet.prefix)
    assert list(jrel) == list(trel) and len(trel) == 299
    for rel in jrel:
        p = tp[trel[rel]]
        assert tuple(p.shape) == tuple(jp[jrel[rel]].shape), rel
        assert tuple(p.data().shape) == tuple(p.shape)
        assert p.grad_req == jp[jrel[rel]].grad_req
    # the reference's quirks are kept: 1x1 bottleneck body convs carry a
    # bias, the downsample convs do not
    assert "stage1_conv2d0_bias" in trel and "stage1_conv2d3_bias" not in trel


def test_resnet50_forward_with_carried_weights_matches_reference(
        resnet50_pair):
    jnet, _ = resnet50_pair
    x = np.random.RandomState(1).rand(1, 3, 64, 64).astype(np.float32)
    jnet(mx.nd.array(x))
    arrays = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tnet = vision.resnet50_v1()
    from_jax_params(tnet, arrays, device="cpu")
    want = jnet(mx.nd.array(x)).asnumpy()
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 1000)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)


def test_from_jax_params_raises_on_missing_extra_and_shape():
    np.random.seed(1)
    jd = jgluon.nn.Dense(3, in_units=4)
    jd.initialize()
    arrays = {n: p.data().asnumpy() for n, p in jd.collect_params().items()}
    wname = [n for n in arrays if n.endswith("weight")][0]
    bad = dict(arrays)
    bad.pop(wname)
    with pytest.raises(MXNetError, match="missing"):
        from_jax_params(gluon.nn.Dense(3, in_units=4), bad, device="cpu")
    bad = dict(arrays, **{wname.replace("weight", "extra"): arrays[wname]})
    with pytest.raises(MXNetError, match="extra"):
        from_jax_params(gluon.nn.Dense(3, in_units=4), bad, device="cpu")
    with pytest.raises(MXNetError, match="shape"):
        from_jax_params(gluon.nn.Dense(3, in_units=5), arrays, device="cpu")
    # names match relative to the block prefix, whatever its counter
    td = from_jax_params(gluon.nn.Dense(3), arrays, device="cpu")
    assert torch.equal(td.weight.tensor(),
                       torch.from_numpy(np.array(arrays[wname])))


def test_unported_layouts_and_models_raise():
    """Every layout and every zoo name is ported now: channels-last
    layers and resnet101_v1 build; what is still unported raises, naming
    its ROADMAP item, and an unknown model name raises ValueError."""
    conv = gluon.nn.Conv2D(4, 3, layout="NHWC", in_channels=2)
    assert conv.weight.shape == (4, 3, 3, 2)
    assert isinstance(vision.get_model("resnet101_v1"), vision.ResNetV1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gluon.contrib.nn.SparseEmbedding(10, 4)
    with pytest.raises(ValueError):
        vision.get_model("resnet7_v1")
    assert isinstance(vision.get_model("resnet18_v1", classes=10),
                      vision.ResNetV1)


def test_hybridize_records_signatures_and_block_is_a_module():
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(4, activation="relu"), gluon.nn.Dense(2))
    net.initialize(ctx="cpu", rng=np.random.RandomState(0))
    net.hybridize()
    x = torch.zeros(3, 5)
    net(x)
    net(x)
    assert len(net.jit_cache_keys()) == 1       # one signature, no growth
    net(torch.zeros(2, 5))
    assert len(net.jit_cache_keys()) == 2
    assert isinstance(net, torch.nn.Module)
    assert sum(p.numel() for p in net.parameters()) == 5 * 4 + 4 + 4 * 2 + 2
    with pytest.raises(NotImplementedError, match="ctx="):
        net.to("cpu")
