"""Shared nets, inputs and checks of the vision model-zoo parity tests
(``test_torch_model_zoo*.py``, split by family so that ``--dist loadfile``
spreads them): the family builders and sizes, the seeded nets (the port's
He init loaded into the reference from the port's ``.params``), the
float32 and float64 checks and their tolerances.  The tests and their
limits are described in ``test_torch_model_zoo.py``."""
import contextlib
import types

import numpy as np

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.gluon.model_zoo.vision import inception as jinception
from mxnet_tpu_torch import autograd, gluon, initializer, nd
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.model_zoo.vision import inception
from mxnet_tpu_torch.gluon.utils import from_jax_params, relative_names

LOGIT_RTOL = 1e-4
PARAM_TOL = 5e-6
F64_TOL = 1e-10
# a stepped weight rounds to its own precision: 2 ulps of it on top
STEP_ULPS = 2
# a family's largest logit at the seeded batch: the signal reached the head
LIVE_LOGIT = 1e-2
LAYOUT_TOL = 1e-5
# the reference's own float32 step sits up to 1.14e-5 of an array's
# largest magnitude from the float64 result (a stage-4 weight gradient,
# its convolutions' sums), above the port's float32 runs
REF_LAYOUT_TOL = 2e-5
SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
# He's init: the variance of each layer's output stays that of its input,
# so the signal reaches MobileNet's head (Xavier's averaged fan of a 3 x 3
# depthwise weight, (9 + 9 C) / 2, shrinks it ~C/2-fold a layer, and the
# logits sink to 1e-20 in predict mode)
HE = initializer.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2)

NAMES = ["resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
         "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
         "resnet101_v2", "resnet152_v2", "vgg11", "vgg13", "vgg16", "vgg19",
         "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn", "alexnet",
         "densenet121", "densenet161", "densenet169", "densenet201",
         "squeezenet1.0", "squeezenet1.1", "inceptionv3", "mobilenet1.0",
         "mobilenet0.75", "mobilenet0.5", "mobilenet0.25",
         "mobilenetv2_1.0", "mobilenetv2_0.75", "mobilenetv2_0.5",
         "mobilenetv2_0.25"]


def _rel(block):
    ps = block.collect_params()
    return relative_names(list(ps.keys()), block.prefix)


# -- one net per family -------------------------------------------------------
def _inception_cut(pkg_inception, nn, classes):
    """Inception v3 past its stem: one block of each kind at its native
    size (35 x 35 -> 17 x 17 -> 8 x 8), then the native head."""
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(pkg_inception._make_A(32, "A1_"),
                pkg_inception._make_B("B_"),
                pkg_inception._make_C(128, "C1_"),
                pkg_inception._make_D("D_"),
                pkg_inception._make_E("E1_"),
                nn.AvgPool2D(pool_size=8), nn.Dropout(0.5),
                nn.Dense(classes))
    return net


def _densenet_cut(v, classes):
    return v.DenseNet(16, 8, [2, 2, 2, 2], classes=classes)


# name -> (make(reference?), input shape, one float32 step in train mode)
FAMILIES = {
    "resnet18_v2": (lambda j: (jvision if j else vision).get_model(
        "resnet18_v2", classes=10), (2, 3, 128, 128), True),
    "vgg11_bn": (lambda j: (jvision if j else vision).get_model(
        "vgg11_bn", classes=10), (2, 3, 32, 32), False),
    "alexnet": (lambda j: (jvision if j else vision).get_model(
        "alexnet", classes=10), (2, 3, 96, 96), False),
    "squeezenet1.1": (lambda j: (jvision if j else vision).get_model(
        "squeezenet1.1", classes=10), (2, 3, 64, 64), False),
    "mobilenet1.0": (lambda j: (jvision if j else vision).get_model(
        "mobilenet1.0", classes=10), (2, 3, 64, 64), False),
    "mobilenetv2_1.0": (lambda j: (jvision if j else vision).get_model(
        "mobilenetv2_1.0", classes=10), (2, 3, 64, 64), False),
    "densenet121": (lambda j: _densenet_cut(jvision if j else vision, 10),
                    (1, 3, 224, 224), True),
    "inceptionv3": (lambda j: _inception_cut(
        jinception if j else inception, (jgluon if j else gluon).nn, 10),
        (1, 192, 35, 35), False),
}
# the families without Dropout, held in train mode in float64
# a float32 step's limit, as a share of the largest move, where PARAM_TOL
# is below what float32 resolves; each package's step was read against
# the float64 step that test_family_matches_reference_in_float64 holds:
# - resnet18_v2 (train mode): the reference's float32 BatchNorm (its
#   one-pass backward, ``mxnet_tpu/ops/nn.py:327-360``) 4.7e-4 from it at
#   ``stage4_conv2d1_weight``, the port's float32 step 2.6e-6;
# - mobilenetv2_1.0: ReLU6 and ReLU gates that float32 rounding flips,
#   the port's step 1.4e-4 from it, the reference's 3.5e-6 (six elements
#   of ``linearbottleneck0_conv2d0_weight`` carry the flips).
F32_STEP_TOL = {"resnet18_v2": 1e-3, "mobilenetv2_1.0": 5e-4}
NO_DROPOUT = ("densenet121", "mobilenet1.0", "mobilenetv2_1.0",
              "resnet18_v2")


def _params(block):
    ps = block.collect_params()
    return {r: ps[n].data().asnumpy() for r, n in _rel(block).items()}


def _step(pkg, net, x, y, train):
    """One Gluon SGD+momentum step; (logits before it, loss)."""
    ag = mx.autograd if pkg is jgluon else autograd
    arr = mx.nd.array if pkg is jgluon else nd.array
    tr = pkg.Trainer(net.collect_params(), "sgd", dict(SGD))
    loss_fn = pkg.loss.SoftmaxCrossEntropyLoss()
    with ag.record(train_mode=train):
        out = net(arr(x, dtype=x.dtype))
        L = loss_fn(out, arr(y, dtype=x.dtype))
    L.backward()
    tr.step(x.shape[0])
    return out.asnumpy(), L.asnumpy()


def _pre_pool(pkg, net, x):
    """The body's last feature map ahead of its global pool (or of the
    flatten), in predict mode: the children of ``net.features`` (of
    ``net`` for the cut inception) run in turn up to the first whose
    output is 2-D or 1 x 1."""
    arr = mx.nd.array if pkg is jgluon else nd.array
    body = getattr(net, "features", net)
    h = arr(x, dtype=x.dtype)
    for child in body._children.values():
        out = child(h)
        if len(out.shape) < 4 or all(s == 1 for s in out.shape[2:]):
            break
        h = out
    return h.asnumpy()


def _within(got, want, tol, scale, msg, ulps=0):
    """|got - want| <= tol x scale (scale > 0, no floor) everywhere, plus
    ``ulps`` units in the last place of ``want``'s own dtype: a step's
    result rounds to the weight's precision however small its move."""
    err = float((np.abs(got - want) - ulps * np.spacing(np.abs(want))).max())
    assert scale > 0 and err <= tol * scale, (msg, err, tol * scale)


def _family_nets(name, tmp_path):
    """(reference net, port net, the port's initial arrays by full name,
    the seeded batch, its labels): He-initialized by the port, the
    reference loaded from the port's ``.params`` file."""
    build, shape, _ = FAMILIES[name]
    rng = np.random.RandomState(len(name))
    x = rng.rand(*shape).astype(np.float32)
    y = rng.randint(0, 10, shape[0]).astype(np.float32)
    jnet, tnet = build(True), build(False)
    tnet.initialize(HE, ctx="cpu", rng=np.random.RandomState(0))
    with autograd.predict_mode():
        tnet(nd.array(x))
    tnet.save_parameters(str(tmp_path / "w.params"))
    jnet.load_parameters(str(tmp_path / "w.params"))
    assert list(_rel(tnet)) == list(_rel(jnet))
    arrays = {n: p.data().asnumpy() for n, p in tnet.collect_params().items()}
    return jnet, tnet, arrays, x, y


def check_family(name, tmp_path):
    """Float32, He init: the predict-mode feature map ahead of the global
    pool and the logits within ``LOGIT_RTOL`` of their own largest
    magnitude; one SGD step (train mode where ``FAMILIES`` says so) with
    every parameter and moving statistic within ``PARAM_TOL`` (or the
    family's ``F32_STEP_TOL``) of the largest move the reference's step
    made, plus ``STEP_ULPS``."""
    jnet, tnet, _, x, y = _family_nets(name, tmp_path)
    train = FAMILIES[name][2]
    jnet.hybridize()
    w0 = _params(tnet)
    jf, tf = _pre_pool(jgluon, jnet, x), _pre_pool(gluon, tnet, x)
    assert tf.shape == jf.shape and tf.ndim == 4
    _within(tf, jf, LOGIT_RTOL, np.abs(jf).max(), "feature map")
    jl, jloss = _step(jgluon, jnet, x, y, train)
    tl, tloss = _step(gluon, tnet, x, y, train)
    assert np.abs(jl).max() > LIVE_LOGIT, np.abs(jl).max()
    _within(tl, jl, LOGIT_RTOL, np.abs(jl).max(), "logits")
    _within(tloss, jloss, LOGIT_RTOL, np.abs(jloss).max(), "loss")
    want, got = _params(jnet), _params(tnet)
    moved = max(np.abs(want[r] - w0[r]).max() for r in want)
    tol = F32_STEP_TOL.get(name, PARAM_TOL)
    for r in want:
        _within(got[r], want[r], tol, moved, r, ulps=STEP_ULPS)


@contextlib.contextmanager
def _reference_bn_in_float64():
    """The reference's BatchNorm computes its statistics and its
    hand-derived backward in float32 whatever the data's dtype
    (``mxnet_tpu/ops/nn.py:290-389``); for the duration, its module's
    ``jnp.float32`` reads float64 (the file is untouched), under jax's
    64-bit mode."""
    import jax
    import jax.numpy as jnp
    import mxnet_tpu.ops.nn as jnn

    class _Jnp64(types.ModuleType):
        def __getattr__(self, key):
            return jnp.float64 if key == "float32" else getattr(jnp, key)

    saved = jnn.jnp
    jnn.jnp = _Jnp64("jnp64")
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jnn.jnp = saved


def check_family_f64(name, tmp_path):
    """Float64, against the reference with its BatchNorm lifted to
    float64 (:func:`_reference_bn_in_float64`): one SGD step in train
    mode (BatchNorm on batch statistics, moving statistics updated) for
    the families without Dropout, in predict mode for the others; the
    logits and the loss within ``F64_TOL`` of their largest, every
    parameter and moving statistic after the step within ``F64_TOL`` of
    the largest move."""
    jnet, _, arrays, x, y = _family_nets(name, tmp_path)
    train = name in NO_DROPOUT
    tnet = from_jax_params(FAMILIES[name][0](False), arrays, device="cpu")
    tnet.cast("float64")
    w0 = _params(tnet)
    x, y = x.astype(np.float64), y.astype(np.float64)
    with _reference_bn_in_float64():
        jnet.cast("float64")
        jnet.hybridize()
        jl, jloss = _step(jgluon, jnet, x, y, train)
        want = _params(jnet)
    assert jl.dtype == np.float64
    tl, tloss = _step(gluon, tnet, x, y, train)
    _within(tl, jl, F64_TOL, np.abs(jl).max(), "logits")
    _within(tloss, jloss, F64_TOL, np.abs(jloss).max(), "loss")
    got = _params(tnet)
    moved = max(np.abs(want[r] - w0[r]).max() for r in want)
    for r in want:
        _within(got[r], want[r], F64_TOL, moved, r, ulps=STEP_ULPS)
