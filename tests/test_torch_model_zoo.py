"""The vision model zoo of mxnet_tpu_torch held against mxnet_tpu's.

- All 34 names of the reference's ``get_model``: the same parameter
  names, in order (relative to the outermost block's prefix); an unknown
  name raises ``ValueError``.
- One net per family, initialized by the port (He's init, ``HE``, from
  a seeded ``RandomState``, so the signal reaches the head: at Xavier's
  MobileNet's logits sink to 1e-20; shapes resolved by its first
  forward) and loaded into the reference's net from the port's
  ``.params`` file, one seeded batch through both.
  - Float32: the feature map ahead of the global pool and the logits in
    predict mode, and the loss, within 1e-4 of their own largest
    magnitude (no floor); after one Gluon SGD+momentum step every
    parameter and moving statistic within 5e-6 of the largest move the
    reference's step made in any array, plus 2 ulps of the weight
    (``F32_STEP_TOL`` names the two families where float32 resolves
    less, and why).  resnet18_v2 and the cut densenet121 step in train
    mode, at inputs whose last maps are at least 4 x 4; the others in
    predict mode (``autograd.record(train_mode=False)``): the families
    with Dropout (alexnet, vgg, squeezenet, inception) because the port
    draws its masks from its own generator, the MobileNets because the
    reference's float32 BatchNorm leaves its own train-mode step up to
    7e-3 of the largest move from the float64 one.
  - Float64, every family, against the reference with its BatchNorm's
    float32 lifted to float64 for the run (``mxnet_tpu`` untouched):
    the families without Dropout in train mode (BatchNorm on batch
    statistics, moving statistics updated), the others in predict mode;
    logits, loss and the step within 1e-10.
  Sizes, cut where the reference's CPU run would take minutes:
  resnet18_v2 at 128 x 128, squeezenet1.1 and both MobileNets at
  64 x 64, vgg11_bn at 32 x 32 and alexnet at 96 x 96 run whole;
  densenet121's fixed 7 x 7 pool and inceptionv3's fixed 8 x 8 keep
  their native 224 x 224 and 299 x 299, densenet with its body cut to
  ``DenseNet(16, 8, [2, 2, 2, 2])``, inception with its stem cut (the
  35 x 35 x 192 activations it produces are the input) and one block of
  each kind, A to E, then the native head.
- Channels-last ResNet (v1 and v2, thumbnail, batch 2, 32 x 32), one
  recorded step held to the port's NHWC net in float64 (logits,
  gradients, moving statistics; each array within the tolerance times
  its largest magnitude, at least 1): the port's NCHW net in float64
  with the weights moved OHWI -> OIHW, 1e-10; in float32 the port's
  NHWC and NCHW nets, 1e-5, and the reference's NHWC net, 2e-5.
- ``.params`` files: one the reference saves loads into the port's net
  and gives the reference's logits (1e-5); the port's file for the same
  values is byte-identical to the reference's, in both formats.
- ``tools/benchmark_score`` on the CPU: one small name, images/s > 0.
- ``initializer`` drawing from a ``torch.Generator``: a seeded draw
  repeats bitwise and has Xavier's scale.
"""
import contextlib
import os
import tempfile
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.gluon.model_zoo.vision import inception as jinception
from mxnet_tpu_torch import autograd, gluon, initializer, nd
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.model_zoo.vision import inception
from mxnet_tpu_torch.gluon.utils import from_jax_params, relative_names
from mxnet_tpu_torch.tools import benchmark_score

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


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _rel(block):
    ps = block.collect_params()
    return relative_names(list(ps.keys()), block.prefix)


def test_get_model_covers_the_reference_names():
    import inspect
    import re
    src = inspect.getsource(jvision.get_model)
    assert sorted(re.findall(r'"([a-z0-9_.]+)": ', src)) == sorted(NAMES)
    with pytest.raises(ValueError):
        vision.get_model("resnet7_v3")


@pytest.mark.parametrize("name", NAMES)
def test_parameter_names_match_reference(name):
    kw = {"classes": 10}
    want = list(_rel(jvision.get_model(name, **kw)))
    got = list(_rel(vision.get_model(name, **kw)))
    assert got == want


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


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_matches_reference(name, tmp_path):
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


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_matches_reference_in_float64(name, tmp_path):
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


# -- channels-last ResNet ----------------------------------------------------
def _grads(net):
    ps = net.collect_params()
    return {r: ps[n].grad().asnumpy() for r, n in _rel(net).items()
            if ps[n].grad_req != "null"}


def _fwd_bwd(pkg, net, x, head):
    """Logits, gradients and parameters (moving statistics updated) of
    one recorded forward and backward of ``sum(logits * head)``."""
    ag = mx.autograd if pkg is jgluon else autograd
    arr = mx.nd.array if pkg is jgluon else nd.array
    with ag.record():
        out = net(arr(x, dtype=x.dtype))
        total = (out * arr(head, dtype=x.dtype)).sum()
    total.backward()
    return out.asnumpy(), _grads(net), _params(net)


def _near(got, want, tol, msg):
    """max |got - want| <= tol x max(1, max |want|)."""
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (msg, err)


def _oihw(a):
    return np.moveaxis(a, -1, 1) if a.ndim == 4 else a


def _ohwi(run):
    """A ``_fwd_bwd`` result of an NCHW net with its 4-D arrays moved to
    the NHWC net's OHWI."""
    return (run[0],) + tuple(
        {r: np.moveaxis(v, 1, -1) if v.ndim == 4 else v
         for r, v in d.items()} for d in run[1:])


@pytest.mark.parametrize("version", [1, 2])
def test_nhwc_resnet_matches_nchw_and_reference(version):
    """Logits, gradients and moving statistics of one recorded step, held
    to the port's NHWC net in float64 (max |diff| over each array within
    the tolerance times its largest magnitude, at least 1): the port's
    NCHW net in float64 with the weights moved OHWI -> OIHW, 1e-10; in
    float32 the port's NHWC net and its NCHW net, 1e-5, and the
    reference's NHWC net, 2e-5 (``REF_LAYOUT_TOL``)."""
    name = "resnet18_v%d" % version
    rng = np.random.RandomState(version)
    x = rng.rand(2, 3, 32, 32).astype(np.float32)
    xl = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    head = rng.randn(2, 10).astype(np.float32)
    kw = dict(classes=10, thumbnail=True)
    tl = vision.get_model(name, layout="NHWC", **kw)
    tl.initialize(initializer.Xavier(), ctx="cpu",
                  rng=np.random.RandomState(0))
    with autograd.predict_mode():
        tl(nd.array(xl))
    arrays = {n: p.data().asnumpy() for n, p in tl.collect_params().items()}
    conv = [r for r, a in _params(tl).items() if a.ndim == 4]
    assert _params(tl)[conv[0]].shape == (64, 3, 3, 3)     # OHWI
    jl = jvision.get_model(name, layout="NHWC", **kw)
    with tempfile.TemporaryDirectory() as d:
        tl.save_parameters(d + "/w.params")
        jl.load_parameters(d + "/w.params")
    jl.hybridize()
    nchw = {n: np.ascontiguousarray(_oihw(a)) for n, a in arrays.items()}
    runs = {}
    for dt in (np.float32, np.float64):
        tc = from_jax_params(vision.get_model(name, **kw), nchw,
                             device="cpu")
        tn = from_jax_params(vision.get_model(name, layout="NHWC", **kw),
                             arrays, device="cpu")
        tc.cast(dt)
        tn.cast(dt)
        runs[dt] = (_fwd_bwd(gluon, tn, xl.astype(dt), head),
                    _fwd_bwd(gluon, tc, x.astype(dt), head))
    want = _fwd_bwd(jgluon, jl, xl, head)
    exact = runs[np.float64][0]
    for label, run, tol in (("float64 NCHW", _ohwi(runs[np.float64][1]),
                             1e-10),
                            ("float32 NHWC", runs[np.float32][0],
                             LAYOUT_TOL),
                            ("float32 NCHW", _ohwi(runs[np.float32][1]),
                             LAYOUT_TOL),
                            ("reference NHWC", want, REF_LAYOUT_TOL)):
        _near(run[0], exact[0], tol, "logits, " + label)
        for i in (1, 2):
            assert sorted(run[i]) == sorted(exact[i])
            for r, v in run[i].items():
                assert v.shape == exact[i][r].shape, (r, label)
                _near(v, exact[i][r], tol, r + ", " + label)


# -- .params files -----------------------------------------------------------
@pytest.mark.parametrize("fmt", ["mxtpu", "mxnet"])
def test_reference_params_file_loads_and_port_file_is_identical(fmt):
    kw = dict(classes=10)
    x = np.random.RandomState(3).rand(1, 3, 32, 32).astype(np.float32)
    jnet = jvision.get_model("mobilenetv2_0.25", **kw)
    np.random.seed(0)
    jnet.initialize(mx.init.Xavier())
    jnet.hybridize()
    want = jnet(mx.nd.array(x)).asnumpy()
    with tempfile.TemporaryDirectory() as d:
        ref = os.path.join(d, "ref.params")
        port = os.path.join(d, "port.params")
        jnet.save_parameters(ref, format=fmt)
        tnet = vision.get_model("mobilenetv2_0.25", **kw)
        tnet.load_parameters(ref, ctx="cpu")
        got = tnet(nd.array(x)).asnumpy()
        tnet.save_parameters(port, format=fmt)
        with open(ref, "rb") as a, open(port, "rb") as b:
            assert a.read() == b.read()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- benchmark_score and the device-side initializer -------------------------
def test_benchmark_score_runs_on_the_cpu(capsys):
    out = benchmark_score.main(["--network", "squeezenet1.1",
                                "--batch-sizes", "1,2", "--image-shape",
                                "3,64,64", "--iters", "2", "--warmup", "1",
                                "--cpu"])
    assert [b for b, _ in out] == [1, 2] and all(ips > 0 for _, ips in out)
    text = capsys.readouterr().out
    assert "network: squeezenet1.1 (device: cpu" in text
    assert "batch size   2, image 3x64x64" in text
    nhwc = benchmark_score.score("resnet18_v1", 1, (3, 32, 32), iters=1,
                                 warmup=1, ctx="cpu", layout="NHWC")
    assert nhwc > 0


def test_initializer_draws_from_a_torch_generator():
    def draw(seed):
        net = gluon.nn.Conv2D(64, 3, in_channels=32)
        net.initialize(initializer.Xavier(rnd_type="gaussian"), ctx="cpu",
                       rng=torch.Generator().manual_seed(seed))
        return net.weight.tensor().detach().clone()

    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    fan = (32 * 9 + 64 * 9) / 2.0
    assert abs(float(a.std()) / np.sqrt(3 / fan) - 1) < 0.05
    assert a.dtype == torch.float32 and a.device.type == "cpu"
