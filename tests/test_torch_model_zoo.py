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

The family cases are split over files so that ``--dist loadfile``
spreads them: this file holds resnet18_v2, vgg11_bn, alexnet,
squeezenet1.1 and densenet121; ``test_torch_model_zoo_mobilenet.py``,
``test_torch_model_zoo_mobilenetv2.py`` and
``test_torch_model_zoo_inception.py`` the others, each case and limit as
here (the nets, inputs and checks: ``torch_zoo_cases.py``).
"""
import os
import tempfile

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import autograd, gluon, initializer, nd
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.utils import from_jax_params
from mxnet_tpu_torch.tools import benchmark_score
from torch_zoo_cases import (LAYOUT_TOL, NAMES, REF_LAYOUT_TOL, _params,
                             _rel, check_family, check_family_f64)

# the families whose cases live in this file
FAMILY_CASES = ["alexnet", "densenet121", "resnet18_v2", "squeezenet1.1",
                "vgg11_bn"]


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


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


@pytest.mark.parametrize("name", FAMILY_CASES)
def test_family_matches_reference(name, tmp_path):
    """``torch_zoo_cases.check_family``: float32, He init, the feature
    map, logits, loss and one SGD step against the reference."""
    check_family(name, tmp_path)


@pytest.mark.parametrize("name", FAMILY_CASES)
def test_family_matches_reference_in_float64(name, tmp_path):
    """``torch_zoo_cases.check_family_f64``: float64 against the
    reference with its BatchNorm lifted to float64."""
    check_family_f64(name, tmp_path)


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
