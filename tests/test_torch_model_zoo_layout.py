"""The vision model zoo: the channels-last ResNet and ``.params`` file
cases of ``test_torch_model_zoo.py``, in a file of their own so that
``--dist loadfile`` runs them beside the family cases (shared nets and
limits: ``torch_zoo_cases.py``).

- Channels-last ResNet (v1 and v2, thumbnail, batch 2, 32 x 32), one
  recorded step held to the port's NHWC net in float64 (logits,
  gradients, moving statistics; each array within the tolerance times
  its largest magnitude, at least 1): the port's NCHW net in float64
  with the weights moved OHWI -> OIHW, 1e-10; in float32 the port's
  NHWC and NCHW nets, 1e-5, and the reference's NHWC net, 2e-5.
- ``.params`` files: one the reference saves loads into the port's net
  and gives the reference's logits (1e-5); the port's file for the same
  values is byte-identical to the reference's, in both formats.
"""
import os
import tempfile

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import autograd, gluon, initializer, nd
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.utils import from_jax_params
from torch_zoo_cases import LAYOUT_TOL, REF_LAYOUT_TOL, _params, _rel


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


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
