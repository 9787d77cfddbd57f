"""The int8 serving slice of mxnet_tpu_torch held against mxnet_tpu.

- B8: ``qmm_requant``'s plain version against the reference's Pallas
  kernel (interpret mode) — int8 codes equal but for round-half-even ties
  after a different float order: at most 0.1 % of codes, never more than
  1 apart.
- Every op of ``ops/quantization.py`` and ``quantized_conv_requant`` on
  both of its branches, on the same seeded inputs: integer outputs equal,
  float outputs within 1e-6 (float32 elementwise arithmetic in the same
  order; only XLA's FMA contraction can move a last bit).
- ``resnet_symbol(50, layout="NHWC")``: arguments, auxiliary states,
  ``infer_shape`` and ``tojson`` equal, nothing executed.
- ``quantize_model`` on ``resnet_symbol(50, num_classes=10,
  layout="NHWC")`` at 32 x 32, batch 2, the reference's Xavier weights
  (and seeded BatchNorm statistics) carried into the port,
  ``MXTPU_FUSE_QCONV=1``: the same graph node for node, calibrated ranges
  within 1e-5 relative (the fp32 calibration forward sums convolutions in
  another order), the quantized weights bitwise.  The reference's int8
  graph, loaded into the port from its JSON, runs with
  ``MXTPU_PALLAS_QMM=1`` on both sides: every internal integer output
  equal under the tie rule above (none differed when this was written),
  float outputs within 1e-6 relative (XLA folds the int32 range
  arithmetic ``a/127 * b/127 * (2**31 - 1)`` inside the jitted graph and
  can move its last bit), top-1 equal and probabilities within 1e-5 (the
  softmax's exp and sum differ between the libraries).
- ``ModelRunner(device="cpu")`` behind ``ModelFleet`` and ``Server``:
  concurrent ``POST /predict`` answers bitwise equal to ``forward_batch``
  on the idle runner, no signature added after warm-up.
"""
import json
import os
import threading
import urllib.request
from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import name as jname
from mxnet_tpu.contrib import quantization as jquant
from mxnet_tpu.ops import pallas_kernels as jpk
from mxnet_tpu.ops import quantization as jops
from mxnet_tpu.symbol.models import resnet_symbol as j_resnet
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import quantization as tquant
from mxnet_tpu_torch.executor import Executor
from mxnet_tpu_torch.module import Module
from mxnet_tpu_torch.ops import pallas_kernels as pk
from mxnet_tpu_torch.ops import quantization as tops
from mxnet_tpu_torch.serving import ModelFleet, ModelRunner, Server
from mxnet_tpu_torch.serving.quantize import (per_channel_scales,
                                              ptq_quantize_module)
from mxnet_tpu_torch.symbol.models import resnet_symbol as t_resnet

FLOAT_TOL = 1e-6
FLOAT_RTOL = 1e-6
PROB_TOL = 1e-5
RANGE_RTOL = 1e-5
TIE_SHARE = 1e-3
SHAPE = (2, 32, 32, 3)
# the fused / unfused node counts of quantize_model on ResNet-50 (NHWC)
NODE_COUNTS = {"_contrib_quantized_conv_requant": 33,
               "_contrib_quantized_conv": 20,
               "_contrib_quantized_pooling": 2,
               "_contrib_quantized_fully_connected": 1}
B8_PER_FORWARD = 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _same(got, want, name=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL,
                                   err_msg=name)


# -- B8 ----------------------------------------------------------------------
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m,k,n", [(130, 70, 40), (600, 520, 300), (1, 8, 8)])
def test_qmm_requant_plain_matches_pallas_reference(m, k, n, relu):
    rng = np.random.RandomState(m + k + n)
    x = rng.randint(-127, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (n, k)).astype(np.int8)
    bias = (rng.randn(n) * 10).astype(np.float32)
    scale = 60.0 / (np.sqrt(k) * 127 * 127 / np.sqrt(3))
    want = np.asarray(jpk.qmm_requant(jnp.asarray(x), jnp.asarray(w.T),
                                      jnp.asarray(bias), scale, relu=relu,
                                      interpret=True))
    before = pk.launch_counts()["qmm_requant"]
    got = pk.qmm_requant(_t(x), _t(w), _t(bias), scale, relu=relu)
    assert pk.launch_counts()["qmm_requant"] == before   # plain on the CPU
    assert got.dtype == torch.int8 and tuple(got.shape) == (m, n)
    diff = got.numpy().astype(np.int32) - want
    assert np.abs(diff).max(initial=0) <= 1
    assert (diff != 0).mean() <= TIE_SHARE, (diff != 0).sum()
    print("qmm_requant (%d, %d, %d) relu=%s: %d of %d codes differ"
          % (m, k, n, relu, (diff != 0).sum(), diff.size))
    if m * n > 1000:
        assert len(np.unique(want)) > 20    # the codes spread over the range


def test_qmm_requant_refuses_bad_operands():
    x = torch.zeros(4, 8, dtype=torch.int8)
    w = torch.zeros(3, 8, dtype=torch.int8)
    b = torch.zeros(3)
    with pytest.raises(MXNetError, match="int8"):
        pk.qmm_requant(x.float(), w, b, 1.0)
    with pytest.raises(MXNetError, match="bias"):
        pk.qmm_requant(x, w, torch.zeros(4), 1.0)


@pytest.mark.cuda
def test_qmm_requant_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.RandomState(0)
    for m, k, n in [(130, 70, 40), (600, 520, 300), (1, 8, 8),
                    (4096, 256, 64)]:
        for relu in (True, False):
            x = _t(rng.randint(-127, 128, (m, k)).astype(np.int8)).cuda()
            w = _t(rng.randint(-127, 128, (n, k)).astype(np.int8)).cuda()
            b = _t((rng.randn(n) * 10).astype(np.float32)).cuda()
            got = pk.qmm_requant(x, w, b, 1e-3, relu=relu)
            want = pk.qmm_requant_reference(x, w, b, 1e-3, relu=relu)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


# -- the quantization ops ----------------------------------------------------
def _rng_float(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def _rng_int8(shape, seed):
    return np.random.RandomState(seed).randint(-127, 128, shape) \
        .astype(np.int8)


def _r(v):
    return np.asarray([v], np.float32)


def _both(name, *arrays, **params):
    """(reference outputs, port outputs) of op function ``name``."""
    want = getattr(jops, name)(*[jnp.asarray(a) for a in arrays], **params)
    got = getattr(tops, name)(*[_t(a) for a in arrays], **params)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    return want, got


def _conv_case(kernel, stride, pad, bias, seed):
    cin, cout = 6, 5
    x = _rng_int8((2, 9, 9, cin), seed)
    w = _rng_int8((cout,) + kernel + (cin,), seed + 1)
    args = [x, w, _r(-2.5), _r(3.0), _r(-0.7), _r(0.6)]
    params = dict(kernel=kernel, stride=stride, pad=pad, num_filter=cout,
                  layout="NHWC", no_bias=bias is None)
    if bias is not None:
        args += [_rng_int8((cout,), seed + 2), _r(-1.0), _r(1.5)]
    return args, params


CONV_GEOMETRIES = {"1x1": ((1, 1), (1, 1), (0, 0)),
                   "1x1_s2": ((1, 1), (2, 2), (0, 0)),
                   "3x3": ((3, 3), (1, 1), (1, 1)),
                   "7x7_s2_p3": ((7, 7), (2, 2), (3, 3))}

OP_CASES = {
    "quantize_uint8": lambda: ("quantize", (_rng_float((3, 50), 1),
                                            _r(-1.2), _r(2.0)),
                               {"out_type": "uint8"}),
    "quantize_int8": lambda: ("quantize", (_rng_float((3, 50), 2),
                                           _r(-1.2), _r(2.0)),
                              {"out_type": "int8"}),
    "quantize_degenerate": lambda: ("quantize", (np.zeros((4,), np.float32),
                                                 _r(0.0), _r(0.0)),
                                    {"out_type": "int8"}),
    "quantize_v2_data_range": lambda: ("quantize_v2",
                                       (_rng_float((3, 50), 3),), {}),
    "quantize_v2_calibrated": lambda: ("quantize_v2",
                                       (_rng_float((3, 50), 4),),
                                       {"min_calib_range": -0.9,
                                        "max_calib_range": 1.1}),
    "dequantize_uint8": lambda: ("dequantize", (
        np.random.RandomState(5).randint(0, 256, (40,)).astype(np.uint8),
        _r(-1.5), _r(2.5)), {}),
    "dequantize_int8": lambda: ("dequantize", (_rng_int8((40,), 6),
                                               _r(-1.5), _r(2.5)), {}),
    "dequantize_int32": lambda: ("dequantize", (
        np.random.RandomState(7).randint(-2 ** 30, 2 ** 30, (40,))
        .astype(np.int32), _r(-3e5), _r(3e5)), {}),
    "requantize_data_range": lambda: ("requantize", (
        np.random.RandomState(8).randint(-2 ** 20, 2 ** 20, (40,))
        .astype(np.int32), _r(-3e5), _r(3e5)), {}),
    "requantize_calibrated": lambda: ("requantize", (
        np.random.RandomState(9).randint(-2 ** 20, 2 ** 20, (40,))
        .astype(np.int32), _r(-3e5), _r(3e5)),
        {"min_calib_range": -50.0, "max_calib_range": 40.0}),
    "quantized_fc": lambda: ("quantized_fully_connected", (
        _rng_int8((3, 2, 2, 5), 10), _rng_int8((7, 20), 11), _r(-2.0),
        _r(2.5), _r(-0.5), _r(0.4)), {"num_hidden": 7, "no_bias": True}),
    "quantized_fc_bias": lambda: ("quantized_fully_connected", (
        _rng_int8((3, 20), 12), _rng_int8((7, 20), 13), _r(-2.0), _r(2.5),
        _r(-0.5), _r(0.4), _rng_int8((7,), 14), _r(-1.0), _r(0.8)),
        {"num_hidden": 7}),
    "quantized_pooling_max_pad": lambda: ("quantized_pooling", (
        _rng_int8((2, 9, 9, 4), 15), _r(-1.0), _r(1.0)),
        {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
         "pool_type": "max", "layout": "NHWC"}),
    "quantized_pooling_global_avg": lambda: ("quantized_pooling", (
        _rng_int8((2, 7, 7, 4), 16), _r(-1.0), _r(1.0)),
        {"global_pool": True, "pool_type": "avg", "layout": "NHWC"}),
    "quantized_pooling_avg": lambda: ("quantized_pooling", (
        _rng_int8((2, 4, 9, 9), 17), _r(-1.0), _r(1.0)),
        {"kernel": (3, 3), "stride": (2, 2), "pool_type": "avg"}),
    "quantized_flatten": lambda: ("quantized_flatten", (
        _rng_int8((2, 3, 3, 4), 18), _r(-1.0), _r(1.0)), {}),
    "quantized_fc_pc": lambda: ("quantized_fc_pc", (
        _rng_float((3, 20), 19), _rng_int8((7, 20), 20),
        np.abs(_rng_float((7,), 21)) * 0.01, _rng_float((7,), 22)),
        {"num_hidden": 7, "in_amax": 2.5, "relu": True}),
}
# the reference's "full" pooling convention (output ceil((n + 2p - k)/s)
# + 1, the shortfall padded on the high side) and "valid", as (n, k, s, p)
POOL_GEOMETRIES = [(3, 2, 2, 1), (112, 3, 2, 1), (5, 2, 2, 0), (9, 3, 3, 1)]
for _i, (_n, _k, _s, _p) in enumerate(POOL_GEOMETRIES):
    for _conv in ("full", "valid"):
        for _pt in ("max", "avg"):
            OP_CASES["quantized_pooling_%s_%s_%d_%d_%d_%d" % (
                _conv, _pt, _n, _k, _s, _p)] = (
                lambda n=_n, k=_k, s=_s, p=_p, conv=_conv, pt=_pt, i=_i: (
                    "quantized_pooling",
                    (_rng_int8((2, n, n, 4), 30 + i), _r(-1.0), _r(1.0)),
                    {"kernel": (k, k), "stride": (s, s), "pad": (p, p),
                     "pool_type": pt, "pooling_convention": conv,
                     "layout": "NHWC"}))
for _g, (_k, _s, _p) in CONV_GEOMETRIES.items():
    OP_CASES["quantized_conv_" + _g] = (
        lambda k=_k, s=_s, p=_p: ("quantized_conv",)
        + tuple(_conv_case(k, s, p, None, 23)))
OP_CASES["quantized_conv_3x3_bias"] = lambda: ("quantized_conv",) + tuple(
    _conv_case((3, 3), (1, 1), (1, 1), True, 24))


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_quantization_op_matches_reference(case):
    name, arrays, params = OP_CASES[case]()
    want, got = _both(name, *arrays, **params)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, "%s[%d]" % (case, i))


@pytest.mark.parametrize("qmm", ["0", "1"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("geometry", sorted(CONV_GEOMETRIES))
def test_quantized_conv_requant_matches_reference(geometry, relu, qmm,
                                                  monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_QMM", qmm)
    kernel, stride, pad = CONV_GEOMETRIES[geometry]
    cin, cout = 16, 24
    seed = len(geometry) + 3 * relu
    x = _rng_int8((2, 9, 9, cin), seed)
    w = _rng_int8((cout,) + kernel + (cin,), seed + 1)
    bias = _rng_float((cout,), seed + 2, 3.0)
    params = dict(kernel=kernel, stride=stride, pad=pad, num_filter=cout,
                  layout="NHWC", in_scale=0.02, w_scale=0.004,
                  out_scale=0.05, relu=relu)
    want = jpk.quantized_conv_requant(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(bias), **params)
    got = pk.quantized_conv_requant(_t(x), _t(w), _t(bias), **params)
    diff = got[0].numpy().astype(np.int32) - np.asarray(want[0])
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() <= TIE_SHARE
    for g, wv in zip(got[1:], want[1:]):
        _same(g, wv)
    # without a bias, calibrated range attributes given
    want = jpk.quantized_conv_requant(
        jnp.asarray(x), jnp.asarray(w), None, min_calib_range=-1.5,
        max_calib_range=2.0, **params)
    got = pk.quantized_conv_requant(_t(x), _t(w), None, min_calib_range=-1.5,
                                    max_calib_range=2.0, **params)
    diff = got[0].numpy().astype(np.int32) - np.asarray(want[0])
    assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= TIE_SHARE
    _same(got[1], want[1])
    _same(got[2], want[2])


def test_per_channel_scales_match_reference():
    from mxnet_tpu.serving import quantize as jserving
    w = _rng_float((6, 3, 3, 4), 30)
    w[2] = 0.0
    for a, b in zip(per_channel_scales(w), jserving.per_channel_scales(w)):
        np.testing.assert_array_equal(a, b)


# -- the symbol --------------------------------------------------------------
def _symbols(num_classes=1000):
    with jname.NameManager():
        ref = j_resnet(50, num_classes=num_classes, layout="NHWC")
    with tname.NameManager():
        port = t_resnet(50, num_classes=num_classes, layout="NHWC")
    return ref, port


def test_resnet50_symbol_matches_reference():
    ref, port = _symbols()
    assert port.list_arguments() == ref.list_arguments()
    assert port.list_auxiliary_states() == ref.list_auxiliary_states()
    assert port.list_outputs() == ref.list_outputs()
    assert port.tojson() == ref.tojson()
    shapes = {"data": (4, 224, 224, 3)}
    assert port.infer_shape(**shapes) == ref.infer_shape(**shapes)
    assert port.infer_type(data="float32") == ref.infer_type(data="float32")
    assert tsym.load_json(ref.tojson()).tojson() == ref.tojson()
    internals = port.get_internals().list_outputs()
    assert internals == ref.get_internals().list_outputs()


# -- quantize_model and the int8 forward -------------------------------------
@pytest.fixture(scope="module")
def quantized():
    """The reference's Xavier ResNet-50 (10 classes, NHWC) with seeded
    BatchNorm statistics, quantized by both packages from the same
    calibration batch."""
    os.environ["MXTPU_FUSE_QCONV"] = "1"
    try:
        ref_sym, port_sym = _symbols(num_classes=10)
        x = np.random.RandomState(0).rand(*SHAPE).astype(np.float32)
        y = np.zeros(SHAPE[0], np.float32)
        mod = mx.mod.Module(ref_sym)
        it = mx.io.NDArrayIter(x, y, SHAPE[0])
        mod.bind(it.provide_data, it.provide_label, for_training=False)
        np.random.seed(0)
        mod.init_params(mx.init.Xavier())
        arg, aux = mod.get_params()
        r = np.random.RandomState(1)
        for table in (arg, aux):
            for k in sorted(table):
                if k.endswith(("gamma", "moving_var")):
                    table[k] = mx.nd.array(r.uniform(0.5, 1.5,
                                                     table[k].shape))
                elif k.endswith(("beta", "moving_mean")):
                    table[k] = mx.nd.array(r.randn(*table[k].shape) * 0.1)
        ref = jquant.quantize_model(ref_sym, arg, aux,
                                    calib_data=mx.io.NDArrayIter(x, y, 2))
        port_arg = {k: tnd.array(v.asnumpy(), ctx="cpu")
                    for k, v in arg.items()}
        port_aux = {k: tnd.array(v.asnumpy(), ctx="cpu")
                    for k, v in aux.items()}
        port = ptq_quantize_module(port_sym, port_arg, port_aux,
                                   tio.NDArrayIter(x, y, 2))
    finally:
        del os.environ["MXTPU_FUSE_QCONV"]
    return {"x": x, "ref": ref, "port": port}


def test_quantize_model_matches_reference(quantized):
    (rsym, rarg, raux), (psym, parg, paux, report) = \
        quantized["ref"], quantized["port"]
    counts = Counter(n.op for n in psym._nodes() if n.op)
    assert {k: counts[k] for k in NODE_COUNTS} == NODE_COUNTS
    rnodes, pnodes = rsym._nodes(), psym._nodes()
    assert len(pnodes) == len(rnodes)
    for a, b in zip(rnodes, pnodes):
        assert (b.op, b.name, b.inputs and [(c.name, i) for c, i in b.inputs]
                ) == (a.op, a.name, a.inputs and [(c.name, i)
                                                  for c, i in a.inputs])
        assert set(a.attrs) == set(b.attrs), a.name
        for k, v in a.attrs.items():
            if "calib_range" in k or k in ("in_scale", "out_scale"):
                np.testing.assert_allclose(float(b.attrs[k]), float(v),
                                           rtol=RANGE_RTOL, err_msg=a.name)
            else:
                assert str(b.attrs[k]) == str(v), (a.name, k)
    assert sorted(parg) == sorted(rarg) and sorted(paux) == sorted(raux)
    for k in rarg:
        np.testing.assert_array_equal(parg[k].asnumpy(), rarg[k].asnumpy(),
                                      err_msg=k)
    assert len(report["digest"]) == 64


def _ref_module(sym, arg, aux, x):
    mod = mx.mod.Module(sym, label_names=None)
    mod.bind([("data", x.shape)], for_training=False)
    mod.set_params(arg, aux, allow_missing=True)
    mod.forward(mx.io.DataBatch([mx.nd.array(x)]), is_train=False)
    return [o.asnumpy() for o in mod.get_outputs()]


def _port_module(sym, arg, aux, x):
    mod = Module(sym, label_names=None, context="cpu")
    mod.bind([("data", x.shape)], for_training=False)
    mod.set_params(arg, aux, allow_missing=True, allow_extra=True)
    mod.forward(tio.DataBatch([tnd.array(x, ctx="cpu")]), is_train=False)
    return mod, [o.asnumpy() for o in mod.get_outputs()]


def test_int8_forward_of_reference_graph_matches(quantized, monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_QMM", "1")
    x = quantized["x"]
    rsym, rarg, raux = quantized["ref"]
    internals = rsym.get_internals()
    names = [n for n in internals.list_outputs() if "_output" in n]
    group = mx.sym.Group([internals[n] for n in names])
    want = _ref_module(group, rarg, raux, x)
    loaded = tsym.load_json(group.tojson())
    parg = {k: tnd.array(v.asnumpy(), ctx="cpu", dtype=v.dtype)
            for k, v in rarg.items()}
    paux = {k: tnd.array(v.asnumpy(), ctx="cpu") for k, v in raux.items()}
    # every fused 1x1 node goes through the B8 wrapper (shape inference at
    # bind calls it on meta tensors)
    calls = []
    real = pk.qmm_requant
    monkeypatch.setattr(pk, "qmm_requant", lambda *a, **k: calls.append(
        a[0].device.type) or real(*a, **k))
    _, got = _port_module(loaded, parg, paux, x)
    assert calls.count("cpu") == B8_PER_FORWARD
    assert len(got) == len(want) == len(names)
    stats = []
    for name, g, w in zip(names, got, want):
        if name == "softmax_output":
            np.testing.assert_allclose(g, w, rtol=0, atol=PROB_TOL)
            np.testing.assert_array_equal(g.argmax(1), w.argmax(1))
        elif np.issubdtype(w.dtype, np.integer):
            diff = g.astype(np.int64) - w
            stats.append((name, int((diff != 0).sum()), w.size))
            assert np.abs(diff).max() <= 1, name
            assert (diff != 0).mean() <= TIE_SHARE, name
        else:
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, atol=FLOAT_TOL,
                                       err_msg=name)
    print("int8 graph: %d of %d integer codes differ (tie rule)"
          % (sum(s[1] for s in stats), sum(s[2] for s in stats)))


def test_optimal_threshold_matches_reference():
    from mxnet_tpu_torch.contrib.quantization import optimal_threshold
    rng = np.random.RandomState(4)
    vals = np.concatenate([rng.randn(20000), rng.randn(40) * 12])
    edges = np.linspace(-40, 40, 8002)
    hist, _ = np.histogram(vals, bins=edges)
    assert optimal_threshold(hist, edges) == \
        jquant.optimal_threshold(hist, edges)


def _small_net(pkg):
    sym = tsym if pkg == "port" else mx.sym
    data = sym.Variable("data")
    c1 = sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                         layout="NHWC", name="c1")
    b1 = sym.BatchNorm(c1, fix_gamma=False, axis=3, name="bn1")
    r1 = sym.Activation(b1, act_type="relu", name="r1")
    c2 = sym.Convolution(r1, kernel=(1, 1), num_filter=16, layout="NHWC",
                         name="c2")
    r2 = sym.Activation(c2, act_type="relu", name="r2")
    fc = sym.FullyConnected(r2, num_hidden=4, name="fc")
    return sym.SoftmaxOutput(fc, name="softmax")


def test_entropy_calibration_matches_reference():
    """``calib_mode="entropy"``: the histogram pass and the KL search give
    the reference's thresholds (within 1e-5 relative) on a small NHWC
    net."""
    x = np.random.RandomState(6).rand(16, 6, 6, 3).astype(np.float32)
    y = np.zeros(16, np.float32)
    ref_net = _small_net("ref")
    mod = mx.mod.Module(ref_net)
    mod.bind([("data", x.shape)], [("softmax_label", y.shape)],
             for_training=False)
    np.random.seed(2)
    mod.init_params(mx.init.Xavier())
    arg, aux = mod.get_params()
    rsym, rarg, _ = jquant.quantize_model(
        ref_net, arg, aux, calib_mode="entropy",
        calib_data=mx.io.NDArrayIter(x, y, 8))
    psym, parg, _ = tquant.quantize_model(
        _small_net("port"), {k: tnd.array(v.asnumpy(), ctx="cpu")
                             for k, v in arg.items()},
        {k: tnd.array(v.asnumpy(), ctx="cpu") for k, v in aux.items()},
        calib_mode="entropy", calib_data=tio.NDArrayIter(x, y, 8))
    want = {(n.name, k): float(v) for n in rsym._nodes()
            for k, v in n.attrs.items() if "calib_range" in k}
    got = {(n.name, k): float(v) for n in psym._nodes()
           for k, v in n.attrs.items() if "calib_range" in k}
    assert sorted(got) == sorted(want) and len(want) >= 6
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, rtol=RANGE_RTOL,
                                   err_msg=str(key))
    for k in rarg:
        np.testing.assert_array_equal(parg[k].asnumpy(), rarg[k].asnumpy())


# -- serving -----------------------------------------------------------------
def _post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def test_served_answers_equal_forward_batch(quantized, monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_QMM", "1")
    psym, parg, paux, _ = quantized["port"]
    mod = Module(psym, context="cpu")
    mod.bind([("data", SHAPE)], for_training=False)
    mod.set_params(parg, paux, allow_extra=True)
    runner = ModelRunner(mod, buckets=(1, 2, 4), device="cpu")
    assert runner.modeled_cost() == {} and runner.modeled_peak_hbm() is None
    rng = np.random.RandomState(3)
    reqs = [rng.rand(1 + i % 3, *SHAPE[1:]).astype(np.float32)
            for i in range(6)]
    want = [np.stack([runner.forward_batch(r[j:j + 1])[0]
                      for j in range(len(r))]) for r in reqs]
    fleet = ModelFleet(batch_timeout_ms=5.0)
    fleet.register("resnet50_int8", runner)
    server = Server(fleet, port=0)
    host, port = server.start()
    url = "http://%s:%d/predict" % (host, port)
    results = [None] * len(reqs)

    def fire(i):
        tier = ("gold", "silver", "bronze")[i % 3]
        results[i] = _post(url, {"data": reqs[i].tolist(), "tier": tier,
                                 "model": "resnet50_int8"})

    try:
        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.drain(timeout=30)
    for (status, body), w in zip(results, want):
        assert status == 200, body
        np.testing.assert_array_equal(np.asarray(body["outputs"],
                                                 np.float32), w)
    assert runner.recompiles_since_warmup() == 0


# -- device rules and refusals ------------------------------------------------
def test_default_devices_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((1, 8, 8, 3), np.float32)
    with pytest.raises(MXNetError, match="CUDA"):
        tnd.array(x)
    data = tsym.Variable("data")
    net = tsym.FullyConnected(data, num_hidden=2, name="fc")
    with pytest.raises(MXNetError, match="CUDA"):
        Module(net, label_names=None).bind([("data", (1, 4))],
                                           for_training=False)
    with pytest.raises(MXNetError, match="CUDA"):
        Executor.simple_bind(net, shapes={"data": (1, 4)})
    mod = Module(net, label_names=None, context="cpu")
    mod.bind([("data", (1, 4))], for_training=False)
    mod.init_params(arg_params={"fc_weight": np.ones((2, 4), np.float32),
                                "fc_bias": np.zeros(2, np.float32)})
    with pytest.raises(MXNetError, match="CUDA"):
        ModelRunner(mod, buckets=(1,))
    runner = ModelRunner(mod, buckets=(1,), device="cpu")
    np.testing.assert_array_equal(runner.predict(np.ones(4, np.float32)),
                                  [4.0, 4.0])


def test_unported_surface_names_its_roadmap_item():
    data = tsym.Variable("data")
    net = tsym.FullyConnected(data, num_hidden=2, name="fc")
    mod = Module(net, label_names=None, context="cpu")
    mod.bind([("data", (1, 4))], for_training=False)
    with pytest.raises(NotImplementedError, match="items 6-7"):
        Module(net, label_names=None, context="cpu",
               group2ctxs={"g": "cpu"})
    with pytest.raises(NotImplementedError, match="items 6-7"):
        Executor.simple_bind(net, ctx=["cpu", "cpu"],
                             shapes={"data": (1, 4)})
    with pytest.raises(NotImplementedError, match="item 13"):
        net.cost_report({"data": (1, 4)})
    mod.init_params(arg_params={"fc_weight": np.ones((2, 4), np.float32),
                                "fc_bias": np.zeros(2, np.float32)})
    with pytest.raises(NotImplementedError, match="item 13"):
        ModelRunner(mod, buckets=(1,), device="cpu", hbm_cap_bytes=1 << 30)
