"""The front-end names A1 left out (A1(f)): each held against mxnet_tpu.

- ``nd.eye`` equal to the reference's, ``nd.linspace`` within four ulps
  of its largest value (the op rounds a float64 ramp where the
  reference's accumulates float32 steps);
  ``nd.randn`` by its law (a random op is held by its law only) and
  ``nd.seed`` by replay; ``sym.arange`` and ``sym.ones`` bound and run
  equal to the reference's.
- The initializers ``MSRAPrelu``, ``Orthogonal``, ``Bilinear``,
  ``Mixed`` and ``Load``: after the same ``np.random.seed`` (the
  reference's initializers draw from numpy's global RNG, as the port's
  do without ``rng=``) each array bitwise the reference's; the
  reference's own checks (``tests/test_losses_metrics_sched.py:
  350-372``) and the FCN-xs upsampler's ``Mixed([...], [Bilinear(),
  Xavier()])`` init.
- ``gluon.Constant``: the reference's value and ``grad_req``, untouched
  by a ``Trainer`` step.
- ``gluon.SymbolBlock`` (and ``gluon.nn.SymbolBlock``): a symbolic net
  run as a block equals the reference's executor on the same weights
  (1e-5), trains through ``autograd``, and ``SymbolBlock.imports`` of a
  port ``Module`` checkpoint equals ``Module.predict``.  The reference's
  own block fails its forward (ROADMAP.md C19), as shown.
- ``mx.NDArray``, ``mx.Symbol``, ``mx.Executor``.
- ``tools/op_bench.py`` on the CPU: its records, and every op of its
  case table registered in both packages.
"""
import numpy as np
import pytest

import mxnet_tpu as ref
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, init, nd, sym
from mxnet_tpu_torch.context import use


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with use("cpu"):
        yield


# -- nd and sym ---------------------------------------------------------------
@pytest.mark.parametrize("name,args,kw", [
    ("eye", (3,), {}), ("eye", (4, 6, 1), {}), ("eye", (5, 3, -2), {}),
    ("linspace", (0, 1, 5), {}), ("linspace", (-2.0, 3.0, 7),
                                  {"endpoint": False})])
def test_nd_creation_names_match_reference(name, args, kw):
    want = getattr(ref.nd, name)(*args, **kw).asnumpy()
    got = getattr(nd, name)(*args, **kw).asnumpy()
    assert got.dtype == want.dtype
    if name == "eye":
        np.testing.assert_array_equal(got, want)
    else:
        # the port's _linspace rounds a float64 ramp, the reference's
        # accumulates its float32 steps: within four ulps of the largest
        # magnitude
        tol = 4 * np.spacing(np.float32(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_nd_randn_and_seed():
    nd.seed(7)
    a = nd.randn(256, 64)
    nd.seed(7)
    b = nd.randn(256, 64)
    assert a.shape == (256, 64) and a.dtype == np.float32
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    x = a.asnumpy().ravel()
    se = 1.0 / np.sqrt(x.size)
    assert abs(x.mean()) < 6 * se and abs(x.var() - 1) < 6 * np.sqrt(2) * se
    assert nd.randn is nd.random.randn and nd.seed is nd.random.seed
    assert not np.array_equal(nd.randn(8).asnumpy(), nd.randn(8).asnumpy())


def test_sym_arange_and_ones_match_reference():
    """The port's nodes run to the reference's ``nd`` values; the
    reference's own nodes carry a phantom ``data`` argument and fail to
    bind (ROADMAP.md C19), as shown."""
    s = sym.arange(0, 12, 2, repeat=2) * sym.ones((12,))
    assert s.list_arguments() == [] and s.infer_shape()[1] == [(12,)]
    got = s.bind("cpu", args={}).forward()[0].asnumpy()
    want = (ref.nd.arange(0, 12, 2, repeat=2) * ref.nd.ones((12,))).asnumpy()
    np.testing.assert_array_equal(got, want)
    rs = ref.sym.arange(0, 12, 2, repeat=2)
    (phantom,) = rs.list_arguments()
    assert phantom.endswith("_data")
    with pytest.raises(TypeError, match="start"):
        rs.bind(None, args={phantom: np.zeros(1, np.float32)}).forward()


# -- initializers ----------------------------------------------------------------
def _both(make_init, shape=(64, 32, 3, 3), name="fc_weight", seed=3):
    arrs = []
    for pkg in (ref, mx):
        a = pkg.nd.zeros(shape)
        np.random.seed(seed)
        make_init(pkg)(pkg.init.InitDesc(name), a)
        arrs.append(a.asnumpy())
    return arrs


@pytest.mark.parametrize("make,shape", [
    (lambda p: p.init.MSRAPrelu(), (64, 32, 3, 3)),
    (lambda p: p.init.MSRAPrelu(factor_type="in", slope=0.0), (256, 128)),
    (lambda p: p.init.Orthogonal(), (64, 288)),
    (lambda p: p.init.Orthogonal(scale=0.5, rand_type="normal"),
     (32, 8, 3, 3)),
    (lambda p: p.init.Bilinear(), (4, 1, 4, 4)),
    (lambda p: p.init.Bilinear(), (3, 2, 5, 5)),
], ids=["msra", "msra_he", "orth", "orth_normal", "bilinear4",
        "bilinear5"])
def test_initializers_bitwise_equal_reference(make, shape):
    want, got = _both(make, shape)
    np.testing.assert_array_equal(got, want)


def test_initializers_reference_checks():
    a = _both(lambda p: p.init.MSRAPrelu(factor_type="in", slope=0.0),
              (256, 128))[1]
    assert a.std() == pytest.approx(np.sqrt(2.0 / 128), rel=0.15)
    a = _both(lambda p: p.init.Orthogonal(), (256, 128))[1]
    g = a.T @ a
    np.testing.assert_allclose(g, np.eye(128) * g[0, 0],
                               atol=1e-3 * abs(g[0, 0]) * 128)
    # Bilinear weights make Deconvolution an exact 2x upsampler of a ramp
    w = nd.zeros((1, 1, 4, 4))
    init.Bilinear()(init.InitDesc("up_weight"), w)
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    out = nd.Deconvolution(nd.array(x), w, None, kernel=(4, 4),
                           stride=(2, 2), pad=(1, 1), num_filter=1,
                           no_bias=True).asnumpy()
    want = ref.nd.Deconvolution(
        ref.nd.array(x), ref.nd.array(w.asnumpy()), None, kernel=(4, 4),
        stride=(2, 2), pad=(1, 1), num_filter=1, no_bias=True).asnumpy()
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
    assert out.shape == (1, 1, 8, 8)
    for name in ("msraprelu", "orthogonal", "bilinear"):
        assert type(init.create(name)).__name__.lower() == name
    rt = init.create(init.MSRAPrelu(slope=0.1).dumps())
    assert rt._kwargs == {"factor_type": "avg", "slope": 0.1}


def test_mixed_and_load_match_reference():
    """The FCN-xs upsampler init (``examples/fcn_xs/train_fcn.py:117``):
    ``Mixed`` routes ``*upsampling*`` to Bilinear and the rest to
    Xavier; ``Load`` takes saved ``arg:`` arrays and falls back."""
    shapes = {"score_weight": (21, 64, 1, 1), "upsampling_weight":
              (21, 1, 16, 16), "conv1_weight": (64, 3, 3, 3)}
    for name, shape in shapes.items():
        want, got = _both(lambda p: p.init.Mixed(
            [".*upsampling.*", ".*"], [p.init.Bilinear(), p.init.Xavier()]),
            shape, name)
        np.testing.assert_array_equal(got, want, err_msg=name)
    with pytest.raises(ValueError, match="pattern"):
        init.Mixed(["up.*"], [init.Bilinear()])(init.InitDesc("w"),
                                                 nd.zeros((2, 2)))
    saved = {"arg:fc_weight": np.arange(6, dtype=np.float32).reshape(2, 3)}
    for name, shape in (("fc_weight", (2, 3)), ("fc_bias", (2,))):
        want, got = _both(lambda p: p.init.Load(
            {k: p.nd.array(v) for k, v in saved.items()},
            default_init=p.init.Constant(0.5)), shape, name)
        np.testing.assert_array_equal(got, want, err_msg=name)
    with pytest.raises(ValueError, match="shape mismatch"):
        init.Load(saved)(init.InitDesc("fc_weight"), nd.zeros((3, 2)))
    with pytest.raises(ValueError, match="default_init"):
        init.Load(saved)(init.InitDesc("other"), nd.zeros((3, 2)))


def test_mixed_initializes_an_fcn_upsampler_block():
    net = gluon.nn.HybridSequential(prefix="fcn_")
    with net.name_scope():
        net.add(gluon.nn.Conv2D(8, 3, padding=1, in_channels=3))
        net.add(gluon.nn.Conv2DTranspose(8, 4, strides=2, padding=1,
                                         in_channels=8, prefix="upsampling_",
                                         use_bias=False))
    net.initialize(init.Mixed([".*upsampling.*", ".*"],
                              [init.Bilinear(), init.Xavier()]), ctx="cpu",
                   rng=np.random.RandomState(0))
    params = net.collect_params()
    up = params["fcn_upsampling_weight"].data().asnumpy()
    want = np.zeros(up.shape, np.float32)
    init.Bilinear()._init_weight(None, want, None)
    np.testing.assert_array_equal(up, want)
    assert np.abs(params["fcn_conv2d0_weight"].data().asnumpy()).max() > 0
    assert net(nd.ones((1, 3, 8, 8))).shape == (1, 8, 16, 16)


# -- gluon.Constant and SymbolBlock -------------------------------------------------
def test_gluon_constant_matches_reference():
    value = [[1.0, 2.0], [3.0, 4.0]]
    want = ref.gluon.Constant("c", value)
    got = gluon.Constant("c", value)
    assert got.grad_req == want.grad_req == "null"
    assert got.shape == want.shape
    want.initialize()
    got.initialize(ctx="cpu")
    np.testing.assert_array_equal(got.data().asnumpy(),
                                  want.data().asnumpy())

    class Scale(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.c = gluon.Constant("c", value)
                self.w = self.params.get("w", shape=(2, 2))

        def hybrid_forward(self, F, x, c, w):
            return F.dot(x, c) * w

    net = Scale()
    net.initialize(init.One(), ctx="cpu")
    net.c.initialize(ctx="cpu")
    params = net.collect_params()
    params.update({net.c.name: net.c})
    tr = gluon.Trainer(params, "sgd",
                       {"learning_rate": 1.0}, kvstore="device")
    with mx.autograd.record():
        loss = net(nd.ones((1, 2))).sum()
    loss.backward()
    tr.step(1)
    np.testing.assert_array_equal(net.c.data().asnumpy(), value)
    assert not np.array_equal(net.w.data().asnumpy(), np.ones((2, 2)))


def _conv_net(pkg):
    data = pkg.sym.Variable("data")
    c = pkg.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                            name="c1")
    b = pkg.sym.BatchNorm(c, name="bn1", fix_gamma=False)
    a = pkg.sym.Activation(b, act_type="relu")
    f = pkg.sym.FullyConnected(pkg.sym.Flatten(a), num_hidden=5, name="fc")
    return pkg.sym.SoftmaxOutput(f, name="softmax"), data


def test_symbol_block_matches_reference_executor():
    out, data = _conv_net(mx)
    blk = gluon.SymbolBlock(out.get_internals()["fc_output"], data)
    assert gluon.nn.SymbolBlock is gluon.SymbolBlock
    assert sorted(blk.collect_params().keys()) == [
        "bn1_beta", "bn1_gamma", "bn1_moving_mean", "bn1_moving_var",
        "c1_bias", "c1_weight", "fc_bias", "fc_weight"]
    assert blk.collect_params()["bn1_moving_var"].grad_req == "null"
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 6, 6).astype(np.float32)
    blk.initialize(init.Xavier(), ctx="cpu", rng=np.random.RandomState(1))
    got = blk(nd.array(x)).asnumpy()
    params = {n: p.data().asnumpy() for n, p in
              blk.collect_params().items()}
    rout, rdata = _conv_net(ref)
    rnet = rout.get_internals()["fc_output"]
    aux = {n: params[n] for n in rnet.list_auxiliary_states()}
    args = {n: params[n] for n in rnet.list_arguments() if n != "data"}
    args["data"] = x
    want = rnet.bind(None, args=args, aux_states=aux).forward()[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the reference's own block builds, with no parameters, and cannot run
    rblk = ref.gluon.SymbolBlock(rnet, rdata)
    assert list(rblk.collect_params().keys()) == []
    with pytest.raises(ImportError, match="eval_symbol"):
        rblk(ref.nd.array(x))
    # training mode: gradients through the graph, moving stats updated
    before = params["bn1_moving_mean"].copy()
    with mx.autograd.record():
        loss = blk(nd.array(x)).sum()
    loss.backward()
    assert np.abs(blk.collect_params()["c1_weight"].grad().asnumpy()).max() > 0
    assert not np.array_equal(
        blk.collect_params()["bn1_moving_mean"].data().asnumpy(), before)


def test_symbol_block_imports_module_checkpoint(tmp_path):
    out, _ = _conv_net(mx)
    rng = np.random.RandomState(2)
    x = rng.randn(8, 3, 6, 6).astype(np.float32)
    y = (np.arange(8) % 5).astype(np.float32)
    mod = mx.mod.Module(out, context="cpu")
    it = mx.io.NDArrayIter(x, y, 4)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(init.Xavier(), rng=np.random.RandomState(3))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    mod.fit(it, num_epoch=1)
    prefix = str(tmp_path / "net")
    mod.save_checkpoint(prefix, 1)
    want = mod.predict(mx.io.NDArrayIter(x, None, 4)).asnumpy()
    # the label is an input, as in MXNet: SoftmaxOutput ignores it forward
    blk = gluon.SymbolBlock.imports(prefix + "-symbol.json",
                                    ["data", "softmax_label"],
                                    prefix + "-0001.params", ctx="cpu")
    got = blk(nd.array(x), nd.array(y)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_top_level_names():
    assert mx.NDArray is nd.NDArray
    assert mx.Symbol is sym.Symbol
    from mxnet_tpu_torch.executor import Executor
    assert mx.Executor is Executor
    assert isinstance(nd.zeros((1,)), mx.NDArray)
    assert isinstance(sym.Variable("a"), mx.Symbol)


# -- tools/op_bench.py ---------------------------------------------------------------
def test_op_bench_on_the_cpu(tmp_path):
    from mxnet_tpu.ops import registry as ref_registry
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.tools import op_bench
    from mxnet_tpu_torch.tools.op_cases import CASES
    ref_registry.load_all() if hasattr(ref_registry, "load_all") else None
    registry.load_all()
    names = sorted({c.name for c in CASES})
    assert set(names) <= set(registry.list_ops())
    assert set(names) <= set(ref_registry.list_ops())
    lines = []
    out = tmp_path / "ops.jsonl"
    records, summary = op_bench.main(
        ["--ops", "_eye", "flip", "topk", "nothing", "--iters", "2",
         "--grad", "--eager", "--scale", "2", "--device", "cpu",
         "--out", str(out)], emit=lines.append)
    assert summary["timed"] == 3 and summary["errors"] == 1
    assert len(lines) == 5 and out.read_text().count("\n") == 5
    by = {r["op"]: r for r in records}
    assert by["nothing"]["error"] == "no case"
    flip = by["flip"]
    assert flip["device"] == "cpu" and flip["shapes"] == [[64, 3, 224, 224]]
    assert flip["fwd_us"] > 0 and flip["eager_us"] > 0 and flip["bwd_us"] > 0
    assert "bwd_us" not in by["_eye"]
