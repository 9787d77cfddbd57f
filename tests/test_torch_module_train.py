"""Training through Symbol, Executor and Module in mxnet_tpu_torch, held
against mxnet_tpu on the CPU.

Both packages get the same seeded numpy inputs; initial weights are
drawn by each package's initializer after ``mx.random.seed`` (bitwise
the same draws) or carried from numpy.

- ``Executor.backward`` against the reference's for ``grad_req``
  ``"write"`` / ``"add"`` / ``"null"`` (str, list and dict), ``out_grads``
  given and not, several heads, ``BatchNorm(fix_gamma=True)``'s gamma and
  ``BlockGrad``'s input (zeros, not missing), ``SoftmaxOutput``'s options
  on the backward, a backward with no training forward before it, and
  the moving statistics (updated once per training forward, never in
  backward): 1e-5 (f32; only reduction orders differ).
- ``Module``: ``inputs_need_grad``, ``fixed_param_names``, ``grad_req``
  ``"add"``, ``shared_module``, ``for_training=False``, the optimizer's
  ``rescale_grad`` and ``param_idx2name``.
- ``Module.fit`` -> ``score`` -> ``predict`` on the reference test's MLP
  (``tests/test_module.py:9-37``) and on LeNet: every parameter after
  every step within 1e-5, scores equal, predictions 1e-5.  On
  ``get_symbol(10, 18, "3,32,32")`` (the symbolic pre-activation ResNet,
  batch 4, two steps): the first step's outputs 2e-5 and parameters
  5e-6 (the training rows' tolerances).  From Xavier weights a
  BatchNorm net amplifies rounding once it has stepped (at lr 0.1 a
  channel near zero variance multiplies it by up to 1/sqrt(eps)), so the
  second step's parameters, the moving statistics and the predictions
  are held to 10x the rounding floor measured here: the port's run from
  initial weights one f32 ulp up (a one-ulp input change stays under
  that floor, as ``bn_data`` normalizes it away).
- Checkpoints: ``prefix-symbol.json`` and ``.params`` (both formats)
  written by either package load in the other and give the same
  predictions; the ``.params`` files of the same values are the same
  bytes; optimizer ``.states`` files cross both ways (the next step
  within 1e-6); ``Module.load(..., load_optimizer_states=True)``.
- An explicit ``KVStore`` given to ``init_optimizer``, as ``fit`` passes
  its ``kvstore`` on (``update_on_kvstore``): the port's store runs the
  module's optimizer itself, as MXNet's does; the reference's runs a
  pickled copy, which ``set_learning_rate`` never reaches (ROADMAP.md
  section C2, shown here).

The same step on the card: ``tests/test_torch_module_cuda.py``.
"""
import importlib.util
import os
import pickle

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import name as jname
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.tools.symbols import resnet as tresnet

_spec = importlib.util.spec_from_file_location(
    "_reference_resnet_symbols", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "examples",
        "image_classification", "symbols", "resnet.py"))
jresnet = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jresnet)

TOL = 1e-5
STEP_OUT_TOL, STEP_PARAM_TOL = 2e-5, 5e-6
NOISE_FACTOR = 10
BOTH = (("ref", mx), ("port", tmx))


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _close(want, got, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=msg)


def _np(d):
    return {k: v.asnumpy() for k, v in d.items() if v is not None}


def _toy(n=400, d=16, k=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d, k).astype(np.float32) * 2
    return X, np.argmax(X @ w, axis=1).astype(np.float32)


def _mlp(m, k=3):
    data = m.sym.Variable("data")
    net = m.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = m.sym.Activation(net, act_type="relu", name="relu1")
    net = m.sym.FullyConnected(net, num_hidden=k, name="fc2")
    return m.sym.SoftmaxOutput(net, name="softmax")


def _lenet(m):
    data = m.sym.Variable("data")
    c1 = m.sym.Convolution(data, kernel=(5, 5), num_filter=6, name="c1")
    t1 = m.sym.Activation(c1, act_type="tanh", name="t1")
    p1 = m.sym.Pooling(t1, pool_type="max", kernel=(2, 2), stride=(2, 2),
                       name="p1")
    c2 = m.sym.Convolution(p1, kernel=(3, 3), num_filter=8, name="c2")
    t2 = m.sym.Activation(c2, act_type="tanh", name="t2")
    f = m.sym.Flatten(t2, name="flat")
    fc1 = m.sym.FullyConnected(f, num_hidden=20, name="fc1")
    t3 = m.sym.Activation(fc1, act_type="tanh", name="t3")
    fc2 = m.sym.FullyConnected(t3, num_hidden=4, name="fc2")
    return m.sym.SoftmaxOutput(fc2, name="softmax")


def _bn_net(m, **softmax_kw):
    """FC -> BatchNorm(fix_gamma) -> FC, a BlockGrad branch added in, and
    SoftmaxOutput: a fixed gamma and a blocked input, both zero
    gradients."""
    data = m.sym.Variable("data")
    fc = m.sym.FullyConnected(data, num_hidden=6, name="fc")
    bn = m.sym.BatchNorm(fc, fix_gamma=True, name="bn")
    side = m.sym.BlockGrad(m.sym.FullyConnected(data, num_hidden=6,
                                                name="side"), name="bg")
    act = m.sym.Activation(bn + side, act_type="tanh", name="act")
    out = m.sym.FullyConnected(act, num_hidden=4, name="out")
    return m.sym.SoftmaxOutput(out, name="softmax", **softmax_kw)


def _args(sym, shapes, seed=1, label_classes=4):
    """Seeded numpy values of every argument and aux state."""
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n.endswith("label"):
            args[n] = rng.randint(0, label_classes, s).astype(np.float32)
        else:
            args[n] = (rng.randn(*s) * 0.5).astype(np.float32)
    aux = {n: (np.abs(rng.randn(*s)) + 0.5 if n.endswith("var")
               else rng.randn(*s) * 0.1).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _bind(m, sym, args, aux, grad_req):
    ctx = m.cpu()
    return sym.bind(ctx, args={k: m.nd.array(v, ctx=ctx)
                               for k, v in args.items()},
                    grad_req=grad_req,
                    aux_states={k: m.nd.array(v, ctx=ctx)
                                for k, v in aux.items()})


# -- Executor.backward --------------------------------------------------------
@pytest.mark.parametrize("grad_req", [
    "write", "add", "null",
    ["write", "null", "write", "add", "write", "write", "null", "write",
     "write", "write"],
    {"fc_weight": "write", "bn_gamma": "write", "bn_beta": "add",
     "side_weight": "write", "data": "write"}])
def test_executor_backward_matches_reference(grad_req):
    shapes = {"data": (5, 7), "softmax_label": (5,)}
    runs = {}
    for tag, m in BOTH:
        sym = _bn_net(m)
        args, aux = _args(sym, shapes)
        exe = _bind(m, sym, args, aux, grad_req)
        for _ in range(2):
            exe.forward(is_train=True)
            exe.backward()
        runs[tag] = (_np(exe.grad_dict), exe.outputs[0].asnumpy(),
                     _np(exe.aux_dict), sym.list_arguments())
    (jg, jo, ja, names), (tg, to, ta, _) = runs["ref"], runs["port"]
    assert sorted(jg) == sorted(tg)
    for n in jg:
        _close(jg[n], tg[n], msg=n)
    _close(jo, to)
    for n in ja:
        _close(ja[n], ta[n], msg=n)
    if "bn_gamma" in tg:
        assert not tg["bn_gamma"].any(), "fix_gamma's gamma must be zeros"
    if "side_weight" in tg:
        assert not tg["side_weight"].any(), "BlockGrad's input: zeros"
    if grad_req == "null":
        assert tg == {}


@pytest.mark.parametrize("kw", [
    {}, {"grad_scale": 0.5}, {"normalization": "valid", "use_ignore": True,
                              "ignore_label": 1},
    {"use_ignore": True, "ignore_label": 2}, {"smooth_alpha": 0.1}])
def test_softmax_output_options_through_backward(kw):
    shapes = {"data": (6, 7), "softmax_label": (6,)}
    grads = {}
    for tag, m in BOTH:
        sym = _bn_net(m, **kw)
        args, aux = _args(sym, shapes, seed=3)
        exe = _bind(m, sym, args, aux, "write")
        exe.forward(is_train=True)
        exe.backward()
        grads[tag] = _np(exe.grad_dict)
    for n in grads["ref"]:
        _close(grads["ref"][n], grads["port"][n], msg=n)


def test_multi_output_softmax_and_heads_with_out_grads():
    """Two heads, one given a head gradient (a plain FC output), one a
    multi_output SoftmaxOutput; out_grads as a list."""
    res = {}
    for tag, m in BOTH:
        data = m.sym.Variable("data")
        conv = m.sym.Convolution(data, kernel=(1, 1), num_filter=3,
                                 name="conv")
        sm = m.sym.SoftmaxOutput(conv, multi_output=True, name="sm")
        fc = m.sym.FullyConnected(data, num_hidden=5, name="fc")
        sym = m.sym.Group([sm, fc])
        args, aux = _args(sym, {"data": (2, 4, 3, 3),
                                "sm_label": (2, 3, 3)}, label_classes=3)
        heads = [np.ones((2, 3, 3, 3), np.float32),
                 np.random.RandomState(5).randn(2, 5).astype(np.float32)]
        exe = _bind(m, sym, args, aux, "write")
        exe.forward(is_train=True)
        exe.backward([m.nd.array(h, ctx=m.cpu()) for h in heads])
        res[tag] = _np(exe.grad_dict)
    for n in res["ref"]:
        _close(res["ref"][n], res["port"][n], msg=n)


def test_backward_without_a_training_forward_reruns_it():
    """After an inference forward the backward takes the training-mode
    gradients (the reference rematerializes the forward), and no moving
    statistic moves in backward."""
    shapes = {"data": (5, 7), "softmax_label": (5,)}
    res = {}
    for tag, m in BOTH:
        sym = _bn_net(m)
        args, aux = _args(sym, shapes)
        exe = _bind(m, sym, args, aux, "write")
        exe.forward(is_train=False)
        before = _np(exe.aux_dict)
        exe.backward()
        res[tag] = (_np(exe.grad_dict), before, _np(exe.aux_dict))
    for n in res["ref"][0]:
        _close(res["ref"][0][n], res["port"][0][n], msg=n)
    for n, v in res["port"][1].items():
        assert res["port"][2][n].tobytes() == v.tobytes(), n


def test_moving_statistics_update_once_per_training_forward():
    sym = _bn_net(tmx)
    args, aux = _args(sym, {"data": (5, 7), "softmax_label": (5,)})
    exe = _bind(tmx, sym, args, aux, "write")
    exe.forward(is_train=True)
    after_fwd = _np(exe.aux_dict)
    assert not np.array_equal(after_fwd["bn_moving_mean"],
                              aux["bn_moving_mean"])
    exe.backward()
    exe.backward()   # a second backward reruns on copies of the stats
    for n, v in after_fwd.items():
        assert _np(exe.aux_dict)[n].tobytes() == v.tobytes(), n
    with pytest.raises(tmx.MXNetError):
        _bind(tmx, sym, args, aux, "write").backward()


def test_executor_reshape_copy_params_and_output_dict():
    """``reshape`` to a new batch keeps the parameters (shared tensors)
    and grad_req; ``copy_params_from`` casts and places; ``output_dict``
    names the heads."""
    shapes = {"data": (5, 7), "softmax_label": (5,)}
    res = {}
    for tag, m in BOTH:
        sym = _bn_net(m)
        args, aux = _args(sym, shapes)
        exe = sym.simple_bind(m.cpu(), grad_req="write", data=(5, 7),
                              softmax_label=(5,))
        exe.copy_params_from({k: m.nd.array(v, ctx=m.cpu())
                              for k, v in args.items()},
                             {k: m.nd.array(v, ctx=m.cpu())
                              for k, v in aux.items()})
        small = exe.reshape(data=(3, 7), softmax_label=(3,))
        small.forward(is_train=True, data=args["data"][:3],
                      softmax_label=args["softmax_label"][:3])
        small.backward()
        res[tag] = (sorted(small.output_dict),
                    small.output_dict["softmax_output"].asnumpy(),
                    _np(small.grad_dict))
        with pytest.raises(m.MXNetError if tag == "port" else Exception):
            exe.copy_params_from({"nope": args["data"]})
    assert res["ref"][0] == res["port"][0] == ["softmax_output"]
    _close(res["ref"][1], res["port"][1])
    for n in res["ref"][2]:
        _close(res["ref"][2][n], res["port"][2][n], msg=n)


def test_dropout_gradient_uses_the_forward_draw():
    data = tmx.sym.Variable("data")
    sym = tmx.sym.Dropout(data, p=0.5, name="drop")
    x = np.ones((64, 32), np.float32)
    exe = sym.bind("cpu", args={"data": x}, grad_req="write")
    tmx.random.seed(4)
    out = exe.forward(is_train=True)[0].asnumpy()
    exe.backward(tmx.nd.array(np.ones_like(x), ctx="cpu"))
    np.testing.assert_array_equal(exe.grad_dict["data"].asnumpy(), out)
    assert 0.3 < (out == 0).mean() < 0.7


def test_inference_path_keeps_no_graph_and_its_cache_keys():
    sym = _mlp(tmx)
    X, y = _toy(8)
    mod = tmx.mod.Module(sym, context="cpu")
    mod.bind([("data", X.shape)], [("softmax_label", y.shape)],
             for_training=False)
    mod.init_params(tmx.init.Xavier(), rng=np.random.RandomState(0))
    assert mod._exec._wrt == [] and mod._exec.grad_dict == {}
    batch = tmx.io.DataBatch([tmx.nd.array(X, ctx="cpu")],
                             [tmx.nd.array(y, ctx="cpu")])
    for _ in range(3):
        mod.forward(batch, is_train=False)
        assert mod._exec._graph is None
        assert not mod.get_outputs()[0]._data.requires_grad
    assert len(mod.jit_cache_keys()) == 1
    (key,) = mod.jit_cache_keys()
    assert key[0] is False


# -- Module bind options ------------------------------------------------------
def _module_grads(m, sym, X, y, arg, **bind_kw):
    mod = m.mod.Module(sym, context=m.cpu(),
                       fixed_param_names=bind_kw.pop("fixed", None))
    mod.bind([("data", X.shape)], [("softmax_label", y.shape)], **bind_kw)
    mod.init_params(arg_params=arg)
    batch = m.io.DataBatch([m.nd.array(X, ctx=m.cpu())],
                           [m.nd.array(y, ctx=m.cpu())])
    for _ in range(2 if bind_kw.get("grad_req") == "add" else 1):
        mod.forward(batch, is_train=True)
        mod.backward()
    out = _np(mod._exec.grad_dict)
    if mod.inputs_need_grad:
        out["__input"] = mod.get_input_grads()[0].asnumpy()
    return out


@pytest.mark.parametrize("kw", [
    {"inputs_need_grad": True}, {"fixed": ["fc1_weight"]},
    {"grad_req": "add"}])
def test_module_bind_options(kw):
    X, y = _toy(10)
    sym_j, sym_t = _mlp(mx), _mlp(tmx)
    arg, _ = _args(sym_t, {"data": X.shape, "softmax_label": y.shape})
    arg = {k: v for k, v in arg.items() if k not in ("data",
                                                      "softmax_label")}
    want = _module_grads(mx, sym_j, X, y, arg, **dict(kw))
    got = _module_grads(tmx, sym_t, X, y, arg, **dict(kw))
    assert sorted(want) == sorted(got)
    for n in want:
        _close(want[n], got[n], msg=n)
    if "fixed" in kw:
        assert "fc1_weight" not in got


def test_shared_module_shares_the_parameter_objects():
    X, y = _toy(10)
    a = tmx.mod.Module(_mlp(tmx), context="cpu")
    a.bind([("data", X.shape)], [("softmax_label", y.shape)])
    a.init_params(tmx.init.Xavier(), rng=np.random.RandomState(0))
    b = tmx.mod.Module(_mlp(tmx), context="cpu")
    b.bind([("data", (4, 16))], [("softmax_label", (4,))],
           shared_module=a)
    for n in a._param_names:
        assert b._exec.arg_dict[n] is a._exec.arg_dict[n]
    b.forward(tmx.io.DataBatch([tmx.nd.array(X[:4], ctx="cpu")],
                               [tmx.nd.array(y[:4], ctx="cpu")]),
              is_train=False)
    assert b.get_outputs()[0].shape == (4, 3)
    assert b.output_shapes == [("softmax_output", (4, 3))]


def test_init_optimizer_rescale_and_names():
    X, y = _toy(10)
    for m in (mx, tmx):
        mod = m.mod.Module(_mlp(m), context=m.cpu())
        mod.bind([("data", (5, 16))], [("softmax_label", (5,))])
        mod.init_params(m.init.Xavier())
        mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
        assert mod._optimizer.rescale_grad == pytest.approx(0.2)
        assert mod._optimizer.idx2name == dict(enumerate(
            ["fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"]))
        assert mod._kvstore is None and mod._updater is not None


# -- fit / score / predict ----------------------------------------------------
class _Trace:
    """batch_end_callback: the outputs of each step's forward and the
    parameters after each update."""

    def __init__(self):
        self.outs, self.params = [], []

    def __call__(self, param):
        mod = param.locals["self"]
        self.outs.append(mod.get_outputs()[0].asnumpy())
        self.params.append(_np(mod.get_params()[0]))


def _commit_reference(mod):
    """Commit the reference module's arrays to the CPU device.  Its jit
    caches committed and uncommitted arrays apart, and its first update
    commits the weights, so without this it compiles every program again
    at the second step (~12 s for the ResNet-18 on one core); the values
    are unchanged."""
    import jax
    dev = jax.devices("cpu")[0]
    for table in (mod._exec.arg_dict, mod._exec.aux_dict):
        for a in table.values():
            a._set_data(jax.device_put(a._data, dev))


def _fit(m, sym, X, y, Xv, yv, batch, epochs, opt_params, init,
         params=(None, None)):
    """bind and initialize (``init(m)`` after ``mx.random.seed(0)``, or
    ``params``), then fit -> score -> predict."""
    m.random.seed(0)
    train = m.io.NDArrayIter(X, y, batch, shuffle=True, shuffle_seed=7)
    val = m.io.NDArrayIter(Xv, yv, batch)
    mod = m.mod.Module(sym, context=m.cpu())
    mod.bind(train.provide_data, train.provide_label)
    mod.init_params(initializer=init(m) if init else None,
                    arg_params=params[0], aux_params=params[1])
    if m is mx:
        _commit_reference(mod)
    trace = _Trace()
    mod.fit(train, eval_data=val, optimizer="sgd",
            optimizer_params=dict(opt_params), num_epoch=epochs,
            batch_end_callback=trace)
    return (trace, mod.score(val, "acc")[0][1], mod.predict(val).asnumpy(),
            _np(mod.get_params()[1]))


@pytest.mark.parametrize("which", ["mlp", "lenet"])
def test_fit_score_predict_match_reference(which):
    if which == "mlp":
        X, y = _toy(160)
        nets = {"ref": _mlp(mx), "port": _mlp(tmx)}
        split, batch, epochs = 120, 20, 3
        opt = {"learning_rate": 0.5, "momentum": 0.9}
    else:
        rng = np.random.RandomState(0)
        X = rng.rand(24, 1, 12, 12).astype(np.float32)
        y = (X.reshape(24, -1)[:, :4].argmax(1)).astype(np.float32)
        nets = {"ref": _lenet(mx), "port": _lenet(tmx)}
        split, batch, epochs = 16, 8, 1
        opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    res = {tag: _fit(m, nets[tag], X[:split], y[:split], X[split:],
                     y[split:], batch, epochs, opt,
                     lambda m: m.init.Xavier())
           for tag, m in BOTH}
    (jt, jacc, jpred, _), (tt, tacc, tpred, _) = res["ref"], res["port"]
    assert len(jt.params) == len(tt.params) == epochs * split // batch
    for i, (jp, tp) in enumerate(zip(jt.params, tt.params)):
        for n in jp:
            _close(jp[n], tp[n], msg="step %d %s" % (i, n))
    assert jacc == tacc
    _close(jpred, tpred)
    assert tpred.shape == (len(X) - split, int(tpred.shape[1]))


def test_resnet_symbol_fit_matches_reference():
    """The symbolic pre-activation ResNet-18 at 32 x 32 through fit (2
    steps of batch 4), score and predict, from weights drawn once and
    carried into every run."""
    with jname.NameManager():
        jsym = jresnet.get_symbol(10, 18, "3,32,32")
    with tname.NameManager():
        tsym = tresnet.get_symbol(10, 18, "3,32,32")
    assert jsym.tojson() == tsym.tojson()
    rng = np.random.RandomState(0)
    X = rng.rand(12, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 12).astype(np.float32)
    tmx.random.seed(0)
    mod = tmx.mod.Module(tsym, context="cpu")
    mod.bind([("data", (4, 3, 32, 32))], [("softmax_label", (4,))])
    mod.init_params(tmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    arg, aux = [_np(d) for d in mod.get_params()]
    # the rounding floor: the port's run from weights one f32 ulp up
    up = {k: np.nextafter(v, np.float32(np.inf)) for k, v in arg.items()}
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    runs = [_fit(m, s, X[:8], y[:8], X[8:], y[8:], 4, 1, opt, None,
                 (a, aux))
            for m, s, a in ((mx, jsym, arg), (tmx, tsym, arg),
                            (tmx, tsym, up))]
    (jt, jacc, jpred, jaux), (tt, tacc, tpred, taux), (ut, _, upred, uaux) \
        = runs
    _close(jt.outs[0], tt.outs[0], STEP_OUT_TOL)
    for n in jt.params[0]:
        _close(jt.params[0][n], tt.params[0][n], STEP_PARAM_TOL, msg=n)

    def worst(a, b):
        return max(float(np.abs(a[n] - b[n]).max()) for n in a)

    for what, want, got, moved in (
            ("step 2", jt.params[1], tt.params[1], ut.params[1]),
            ("moving statistics", jaux, taux, uaux),
            ("predictions", {"p": jpred}, {"p": tpred}, {"p": upred})):
        floor = worst(got, moved)
        assert worst(got, want) <= max(NOISE_FACTOR * floor,
                                       STEP_PARAM_TOL), (what, floor)
    assert np.isfinite(tpred).all() and tpred.shape == (4, 10)
    assert abs(jacc - tacc) <= 0.25


# -- checkpoints --------------------------------------------------------------
CKPT_X, CKPT_Y = _toy(60)


@pytest.fixture(scope="module")
def trained():
    """The MLP after one epoch of fit in each package: {tag: module}."""
    out = {}
    with use("cpu"):
        for tag, m in BOTH:
            m.random.seed(0)
            it = m.io.NDArrayIter(CKPT_X, CKPT_Y, 20)
            mod = m.mod.Module(_mlp(m), context=m.cpu())
            mod.bind(it.provide_data, it.provide_label)
            mod.init_params(m.init.Xavier())
            if m is mx:
                _commit_reference(mod)
            mod.fit(it, optimizer="sgd", num_epoch=1,
                    optimizer_params={"learning_rate": 0.1,
                                      "momentum": 0.9})
            out[tag] = mod
    return out


@pytest.mark.parametrize("fmt", ["mxtpu", "mxnet"])
def test_checkpoints_cross_both_packages(tmp_path, fmt, trained):
    jmod, tmod = trained["ref"], trained["port"]
    jarg, jaux = jmod.get_params()
    arg, _ = tmod.get_params()
    for n in jarg:
        _close(jarg[n].asnumpy(), arg[n].asnumpy(), msg=n)
    # the same values, the reference's, saved by both packages
    jp, tp = str(tmp_path / "ref"), str(tmp_path / "port")
    mx.model.save_checkpoint(jp, 1, jmod.symbol, jarg, jaux, format=fmt)
    tmx.model.save_checkpoint(tp, 1, tmod.symbol,
                              {k: v.asnumpy() for k, v in jarg.items()},
                              {}, format=fmt)
    with open(jp + "-0001.params", "rb") as a, \
            open(tp + "-0001.params", "rb") as b:
        assert a.read() == b.read()
    with open(jp + "-symbol.json") as a, open(tp + "-symbol.json") as b:
        assert a.read() == b.read()
    preds = {}
    for tag, m, prefix in (("port<-ref", tmx, jp), ("ref<-port", mx, tp)):
        mod = m.mod.Module.load(prefix, 1, context=m.cpu())
        pit = m.io.NDArrayIter(CKPT_X, CKPT_Y, 20)
        mod.bind(pit.provide_data, pit.provide_label, for_training=False)
        preds[tag] = mod.predict(pit).asnumpy()
    preds["ref"] = jmod.predict(mx.io.NDArrayIter(CKPT_X, CKPT_Y,
                                                  20)).asnumpy()
    _close(preds["ref"], preds["port<-ref"])
    _close(preds["ref"], preds["ref<-port"])


def test_optimizer_states_cross_both_packages(tmp_path, trained):
    X, y = CKPT_X, CKPT_Y
    for tag, mod in trained.items():
        mod.save_checkpoint(str(tmp_path / tag), 1, save_optimizer_states=True)
    with open(tmp_path / "ref-0001.states", "rb") as f:
        jstates = pickle.load(f)
    with open(tmp_path / "port-0001.states", "rb") as f:
        tstates = pickle.load(f)
    assert sorted(jstates) == sorted(tstates)
    for k in jstates:
        _close(np.asarray(jstates[k]), np.asarray(tstates[k]), msg=str(k))
    batch = (X[:20], y[:20])
    after = {}
    for tag, m, prefix in (("port<-ref", tmx, "ref"), ("ref<-port", mx,
                                                       "port"),
                           ("ref", mx, "ref")):
        mod = m.mod.Module.load(str(tmp_path / prefix), 1,
                                load_optimizer_states=True, context=m.cpu())
        mod.bind([("data", (20, 16))], [("softmax_label", (20,))])
        mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9})
        mod.forward_backward(m.io.DataBatch(
            [m.nd.array(batch[0], ctx=m.cpu())],
            [m.nd.array(batch[1], ctx=m.cpu())]))
        mod.update()
        after[tag] = _np(mod.get_params()[0])
    for n in after["ref"]:
        _close(after["ref"][n], after["port<-ref"][n], 1e-6, msg=n)
        _close(after["ref"][n], after["ref<-port"][n], 1e-6, msg=n)


def test_explicit_kvstore_runs_the_modules_optimizer():
    """An explicit KVStore, as fit passes it to init_optimizer:
    update_on_kvstore.  The port's store
    runs the module's optimizer object, so ``set_learning_rate(0)`` on it
    stops training, as in MXNet; the reference's store runs a pickled copy
    that never sees the change (ROADMAP.md C2), and its weights move."""
    X, y = _toy(40)
    moved = {}
    for tag, m in BOTH:
        m.random.seed(0)
        it = m.io.NDArrayIter(X, y, 20)
        mod = m.mod.Module(_mlp(m), context=m.cpu())
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(m.init.Xavier())
        mod.init_optimizer(kvstore=m.kv.create("local"),
                           optimizer_params={"learning_rate": 0.1})
        assert mod._update_on_kvstore
        mod._optimizer.set_learning_rate(0.0)
        before = _np(mod.get_params()[0])
        mod.forward_backward(next(iter(it)))
        mod.update()
        after = _np(mod.get_params()[0])
        moved[tag] = max(float(np.abs(after[n] - before[n]).max())
                         for n in before)
    assert moved["port"] == 0.0
    assert moved["ref"] > 0.0   # the stale copy still steps at lr 0.1
