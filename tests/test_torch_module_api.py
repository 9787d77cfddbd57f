"""The rest of the Module surface of mxnet_tpu_torch held against
mxnet_tpu on the CPU: ``FeedForward``, ``BucketingModule``,
``SequentialModule``, ``Monitor``, the callbacks, the Symbol sugar and
``CustomOp``.

- ``FeedForward.fit`` / ``predict`` / ``score`` and a saved and reloaded
  model: predictions within 1e-5 of the reference's, scores equal.
- ``BucketingModule``: steps through two bucket keys, parameters after
  each step within 1e-5; the buckets share the default module's
  parameter objects and optimizer.
- ``SequentialModule`` (two modules, ``take_labels``, ``auto_wiring``):
  outputs, parameters after two steps and the first module's input
  gradients within 1e-5.
- ``Monitor``: the names and statistics of every matched internal output
  within 1e-5 (the stat runs only at ``toc``), the eager tap on ``nd``
  ops, the ``mxtpu_monitor_*`` counters in the telemetry registry.
- The callbacks: the lines ``Speedometer``, ``log_train_metric``,
  ``ProgressBar``, ``LogValidationMetricsCallback`` log are the
  reference's, rates aside; ``do_checkpoint`` / ``module_checkpoint``
  write the files the reference's write.
- The Symbol sugar: every arithmetic and comparison operator with
  symbols and scalars, both orders, ``__neg__``, the method sugar,
  composition by call, ``get_children``, ``list_inputs``, ``attr``,
  ``infer_shape_partial``, ``save`` / ``load``, ``eval``: the same JSON
  and outputs within 1e-6 of the reference's; ``Symbol.grad`` raises with
  the reference's reason.
- ``CustomOp`` (the cases of ``tests/test_custom_op.py``, and a softmax
  with ``need_top_grad=False`` through ``req`` and ``assign``): outputs
  and gradients within 1e-6 of the reference's.
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.context import use

TOL = 1e-5
OP_TOL = 1e-6
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
    return {k: v.asnumpy() for k, v in d.items()}


def _toy(n=200, d=8, k=2, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d, k).astype(np.float32) * 2
    return X, np.argmax(X @ w, axis=1).astype(np.float32)


def _mlp(m, k=2):
    data = m.sym.Variable("data")
    net = m.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = m.sym.Activation(net, act_type="relu", name="relu1")
    net = m.sym.FullyConnected(net, num_hidden=k, name="fc2")
    return m.sym.SoftmaxOutput(net, name="softmax")


def _batch(m, x, y=None, **kw):
    return m.io.DataBatch([m.nd.array(x, ctx=m.cpu())],
                          None if y is None else
                          [m.nd.array(y, ctx=m.cpu())], **kw)


# -- FeedForward --------------------------------------------------------------
def test_feedforward_fit_predict_score_and_reload(tmp_path):
    """The port's reloaded model predicts as the trained one.  The
    reference's cannot: its ``predict`` binds a module with no label
    names, so ``softmax_label`` counts as a missing parameter
    (ROADMAP.md C6, shown here)."""
    X, y = _toy()
    out = {}
    for tag, m in BOTH:
        m.random.seed(0)
        model = m.model.FeedForward(_mlp(m), ctx=m.cpu(), num_epoch=3,
                                    learning_rate=0.5, momentum=0.9,
                                    numpy_batch_size=50,
                                    initializer=m.init.Xavier())
        # an iterator of one seeded shuffle (numpy arrays are shuffled
        # from fresh entropy)
        model.fit(m.io.NDArrayIter(X, y, 50, shuffle=True, shuffle_seed=7))
        pred = model.predict(X)
        acc = model.score(m.io.NDArrayIter(X, y, batch_size=50))
        model.save(str(tmp_path / tag), 3)
        again = m.model.FeedForward.load(str(tmp_path / tag), 3,
                                         ctx=m.cpu(), numpy_batch_size=50)
        out[tag] = (pred, acc, again)
    (jp, jacc, jagain), (tp, tacc, tagain) = out["ref"], out["port"]
    _close(jp, tp)
    _close(jp, tagain.predict(X))
    assert jacc == tacc and tacc > 0.8
    with pytest.raises(mx.MXNetError, match="softmax_label"):
        jagain.predict(X)


# -- BucketingModule ----------------------------------------------------------
def _sym_gen(m):
    def gen(key):
        data = m.sym.Variable("data")
        net = m.sym.FullyConnected(data, num_hidden=8, name="fc_shared")
        net = m.sym.sum(m.sym.reshape(net, shape=(0, 8, 1)), axis=2,
                        name="fold")
        net = m.sym.SoftmaxOutput(net, name="softmax")
        return net, ("data",), ("softmax_label",)
    return gen


def test_bucketing_module_matches_reference():
    rng = np.random.RandomState(0)
    w = (rng.randn(8, 12) * 0.3).astype(np.float32)
    b = np.zeros(8, np.float32)
    keys = (12, 6, 12)   # the key is the batch here; the width stays 12
    batches = [(rng.randn(k, 12).astype(np.float32),
                rng.randint(0, 8, k).astype(np.float32)) for k in keys]
    out = {}
    for tag, m in BOTH:
        mod = m.mod.BucketingModule(_sym_gen(m), default_bucket_key=12,
                                    context=m.cpu())
        mod.bind([("data", (10, 12))], [("softmax_label", (10,))])
        mod.init_params(arg_params={"fc_shared_weight": w,
                                    "fc_shared_bias": b})
        mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9})
        steps = []
        for key, (x, y) in zip(keys, batches):
            mod.forward(_batch(m, x, y, bucket_key=key, provide_data=[
                m.io.DataDesc("data", x.shape)], provide_label=[
                m.io.DataDesc("softmax_label", y.shape)]), is_train=True)
            mod.backward()
            mod.update()
            steps.append(_np(mod.get_params()[0]))
        out[tag] = (steps, mod)
    for i, (js, ts) in enumerate(zip(out["ref"][0], out["port"][0])):
        for n in js:
            _close(js[n], ts[n], msg="step %d %s" % (i, n))
    mod = out["port"][1]
    assert sorted(mod._buckets) == [6, 12]
    assert mod._buckets[6]._exec.arg_dict["fc_shared_weight"] is \
        mod._buckets[12]._exec.arg_dict["fc_shared_weight"]


def test_bucketing_switch_shares_parameters_and_optimizer():
    def gen(key):
        data = tmx.sym.Variable("data")
        net = tmx.sym.FullyConnected(data, num_hidden=3, name="fc")
        return tmx.sym.SoftmaxOutput(net, name="softmax"), ("data",), \
            ("softmax_label",)
    mod = tmx.mod.BucketingModule(gen, default_bucket_key=10,
                                  context="cpu")
    mod.bind([("data", (4, 5))], [("softmax_label", (4,))])
    mod.init_params(tmx.init.Xavier(), )
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
    x = np.ones((2, 5), np.float32)
    mod.forward(_batch(tmx, x, np.zeros(2, np.float32), bucket_key=5,
                       provide_data=[tmx.io.DataDesc("data", x.shape)],
                       provide_label=[tmx.io.DataDesc("softmax_label",
                                                      (2,))]),
                is_train=True)
    before = mod.get_params()[0]["fc_weight"].asnumpy()
    mod.backward()
    mod.update()
    small, default = mod._buckets[5], mod._buckets[10]
    assert small._exec.arg_dict["fc_weight"] is \
        default._exec.arg_dict["fc_weight"]
    assert small._updater is default._updater
    assert not np.array_equal(before,
                              mod.get_params()[0]["fc_weight"].asnumpy())


# -- SequentialModule ---------------------------------------------------------
def _seq_parts(m):
    d1 = m.sym.Variable("data")
    net1 = m.sym.Activation(m.sym.FullyConnected(d1, num_hidden=5, name="a"),
                            act_type="tanh", name="ta")
    d2 = m.sym.Variable("hidden")
    net2 = m.sym.SoftmaxOutput(m.sym.FullyConnected(
        d2, num_hidden=3, name="b"), name="softmax")
    return (m.mod.Module(net1, label_names=None, context=m.cpu()),
            m.mod.Module(net2, data_names=["hidden"], context=m.cpu()))


def test_sequential_module_matches_the_reference_chain():
    """The port's SequentialModule against the reference's two modules
    chained by hand (what its SequentialModule does).  The reference's
    SequentialModule itself cannot bind with ``auto_wiring``: it wires
    ``output_shapes``, which read the outputs of a forward not yet run
    (ROADMAP.md C6, shown here)."""
    X, y = _toy(20, d=6, k=3)
    rng = np.random.RandomState(1)
    params = {"a_weight": (rng.randn(5, 6) * 0.4).astype(np.float32),
              "a_bias": np.zeros(5, np.float32),
              "b_weight": (rng.randn(3, 5) * 0.4).astype(np.float32),
              "b_bias": np.zeros(3, np.float32)}
    opt = {"learning_rate": 0.2}
    batches = [(X[10 * i:10 * i + 10], y[10 * i:10 * i + 10])
               for i in range(2)]
    # the reference, by hand
    j1, j2 = _seq_parts(mx)
    j1.bind([("data", (10, 6))], inputs_need_grad=True)
    j2.bind([("hidden", (10, 5))], [("softmax_label", (10,))],
            inputs_need_grad=True)
    jm = mx.metric.Accuracy()
    for mod in (j1, j2):
        mod.init_params(arg_params=params, allow_missing=True)
        mod.init_optimizer(optimizer_params=opt)
    for x, lab in batches:
        j1.forward(_batch(mx, x), is_train=True)
        batch2 = mx.io.DataBatch(j1.get_outputs(), [mx.nd.array(lab)])
        j2.forward(batch2, is_train=True)
        j2.backward()
        j1.backward(j2.get_input_grads())
        j2.update_metric(jm, batch2.label)
        j1.update()
        j2.update()
    # the port's SequentialModule
    t1, t2 = _seq_parts(tmx)
    seq = tmx.mod.SequentialModule()
    seq.add(t1).add(t2, take_labels=True, auto_wiring=True)
    seq.bind([("data", (10, 6))], [("softmax_label", (10,))],
             inputs_need_grad=True)
    seq.init_params(arg_params=params)
    seq.init_optimizer(optimizer_params=opt)
    tm = tmx.metric.Accuracy()
    for x, lab in batches:
        batch = _batch(tmx, x, lab)
        seq.forward(batch, is_train=True)
        seq.backward()
        seq.update_metric(tm, batch.label)
        seq.update()
    _close(j2.get_outputs()[0].asnumpy(), seq.get_outputs()[0].asnumpy())
    want = dict(_np(j1.get_params()[0]), **_np(j2.get_params()[0]))
    got = _np(seq.get_params()[0])
    for n in want:
        _close(want[n], got[n], msg=n)
    _close(j1.get_input_grads()[0].asnumpy(),
           seq.get_input_grads()[0].asnumpy())
    assert jm.get() == tm.get()
    r1, r2 = _seq_parts(mx)
    rseq = mx.mod.SequentialModule()
    rseq.add(r1).add(r2, take_labels=True, auto_wiring=True)
    with pytest.raises(mx.MXNetError, match="cannot infer"):
        rseq.bind([("data", (10, 6))], [("softmax_label", (10,))])


# -- Monitor ------------------------------------------------------------------
def test_monitor_stats_match_reference_and_drain_at_toc():
    from mxnet_tpu_torch import telemetry
    X, y = _toy(20)
    calls, stats = [], {}
    for tag, m in BOTH:
        def stat(x, tag=tag):
            calls.append(tag)
            return float(np.abs(x).mean())
        m.random.seed(0)
        mod = m.mod.Module(_mlp(m), context=m.cpu())
        mod.bind([("data", (20, 8))], [("softmax_label", (20,))])
        mod.init_params(m.init.Xavier())
        mon = m.Monitor(interval=1, pattern=".*fc.*", stat_func=stat,
                        sort=True)
        mod.install_monitor(mon)
        mon.tic()
        mod.forward(_batch(m, X, y), is_train=False)
        if tag == "port":
            assert mon._pending and "port" not in calls
        stats[tag] = mon.toc()
    assert [k for _, k, _ in stats["ref"]] == [k for _, k, _ in
                                               stats["port"]]
    for (_, k, jv), (_, _, tv) in zip(stats["ref"], stats["port"]):
        _close(float(jv), float(tv), msg=k)
    text = telemetry.registry().prometheus_text()
    for name in ("mxtpu_monitor_pending", "mxtpu_monitor_observed_total",
                 "mxtpu_monitor_drains_total",
                 "mxtpu_monitor_drain_seconds_total"):
        assert name in text


def test_monitor_eager_tap_and_overflow(monkeypatch):
    mon = tmx.Monitor(interval=1, pattern=".*")
    mon.install_eager()
    try:
        mon.tic()
        a = tmx.nd.array(np.arange(6, dtype=np.float32), ctx="cpu")
        tmx.nd.relu(a - 2.0)
        names = [k for _, k, _ in mon.toc()]
        assert "relu_output" in names and "_minus_scalar_output" in names
    finally:
        mon.uninstall_eager()
    mon.tic()
    tmx.nd.relu(a)
    assert mon.toc() == []
    monkeypatch.setattr(tmx.monitor, "_MAX_PENDING", 8)
    mon.tic()
    for i in range(10):
        mon._park(i, "x%d" % i, np.float32(i))
    assert len(mon._pending) <= 8 and len(mon.queue) >= 2
    assert len(mon.toc()) == 10


# -- callbacks ----------------------------------------------------------------
class _Log(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _callback_lines(m, monkeypatch):
    clock = iter(np.arange(0.0, 100.0, 0.5))
    monkeypatch.setattr(m.callback.time, "time", lambda: next(clock))
    log = _Log()
    root = logging.getLogger()
    root.addHandler(log)
    old = root.level
    root.setLevel(logging.INFO)
    try:
        metric = m.metric.Accuracy()
        metric.update([m.nd.array(np.array([0, 1, 1], np.float32),
                                  ctx=m.cpu())],
                      [m.nd.array(np.eye(3, 2, dtype=np.float32),
                                  ctx=m.cpu())])
        cbs = [m.callback.Speedometer(4, frequent=2, auto_reset=False),
               m.callback.log_train_metric(2), m.callback.ProgressBar(4)]
        for nbatch in range(5):
            param = m.mod.BatchEndParam(epoch=1, nbatch=nbatch,
                                        eval_metric=metric, locals={})
            for cb in cbs:
                cb(param)
        m.callback.LogValidationMetricsCallback()(param)
    finally:
        root.removeHandler(log)
        root.setLevel(old)
    return log.lines


def test_callbacks_log_the_reference_lines(monkeypatch, tmp_path):
    assert _callback_lines(mx, monkeypatch) == \
        _callback_lines(tmx, monkeypatch)
    X, y = _toy(20)
    for tag, m in BOTH:
        m.random.seed(0)
        mod = m.mod.Module(_mlp(m), context=m.cpu())
        mod.bind([("data", (20, 8))], [("softmax_label", (20,))])
        mod.init_params(m.init.Xavier())
        mod.init_optimizer()
        arg, aux = mod.get_params()
        m.callback.do_checkpoint(str(tmp_path / ("d" + tag)), 2)(
            1, mod.symbol, arg, aux)
        m.callback.module_checkpoint(mod, str(tmp_path / ("m" + tag)), 1,
                                     save_optimizer_states=True)(0)
    for stem in ("d%s-0002.params", "d%s-symbol.json", "m%s-0001.params",
                 "m%s-0001.states"):
        with open(tmp_path / (stem % "ref"), "rb") as a, \
                open(tmp_path / (stem % "port"), "rb") as b:
            assert a.read() == b.read(), stem


# -- Symbol sugar -------------------------------------------------------------
def _sugar(m):
    a, b = m.sym.Variable("a"), m.sym.Variable("b")
    outs = [a + b, a + 2.0, 3.0 + a, a - b, a - 1.5, 2.0 - a, a * b,
            a * 0.5, 4.0 * a, a / b, a / 4.0, 2.0 / a, a ** 2.0, a ** b,
            -a, a == b, a == 0.25, a != b, a != 0.25, a > b, a > 0.0,
            a >= b, a >= 0.0, a < b, a < 0.0, a <= b, a <= 0.0,
            a.reshape(shape=(3, 4)).sum(axis=1), a.transpose(),
            a.exp().log(), a.square().sqrt()]
    return m.sym.Group(outs)


def test_symbol_sugar_matches_reference(tmp_path):
    rng = np.random.RandomState(0)
    a = (np.abs(rng.randn(4, 3)) + 0.25).astype(np.float32)
    b = (np.abs(rng.randn(4, 3)) + 0.25).astype(np.float32)
    b[0, 0] = a[0, 0]
    a[1, 1] = 0.25
    res = {}
    for tag, m in BOTH:
        with (mx.name.NameManager() if tag == "ref"
              else tmx.name.NameManager()):
            g = _sugar(m)
        g.save(str(tmp_path / ("%s.json" % tag)))
        loaded = m.sym.load(str(tmp_path / ("%s.json" % tag)))
        res[tag] = (g.tojson(), [o.asnumpy() for o in loaded.eval(
            ctx=m.cpu(), a=m.nd.array(a, ctx=m.cpu()),
            b=m.nd.array(b, ctx=m.cpu()))], len(g),
            [s.name for s in g])
    assert res["ref"][0] == res["port"][0]
    assert res["ref"][2:] == res["port"][2:]
    for i, (j, t) in enumerate(zip(res["ref"][1], res["port"][1])):
        _close(j, t, OP_TOL, msg="output %d" % i)


def test_symbol_composition_and_introspection():
    out = {}
    for tag, m in BOTH:
        with (mx.name.NameManager() if tag == "ref"
              else tmx.name.NameManager()):
            x = m.sym.Variable("x")
            inner = m.sym.FullyConnected(m.sym.Variable("data"),
                                         num_hidden=4, name="fc")
            outer = m.sym.Activation(m.sym.Variable("h"), act_type="relu",
                                     name="act")
            composed = outer(h=inner * 2.0)
            composed._set_attr(tag="t1")
            child = composed.get_children()
            shapes = composed.infer_shape_partial(data=(2, 3))
            full = composed.infer_shape(data=(2, 3))
            missing = m.sym.FullyConnected(x, num_hidden=2,
                                           name="f2").infer_shape_partial()
        out[tag] = (composed.tojson(), composed.list_inputs(),
                    child.list_outputs(), composed.attr("tag"),
                    [[None if x is None else tuple(x) for x in s]
                     for s in shapes],
                    full, missing, len(composed), x.attr("nope"))
    assert out["ref"] == out["port"]
    with pytest.raises(NotImplementedError, match="implicit"):
        tmx.sym.Variable("x").grad(["x"])
    with pytest.raises(AttributeError):
        tmx.sym.Variable("x").no_such_op


# -- CustomOp -----------------------------------------------------------------
def _register(m, prefix):
    @m.operator.register(prefix + "sigmoid")
    class _SigmoidProp(m.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return _Sigmoid()

    class _Sigmoid(m.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            y = 1.0 / (1.0 + m.nd.exp(-in_data[0]))
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1.0 - y))

    @m.operator.register(prefix + "addn")
    class _AddNProp(m.operator.CustomOpProp):
        def __init__(self, num_args="2"):
            super().__init__(need_top_grad=True)
            self._num = int(num_args)

        def list_arguments(self):
            return ["arg%d" % i for i in range(self._num)]

        def create_operator(self, ctx, shapes, dtypes):
            return _AddN()

    class _AddN(m.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            acc = in_data[0]
            for a in in_data[1:]:
                acc = acc + a
            self.assign(out_data[0], req[0], acc)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            for g in in_grad:
                self.assign(g, "write", out_grad[0])

    @m.operator.register(prefix + "softmax")
    class _SoftmaxProp(m.operator.CustomOpProp):
        """The classic CustomOp softmax: its backward ignores the head
        gradient and returns softmax - one_hot(label)."""

        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return _Softmax()

    class _Softmax(m.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        m.nd.array(y / y.sum(axis=1, keepdims=True),
                                   ctx=in_data[0].context))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().astype(int)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0],
                        m.nd.array(y, ctx=in_data[0].context))
            self.assign(in_grad[1], "add",
                        m.nd.zeros(lab.shape, ctx=in_data[0].context))


_register(mx, "_apit_")
_register(tmx, "_apit_")


def _custom_case(m, case):
    ctx = m.cpu()
    if case == "sigmoid":
        x = m.nd.array(np.array([0.0, 1.0, -2.0], np.float32), ctx=ctx)
        x.attach_grad()
        with m.autograd.record():
            out = m.nd.Custom(x, op_type="_apit_sigmoid")
            loss = m.nd.sum(out)
        loss.backward()
        return out.asnumpy(), x.grad.asnumpy()
    if case == "addn":
        a = m.nd.array(np.ones(4, np.float32), ctx=ctx)
        b = m.nd.array(np.full(4, 2.0, np.float32), ctx=ctx)
        c = m.nd.array(np.full(4, 3.0, np.float32), ctx=ctx)
        a.attach_grad()
        with m.autograd.record():
            out = m.nd.Custom(a, b, c, op_type="_apit_addn", num_args=3)
            m.nd.sum(out).backward()
        return out.asnumpy(), a.grad.asnumpy()
    if case == "compose":
        x = m.nd.array(np.array([1.0, 2.0], np.float32), ctx=ctx)
        x.attach_grad()
        with m.autograd.record():
            s = m.nd.Custom(x * 3.0, op_type="_apit_sigmoid")
            loss = m.nd.sum(s * s)
        loss.backward()
        return s.asnumpy(), x.grad.asnumpy()
    rng = np.random.RandomState(2)
    x = m.nd.array(rng.randn(5, 4).astype(np.float32), ctx=ctx)
    lab = m.nd.array(rng.randint(0, 4, 5).astype(np.float32), ctx=ctx)
    x.attach_grad()
    with m.autograd.record():
        out = m.nd.Custom(x, lab, op_type="_apit_softmax")
    out.backward()
    plain = m.nd.Custom(x, lab, op_type="_apit_softmax")
    return out.asnumpy(), x.grad.asnumpy(), plain.asnumpy()


@pytest.mark.parametrize("case", ["sigmoid", "addn", "compose", "softmax"])
def test_custom_op_matches_reference(case):
    want, got = _custom_case(mx, case), _custom_case(tmx, case)
    for w, g in zip(want, got):
        _close(w, g, OP_TOL)


def test_custom_op_registry_and_unknown_type():
    assert "_apit_softmax" in tmx.operator.get_all_registered_operators()
    with pytest.raises(tmx.MXNetError):
        tmx.nd.Custom(tmx.nd.ones((2,), ctx="cpu"), op_type="_no_such_op")
    with pytest.raises(tmx.MXNetError):
        tmx.nd.Custom(tmx.nd.ones((2,), ctx="cpu"),
                      op_type="_apit_addn", num_args=3)
