"""The Gluon imperative training path of mxnet_tpu_torch held against
mxnet_tpu's: ``autograd.record()`` -> ``loss.backward()`` ->
``gluon.Trainer.step``.

Each network is built in both packages; the reference's seeded Xavier
parameters are carried into the port (``from_jax_params``), and the same
seeded batches go through both.

- Every ported layer and loss, called on NDArrays inside ``record()``:
  the output and the gradients of the input and of every parameter,
  1e-5 (f32; only reduction orders differ).
- Training (an MLP, and hybridized, a small conv net and a narrow
  thumbnail ResNet v1 at 32 x 32; batch 4): 3 SGD+momentum and 3 Adam
  steps, on both ``update_on_kvstore`` routes — losses within 2e-5,
  parameters and moving statistics within 5e-6 of the reference's (the
  LM training row's tolerances).  The port's kvstore route is held to
  the reference's local route, and is bitwise the port's local route:
  the reference's kvstore route runs a stale copy of the optimizer,
  which the port does not keep (shown here; ROADMAP.md section C).
- bf16 with ``multi_precision=True`` (the MLP): the port's bf16 run is
  held to twice the reference's own bf16-vs-f32 distance, the rule of
  the bf16 replicated trainer row.
- A hybridized network gives the same gradients as the eager one, and
  ``jit_cache_keys()`` one key per (shapes, training flag).
- ``Dropout`` by its mask's statistics, the identity in predict mode and
  reruns from one seed.
- ``save_parameters`` / ``load_parameters`` in both formats.

The same loop on the card: ``tests/test_torch_gluon_cuda.py``.
"""
import pickle
import tempfile

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.utils import from_jax_params, relative_names

TOL = 1e-5
LOSS_TOL, PARAM_TOL = 2e-5, 5e-6
BATCH, STEPS = 4, 3


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _close(want, got, tol=TOL, msg=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


def _params(block):
    """{name relative to the block prefix: numpy value}."""
    ps = block.collect_params()
    rel = relative_names(list(ps.keys()), block.prefix)
    return {r: ps[n].data().asnumpy() for r, n in rel.items()}


def _carry(jblock, tblock, x):
    """Resolve the reference's shapes, draw Xavier weights from a seed and
    load them into the port's block; returns the arrays."""
    np.random.seed(0)
    jblock.initialize(mx.init.Xavier())
    jblock(mx.nd.array(x))
    arrays = {n: p.data().asnumpy()
              for n, p in jblock.collect_params().items()}
    from_jax_params(tblock, arrays, device="cpu")
    return arrays


# -- layers and losses -------------------------------------------------------
def _layer(pkg, name):
    nn = pkg.nn
    return {
        "leaky": lambda: nn.LeakyReLU(0.1),
        "prelu": lambda: nn.PReLU(alpha_initializer=mx.init.Constant(0.2))
        if pkg is jgluon else nn.PReLU(),
        "elu": lambda: nn.ELU(0.7),
        "selu": lambda: nn.SELU(),
        "swish": lambda: nn.Swish(1.5),
        "gelu": lambda: nn.GELU(),
        "instancenorm": lambda: nn.InstanceNorm(in_channels=3),
        "layernorm": lambda: nn.LayerNorm(in_channels=5),
        "layernorm_axis1": lambda: nn.LayerNorm(axis=1, in_channels=3),
        "embedding": lambda: nn.Embedding(7, 4),
        "dense": lambda: nn.Dense(6, activation="tanh"),
        "batchnorm": lambda: nn.BatchNorm(in_channels=3),
        "conv": lambda: nn.Conv2D(4, 3, padding=1, in_channels=3),
        "hybridlambda": lambda: nn.HybridLambda("tanh"),
    }[name]()


LAYERS = ["leaky", "prelu", "elu", "selu", "swish", "gelu", "instancenorm",
          "layernorm", "layernorm_axis1", "embedding", "dense", "batchnorm",
          "conv", "hybridlambda"]


@pytest.mark.parametrize("name", LAYERS)
def test_layer_on_ndarrays_matches_reference(name):
    rng = np.random.RandomState(1)
    shape = {"layernorm": (2, 3, 5), "embedding": (2, 3)}.get(
        name, (2, 3, 4, 4))
    x = rng.randint(0, 7, shape).astype(np.float32) if name == "embedding" \
        else rng.randn(*shape).astype(np.float32)
    jb, tb = _layer(jgluon, name), _layer(gluon, name)
    _carry(jb, tb, x)
    jx, tx = mx.nd.array(x), nd.array(x)
    jx.attach_grad()
    tx.attach_grad()
    head = rng.randn(*jb(jx).shape).astype(np.float32)   # predict mode
    with mx.autograd.record():
        jy = jb(jx)
        jl = (jy * mx.nd.array(head)).sum()
    with autograd.record():
        ty = tb(tx)
        tl = (ty * nd.array(head)).sum()
    assert isinstance(ty, nd.NDArray)
    jl.backward()
    tl.backward()
    _close(jy.asnumpy(), ty.asnumpy())
    if name != "embedding":
        _close(jx.grad.asnumpy(), tx.grad.asnumpy())
    jp, tp = jb.collect_params(), tb.collect_params()
    for (jn, pj), (tn, pt) in zip(jp.items(), tp.items()):
        if pj.grad_req != "null":
            _close(pj.grad().asnumpy(), pt.grad().asnumpy(), msg=tn)
        else:
            _close(pj.data().asnumpy(), pt.data().asnumpy(), msg=tn)


def test_concurrent_and_lambda_blocks_match_reference():
    x = np.random.RandomState(2).randn(2, 3).astype(np.float32)

    def build(pkg):
        c = pkg.nn.HybridConcurrent(axis=1)
        with c.name_scope():
            c.add(pkg.nn.Dense(4))
            c.add(pkg.nn.HybridLambda(lambda F, v: F.relu(v)))
        return c

    jc, tc = build(jgluon), build(gluon)
    _carry(jc, tc, x)
    _close(jc(mx.nd.array(x)).asnumpy(), tc(nd.array(x)).asnumpy())
    jl, tl = jgluon.nn.Lambda("exp"), gluon.nn.Lambda("exp")
    _close(jl(mx.nd.array(x)).asnumpy(), tl(nd.array(x)).asnumpy())


def _loss(pkg, name):
    L = pkg.loss
    return {
        "l2": lambda: L.L2Loss(), "l1": lambda: L.L1Loss(weight=0.5),
        "sigmoid_bce": lambda: L.SigmoidBinaryCrossEntropyLoss(),
        "sigmoid_bce_prob": lambda: L.SigmoidBCELoss(from_sigmoid=True),
        "softmax_ce": lambda: L.SoftmaxCrossEntropyLoss(),
        "softmax_ce_dense": lambda: L.SoftmaxCELoss(sparse_label=False),
        "kl": lambda: L.KLDivLoss(from_logits=False),
        "huber": lambda: L.HuberLoss(rho=0.5),
        "hinge": lambda: L.HingeLoss(),
        "squared_hinge": lambda: L.SquaredHingeLoss(margin=2),
        "logistic": lambda: L.LogisticLoss(),
        "logistic_binary": lambda: L.LogisticLoss(label_format="binary"),
        "triplet": lambda: L.TripletLoss(margin=0.5),
    }[name]()


LOSSES = ["l2", "l1", "sigmoid_bce", "sigmoid_bce_prob", "softmax_ce",
          "softmax_ce_dense", "kl", "huber", "hinge", "squared_hinge",
          "logistic", "logistic_binary", "triplet"]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", LOSSES)
def test_loss_matches_reference(name, weighted):
    rng = np.random.RandomState(3)
    pred = rng.randn(4, 5).astype(np.float32)
    if name == "sigmoid_bce_prob":
        pred = 1 / (1 + np.exp(-pred))
    if name == "softmax_ce":
        label = rng.randint(0, 5, 4).astype(np.float32)
    elif name in ("hinge", "squared_hinge", "logistic"):
        label = np.sign(rng.randn(4, 5)).astype(np.float32)
    elif name in ("softmax_ce_dense", "kl"):
        label = rng.dirichlet(np.ones(5), 4).astype(np.float32)
    else:
        label = rng.rand(4, 5).astype(np.float32)
    extra = [rng.randn(4, 5).astype(np.float32)] if name == "triplet" else []
    sw = rng.rand(4, 1).astype(np.float32) if weighted else None
    jl, tl = _loss(jgluon, name), _loss(gluon, name)
    outs = []
    for pkg, loss in ((mx.nd, jl), (nd, tl)):
        p = pkg.array(pred)
        p.attach_grad()
        args = [p, pkg.array(label)] + [pkg.array(e) for e in extra]
        kw = {} if sw is None else {"sample_weight": pkg.array(sw)}
        ag = mx.autograd if pkg is mx.nd else autograd
        with ag.record():
            out = loss(*args, **kw)
        out.backward()
        outs.append((out.asnumpy(), p.grad.asnumpy()))
    (jo, jg), (to, tg) = outs
    _close(jo, to)
    _close(jg, tg)


def test_ctc_loss_names_its_roadmap_item():
    """CTC, ROADMAP.md A10(a), is ported: ``CTCLoss`` computes the
    reference's losses (``tests/test_torch_ctc.py`` holds the rest)."""
    rng = np.random.RandomState(0)
    pred = rng.randn(2, 6, 5).astype(np.float32)
    label = np.array([[1, 2, -1], [3, 3, 0]], np.float32)
    want = mx.gluon.loss.CTCLoss()(mx.nd.array(pred), mx.nd.array(label))
    got = gluon.loss.CTCLoss()(nd.array(pred), nd.array(label))
    _close(want.asnumpy(), got.asnumpy())


# -- training ----------------------------------------------------------------
def _mlp(pkg):
    net = pkg.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.nn.Dense(16, activation="relu"),
                pkg.nn.Dense(8, activation="tanh"), pkg.nn.Dense(5))
    return net


def _convnet(pkg):
    net = pkg.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.nn.Conv2D(8, 3, padding=1), pkg.nn.BatchNorm(),
                pkg.nn.Activation("relu"), pkg.nn.MaxPool2D(),
                pkg.nn.Conv2D(16, 3), pkg.nn.GlobalAvgPool2D(),
                pkg.nn.Flatten(), pkg.nn.Dense(5))
    return net


def _resnet(pkg):
    v = jvision if pkg is jgluon else vision
    return v.ResNetV1(v.BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                      classes=5, thumbnail=True)


NETS = {"mlp": (_mlp, (BATCH, 12)), "convnet": (_convnet, (BATCH, 3, 8, 8)),
        "resnet": (_resnet, (BATCH, 3, 32, 32))}
# Adam divides by the gradient's running RMS, so a parameter whose exact
# gradient is zero (a convolution's bias ahead of BatchNorm) moves by lr
# per step on rounding noise alone, differently in each package;
# epsilon 1e-4 sits above that noise (~1e-8) and far below the real
# gradients' RMS (~1e-2)
OPTS = {"sgd": {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
        "adam": {"learning_rate": 1e-3, "wd": 1e-4, "epsilon": 1e-4}}


def _batches(shape, seed=5):
    rng = np.random.RandomState(seed)
    return [(rng.rand(*shape).astype(np.float32),
             rng.randint(0, 5, shape[0]).astype(np.float32))
            for _ in range(STEPS)]


def _step(pkg, net, tr, loss_fn, x, y, dtype=None):
    """One step of the canonical loop; the batch's mean loss."""
    ag = mx.autograd if pkg is jgluon else autograd
    arr = mx.nd.array if pkg is jgluon else nd.array
    data = arr(x) if dtype is None else arr(x, dtype=dtype)
    with ag.record():
        out = net(data)
        if dtype is not None:
            out = out.astype("float32")
        L = loss_fn(out, arr(y))
    L.backward()
    tr.step(x.shape[0])
    return float(L.mean().asscalar())


def _train(pkg, net, opt, kvstore_route, batches, dtype=None, **extra):
    """STEPS of the canonical loop; (losses, Trainer).  ``extra`` goes
    into the optimizer's parameters."""
    params = dict(OPTS[opt], multi_precision=dtype is not None, **extra)
    tr = pkg.Trainer(net.collect_params(), opt, params, kvstore="device",
                     update_on_kvstore=kvstore_route)
    loss_fn = pkg.loss.SoftmaxCrossEntropyLoss()
    return [_step(pkg, net, tr, loss_fn, x, y, dtype)
            for x, y in batches], tr


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("which", list(NETS))
def test_trainer_matches_reference(which, opt):
    make, shape = NETS[which]
    batches = _batches(shape)
    jnet, tnet = make(jgluon), make(gluon)
    arrays = _carry(jnet, tnet, batches[0][0])
    if which != "mlp":
        # the reference's one cached node per forward (and a third of its
        # eager time on the CPU); the port runs eagerly either way
        jnet.hybridize()
        tnet.hybridize()
    jl, _ = _train(jgluon, jnet, opt, False, batches)
    tl, _ = _train(gluon, tnet, opt, False, batches)
    _close(jl, tl, tol=LOSS_TOL)
    want, got = _params(jnet), _params(tnet)
    assert sorted(want) == sorted(got)
    for rel in want:
        _close(want[rel], got[rel], tol=PARAM_TOL, msg=rel)
    # the port's kvstore route against the reference's local route (the
    # reference's own kvstore route updates with a stale rescale_grad:
    # see the next test), and bitwise the port's local route
    knet = from_jax_params(make(gluon), arrays, device="cpu")
    kl, ktr = _train(gluon, knet, opt, True, batches)
    assert ktr._update_on_kvstore and ktr._kvstore.has_updater
    _close(jl, kl, tol=LOSS_TOL)
    assert kl == tl
    for rel, v in _params(knet).items():
        _close(want[rel], v, tol=PARAM_TOL, msg=rel)
        np.testing.assert_array_equal(v, got[rel], err_msg=rel)


def test_reference_kvstore_route_runs_a_stale_optimizer_copy():
    """A fault of mxnet_tpu, which the port does not keep (ROADMAP.md
    section C): its store pickles a copy of the optimizer in
    ``_init_kvstore``, before ``step`` first sets ``rescale_grad``
    (mxnet_tpu/kvstore.py:301, mxnet_tpu/gluon/trainer.py:84).  So its
    kvstore route updates with rescale_grad 1, as its local route does
    at ``step(1)``; ``set_learning_rate`` never reaches the copy; and
    ``save_states`` writes the trainer's updater, which is empty.  The
    port's store runs the trainer's own optimizer, as MXNet's local
    store does: its kvstore route is held to the reference's local
    route, after ``set_learning_rate`` too, and its states file holds
    the reference's local states (5e-6)."""
    make, shape = NETS["mlp"]
    batches = _batches(shape, seed=8)
    nets = [make(jgluon) for _ in range(3)]
    knet = make(gluon)
    _carry(nets[0], knet, batches[0][0])
    for net in nets[1:]:
        _carry(net, make(gluon), batches[0][0])
    jk, jl, j1 = nets
    _, jtr_k = _train(jgluon, jk, "sgd", True, batches)
    _, jtr_l = _train(jgluon, jl, "sgd", False, batches)
    _train(jgluon, j1, "sgd", False, batches, rescale_grad=BATCH)
    copy = jtr_k._kvstore._updater.optimizer
    assert jtr_k._optimizer.rescale_grad == 1.0 / BATCH
    assert copy is not jtr_k._optimizer and copy.rescale_grad == 1.0
    stale, local, one = _params(jk), _params(jl), _params(j1)
    for rel in stale:
        _close(one[rel], stale[rel], tol=PARAM_TOL, msg=rel)
    assert max(np.abs(stale[r] - local[r]).max() for r in stale) \
        > 100 * PARAM_TOL
    jtr_k.set_learning_rate(0.01)
    assert copy.lr == OPTS["sgd"]["learning_rate"]
    # the port's kvstore route
    _, ktr = _train(gluon, knet, "sgd", True, batches)
    x, y = batches[0]
    jtr_l.set_learning_rate(0.01)
    ktr.set_learning_rate(0.01)
    _close(_step(jgluon, jl, jtr_l, jgluon.loss.SoftmaxCrossEntropyLoss(),
                 x, y),
           _step(gluon, knet, ktr, gluon.loss.SoftmaxCrossEntropyLoss(), x, y),
           tol=LOSS_TOL)
    local, port = _params(jl), _params(knet)
    for rel in local:
        _close(local[rel], port[rel], tol=PARAM_TOL, msg=rel)
    states = []
    with tempfile.TemporaryDirectory() as d:
        for tr in (jtr_k, jtr_l, ktr):
            tr.save_states(d + "/s")
            with open(d + "/s", "rb") as f:
                states.append(pickle.load(f))
    empty, want, got = states
    assert empty == {}
    assert sorted(got) == sorted(want) == list(range(6))
    for i, v in want.items():
        _close(v, got[i], tol=PARAM_TOL, msg=str(i))


def test_trainer_surface():
    net = _mlp(gluon)
    net.initialize(ctx="cpu", rng=np.random.RandomState(0))
    net(nd.zeros((1, 12)))
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.5})
    assert tr.learning_rate == 0.5
    tr.set_learning_rate(0.25)
    assert tr.learning_rate == 0.25
    x = nd.array(np.ones((2, 12), np.float32))
    with autograd.record():
        L = net(x).sum()
    L.backward()
    before = net.collect_params()[net.prefix + "dense2_bias"].data()\
        .asnumpy()
    tr.allreduce_grads()
    tr.update(2)
    after = net.collect_params()[net.prefix + "dense2_bias"].data()\
        .asnumpy()
    # d(sum)/d(bias) = batch = 2, rescaled by 1/2: a step of lr
    _close(before - 0.25, after)
    with pytest.raises(ValueError):
        gluon.Trainer([], "sgd")
    with pytest.raises(ValueError):
        gluon.Trainer(net.collect_params(), tr._optimizer,
                      {"learning_rate": 1.0})


def test_bf16_multi_precision_training_holds_the_bf16_rule():
    """|port_bf16 - ref_bf16| <= 2 * |ref_bf16 - ref_f32| per parameter
    (max over elements), after 3 SGD+momentum steps."""
    make, shape = NETS["mlp"]
    batches = _batches(shape, seed=6)
    jf, j16 = make(jgluon), make(jgluon)
    t16 = make(gluon)
    arrays = _carry(jf, t16, batches[0][0])
    _carry(j16, make(gluon), batches[0][0])
    _train(jgluon, jf, "sgd", False, batches)
    j16.cast("bfloat16")
    t16.cast("bfloat16")
    _train(jgluon, j16, "sgd", False, batches, dtype="bfloat16")
    tl, _ = _train(gluon, t16, "sgd", False, batches, dtype="bfloat16")
    assert np.isfinite(tl).all()
    f32 = _params(jf)
    ref = {k: np.asarray(v, np.float32) for k, v in _params(j16).items()}
    got = _params(t16)
    assert all(t16.collect_params()[n].tensor().dtype == torch.bfloat16
               for n in t16.collect_params().keys())
    for rel in f32:
        allowed = 2 * np.abs(ref[rel] - f32[rel]).max()
        assert np.abs(got[rel] - ref[rel]).max() <= allowed, rel


def test_hybridized_net_matches_eager_and_keeps_cache_keys():
    make, shape = NETS["convnet"]
    batches = _batches(shape, seed=7)
    eager, hyb = make(gluon), make(gluon)
    arrays = _carry(make(jgluon), eager, batches[0][0])
    from_jax_params(hyb, arrays, device="cpu")
    hyb.hybridize()
    le, _ = _train(gluon, eager, "sgd", False, batches)
    lh, _ = _train(gluon, hyb, "sgd", False, batches)
    assert le == lh
    for rel, v in _params(eager).items():
        np.testing.assert_array_equal(v, _params(hyb)[rel], err_msg=rel)
    keys = hyb.jit_cache_keys()
    assert len(keys) == 1 and next(iter(keys))[1][1] is True
    with autograd.predict_mode():
        hyb(nd.array(batches[0][0]))
    assert len(hyb.jit_cache_keys()) == 2


def test_dropout_statistics_predict_identity_and_reruns():
    x = nd.ones((200, 500))
    gen = torch.Generator().manual_seed(11)
    drop = gluon.nn.Dropout(0.3, generator=gen)
    with autograd.predict_mode():
        np.testing.assert_array_equal(drop(x).asnumpy(), x.asnumpy())
    with autograd.record():
        y = drop(x).asnumpy()
    kept = y != 0
    assert abs(kept.mean() - 0.7) < 0.01
    np.testing.assert_allclose(y[kept], 1 / 0.7, rtol=1e-6)
    gen.manual_seed(11)
    with autograd.train_mode():
        np.testing.assert_array_equal(drop(x).asnumpy(), y)
    shared = gluon.nn.Dropout(0.5, axes=(1,), generator=gen)
    with autograd.train_mode():
        z = shared(x).asnumpy()
    assert (z == z[:, :1]).all()


@pytest.mark.parametrize("fmt", ["mxtpu", "mxnet"])
def test_save_load_parameters_round_trip_and_match_reference(fmt):
    make, shape = NETS["resnet"]
    x = _batches(shape)[0][0]
    jnet, tnet = make(jgluon), make(gluon)
    _carry(jnet, tnet, x)
    with tempfile.TemporaryDirectory() as d:
        jf, tf = d + "/ref.params", d + "/port.params"
        jnet.save_parameters(jf, format=fmt)
        tnet.save_parameters(tf, format=fmt)
        with open(jf, "rb") as a, open(tf, "rb") as b:
            assert a.read() == b.read()
        fresh = make(gluon)
        fresh.load_parameters(jf, ctx="cpu")
        with autograd.predict_mode():
            np.testing.assert_array_equal(
                fresh(nd.array(x)).asnumpy(), tnet(nd.array(x)).asnumpy())
        back = make(jgluon)
        back.load_parameters(tf)
        for rel, v in _params(back).items():
            np.testing.assert_array_equal(v, _params(tnet)[rel])
        part = gluon.nn.Dense(5)
        with pytest.raises(IOError):
            part.load_parameters(tf, ctx="cpu")
        part.load_parameters(tf, ctx="cpu", ignore_extra=True,
                             allow_missing=True)
