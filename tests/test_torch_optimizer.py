"""Every optimizer of mxnet_tpu_torch held against mxnet_tpu's, on the CPU.

- One ``Updater`` per package over the same seeded weights and
  gradients, three updates of two indices: weights and states within
  1e-6, plain, with ``wd`` / ``clip_gradient`` / ``rescale_grad``, under
  an lr scheduler and with ``multi_precision`` on float16 weights.
- Five ``gluon.Trainer`` steps of an MLP from the reference's weights:
  losses within 2e-5, parameters within 5e-6 (the Gluon training row's
  limits).
- ``DataParallelTrainer`` against the reference's ``DataParallelTrainer``
  for the elementwise optimizers, except Nadam, held against the
  reference's Gluon route: the reference's step bakes one step's
  ``m_schedule`` into its compiled update and leaves the Gluon route at
  step 3 (shown here; ROADMAP.md C3).  LBSGD and DCASGD raise.
- SGLD by law: an update minus its deterministic part is N(0, lr)
  (Kolmogorov-Smirnov, p > 0.001), in the updater, the Gluon trainer and
  ``DataParallelTrainer``, whose SGLD run is bitwise equal at run-ahead
  depth 1 and 4.
- Trainer states cross both ways (1e-6 after the next step), and every
  update op of ``ops/optimizer_ops.py`` matches the reference's op.
"""
import pickle
import tempfile

import numpy as np
import pytest
import scipy.stats
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.parallel import DataParallelTrainer as JaxTrainer
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, engine, gluon, lr_scheduler, nd
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.gluon.utils import from_jax_params, relative_names
from mxnet_tpu_torch.ops import fused_optimizer
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.parallel import DataParallelTrainer

TOL = 1e-6
LOSS_TOL, PARAM_TOL = 2e-5, 5e-6
STEPS = 5

# label -> (registered name, optimizer parameters)
OPTS = {
    "sgd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    "nag": ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    "signum": ("signum", {"learning_rate": 0.01, "momentum": 0.9,
                          "wd_lh": 1e-3}),
    "signsgd": ("signum", {"learning_rate": 0.01, "momentum": 0.0}),
    "ftml": ("ftml", {"learning_rate": 0.05}),
    "lbsgd": ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9}),
    "dcasgd": ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9}),
    "dcasgd_nomom": ("dcasgd", {"learning_rate": 0.1}),
    "adam": ("adam", {"learning_rate": 0.01}),
    "adagrad": ("adagrad", {"learning_rate": 0.1}),
    "rmsprop": ("rmsprop", {"learning_rate": 0.01}),
    "rmsprop_centered": ("rmsprop", {"learning_rate": 0.01,
                                     "centered": True, "clip_weights": 2.0}),
    "adadelta": ("adadelta", {}),
    "ftrl": ("ftrl", {"learning_rate": 0.1}),
    "adamax": ("adamax", {}),
    "nadam": ("nadam", {"learning_rate": 0.01}),
    "test": ("test", {"learning_rate": 0.1}),
}
VARIANTS = {
    "plain": {},
    "wd_clip_rescale": {"wd": 1e-3, "clip_gradient": 0.5,
                        "rescale_grad": 0.5},
    "scheduler": "scheduler",
    "mp_float16": {"multi_precision": True},
}
# the reference's elementwise set (its DataParallelTrainer groups these)
ELEMENTWISE = ["sgd", "nag", "signum", "ftml", "adam", "adagrad", "rmsprop",
               "rmsprop_centered", "adadelta", "ftrl", "adamax"]


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _make(pkg_opt, label, variant, sched_mod):
    name, params = OPTS[label]
    params = dict(params)
    extra = VARIANTS[variant]
    if extra == "scheduler":
        params["lr_scheduler"] = sched_mod.FactorScheduler(step=1,
                                                           factor=0.8)
    else:
        params.update(extra)
    return pkg_opt.create(name, **params)


def _host(s):
    if s is None:
        return []
    if isinstance(s, tuple):
        return [v for x in s for v in _host(x)]
    return [s.asnumpy() if hasattr(s, "asnumpy") else
            s.detach().float().numpy()]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("label", list(OPTS))
def test_updater_matches_reference(label, variant):
    dtype = "float16" if variant == "mp_float16" else "float32"
    rng = np.random.RandomState(7)
    w0 = [rng.randn(5, 4).astype(np.float32), rng.randn(7).astype(np.float32)]
    grads = [[rng.randn(*w.shape).astype(np.float32) for w in w0]
             for _ in range(3)]
    jup = jopt.get_updater(_make(jopt, label, variant, jmx.lr_scheduler))
    tup = topt.get_updater(_make(topt, label, variant, lr_scheduler))
    jw = [jmx.nd.array(w, dtype=dtype) for w in w0]
    tw = [torch.from_numpy(w).to(getattr(torch, dtype)) for w in w0]
    for gs in grads:
        for i, g in enumerate(gs):
            jup(i, jmx.nd.array(g, dtype=dtype), jw[i])
            tup(i, torch.from_numpy(g).to(getattr(torch, dtype)), tw[i])
    for i in range(2):
        np.testing.assert_allclose(tw[i].float().numpy(),
                                   jw[i].asnumpy().astype(np.float32),
                                   rtol=TOL, atol=TOL, err_msg=str(i))
        want, got = _host(jup.states[i]), _host(tup.states[i])
        assert len(want) == len(got)
        for a, b in zip(want, got):
            np.testing.assert_allclose(b, a.astype(np.float32), rtol=TOL,
                                       atol=TOL)


def _sgld_residual(w0, g, lr, wd, rescale, w1):
    return (w1 - (w0 - lr / 2 * (g * rescale + wd * w0))) / np.sqrt(lr)


def _normal_law(r):
    r = np.asarray(r, np.float64).ravel()
    assert scipy.stats.kstest(r, "norm").pvalue > 0.001
    assert abs(r.mean()) < 6 / np.sqrt(r.size)


def test_sgld_update_is_normal_around_its_deterministic_part():
    rng = np.random.RandomState(3)
    w0 = rng.randn(100_000).astype(np.float32)
    g = rng.randn(100_000).astype(np.float32)
    lr, wd, rescale = 0.01, 1e-3, 0.5
    mx.random.seed(8)
    opt = topt.create("sgld", learning_rate=lr, wd=wd, rescale_grad=rescale)
    w = torch.from_numpy(w0.copy())
    topt.get_updater(opt)(0, torch.from_numpy(g), w)
    _normal_law(_sgld_residual(w0, g, lr, wd, rescale, w.numpy()))
    jw = jmx.nd.array(w0)
    jopt.get_updater(jopt.create("sgld", learning_rate=lr, wd=wd,
                                 rescale_grad=rescale))(0, jmx.nd.array(g),
                                                        jw)
    _normal_law(_sgld_residual(w0, g, lr, wd, rescale, jw.asnumpy()))


def test_fused_kernels_take_exact_sgd_and_adam_only():
    for name, want in [("sgd", "sgd"), ("adam", "adam"), ("nag", None),
                       ("lbsgd", None), ("signum", None), ("sgld", None)]:
        assert fused_optimizer.supports(topt.create(name)) == want


def test_every_optimizer_is_registered_and_none_unported():
    names = {"sgd", "signum", "ftml", "lbsgd", "dcasgd", "nag", "sgld",
             "adam", "adagrad", "rmsprop", "adadelta", "ftrl", "adamax",
             "nadam", "test"}
    assert set(topt._REG) == names
    assert not hasattr(topt, "_UNPORTED")
    for n in names:
        assert type(topt.create(n)).__name__.lower() == n


# -- the Gluon trainer --------------------------------------------------------
def _mlp(pkg):
    net = pkg.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.nn.Dense(16, activation="relu"),
                pkg.nn.Dense(8, activation="tanh"), pkg.nn.Dense(5))
    return net


def _batches(n=STEPS, seed=5, batch=4):
    rng = np.random.RandomState(seed)
    return [(rng.rand(batch, 12).astype(np.float32),
             rng.randint(0, 5, batch).astype(np.float32)) for _ in range(n)]


# the reference's trainer splits a batch over the test mesh's 8 devices
DPT_BATCH = 8


def _pair(x):
    """(reference MLP, port MLP) with the reference's Xavier weights."""
    jnet, tnet = _mlp(jgluon), _mlp(gluon)
    np.random.seed(0)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    arrays = {n: p.data().asnumpy()
              for n, p in jnet.collect_params().items()}
    from_jax_params(tnet, arrays, device="cpu")
    return jnet, tnet, arrays


def _params(block):
    ps = block.collect_params()
    rel = relative_names(list(ps.keys()), block.prefix)
    return {r: ps[n].data().asnumpy() for r, n in rel.items()}


def _gluon_steps(pkg, net, tr, batches):
    ag = jmx.autograd if pkg is jgluon else autograd
    arr = jmx.nd.array if pkg is jgluon else nd.array
    loss_fn = pkg.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for x, y in batches:
        with ag.record():
            L = loss_fn(net(arr(x)), arr(y))
        L.backward()
        tr.step(x.shape[0])
        losses.append(float(L.mean().asscalar()))
    return losses


def _close_nets(want, got, tol=PARAM_TOL):
    assert sorted(want) == sorted(got)
    for rel in want:
        np.testing.assert_allclose(got[rel], want[rel], rtol=tol, atol=tol,
                                   err_msg=rel)


GLUON = [k for k in OPTS if k != "signsgd"]


@pytest.mark.parametrize("label", GLUON)
def test_gluon_trainer_matches_reference(label):
    name, params = OPTS[label]
    batches = _batches()
    jnet, tnet, _ = _pair(batches[0][0])
    jtr = jgluon.Trainer(jnet.collect_params(), name, dict(params))
    ttr = gluon.Trainer(tnet.collect_params(), name, dict(params))
    jl = _gluon_steps(jgluon, jnet, jtr, batches)
    tl = _gluon_steps(gluon, tnet, ttr, batches)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL, atol=LOSS_TOL)
    _close_nets(_params(jnet), _params(tnet))


def test_gluon_sgld_moves_by_its_law():
    batches = _batches(1)
    _, tnet, _ = _pair(batches[0][0])
    before = _params(tnet)
    lr = 0.04
    mx.random.seed(13)
    tr = gluon.Trainer(tnet.collect_params(), "sgld", {"learning_rate": lr})
    x, y = batches[0]
    with autograd.record():
        L = gluon.loss.SoftmaxCrossEntropyLoss()(tnet(nd.array(x)),
                                                 nd.array(y))
    L.backward()
    grads = {r: tnet.collect_params()[n].grad().asnumpy() for r, n in
             relative_names(list(tnet.collect_params().keys()),
                            tnet.prefix).items()}
    tr.step(4)
    after = _params(tnet)
    r = np.concatenate([_sgld_residual(before[k], grads[k], lr, 0.0, 0.25,
                                       after[k]).ravel() for k in before])
    _normal_law(r)


@pytest.mark.parametrize("label", ["sgd", "nag", "ftml", "adam", "rmsprop",
                                   "adadelta", "nadam", "dcasgd"])
def test_trainer_states_cross_both_ways(label):
    name, params = OPTS[label]
    batches = _batches(3)
    for src, dst in ((jgluon, gluon), (gluon, jgluon)):
        jnet, tnet, _ = _pair(batches[0][0])
        nets = {jgluon: jnet, gluon: tnet}
        trs = {p: p.Trainer(nets[p].collect_params(), name, dict(params))
               for p in (jgluon, gluon)}
        _gluon_steps(src, nets[src], trs[src], batches[:2])
        with tempfile.NamedTemporaryFile(suffix=".states") as f:
            trs[src].save_states(f.name)
            # the destination starts from the source's weights
            arrays = {n: p.data().asnumpy()
                      for n, p in nets[src].collect_params().items()}
            for n, p in nets[dst].collect_params().items():
                p.set_data((jmx.nd if dst is jgluon else nd).array(
                    arrays[n]))
            trs[dst].load_states(f.name)
        new_src = src.Trainer(nets[src].collect_params(), name, dict(params))
        with tempfile.NamedTemporaryFile(suffix=".states") as f:
            trs[src].save_states(f.name)
            new_src.load_states(f.name)
        _gluon_steps(src, nets[src], new_src, batches[2:])
        _gluon_steps(dst, nets[dst], trs[dst], batches[2:])
        _close_nets(_params(nets[src]), _params(nets[dst]), tol=TOL)


# -- DataParallelTrainer ------------------------------------------------------
def _dpt_losses(trainer, batches):
    out = [float(trainer.step(x, y)) for x, y in batches]
    trainer.flush()
    return out


@pytest.mark.parametrize("label", ELEMENTWISE)
def test_data_parallel_trainer_matches_reference(label):
    name, params = OPTS[label]
    batches = _batches(3, batch=DPT_BATCH)
    jnet, tnet, _ = _pair(batches[0][0])
    loss = jgluon.loss.SoftmaxCrossEntropyLoss()
    jl = _dpt_losses(JaxTrainer(jnet, loss, name, dict(params)),
                     [(jmx.nd.array(x), jmx.nd.array(y))
                      for x, y in batches])
    tl = _dpt_losses(DataParallelTrainer(
        tnet, gluon.loss.SoftmaxCrossEntropyLoss(), name, dict(params),
        device="cpu"), batches)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL, atol=LOSS_TOL)
    _close_nets(_params(jnet), _params(tnet))


def test_nadam_reference_mesh_route_leaves_its_gluon_route_the_port_holds():
    """ROADMAP.md C3: the reference's DataParallelTrainer pins lr and the
    update count of its traced update but not Nadam's ``m_schedule``, so
    its compiled step keeps one step's schedule; its losses leave its own
    Gluon route's at step 3.  The port's trainer holds the Gluon route."""
    name, params = OPTS["nadam"]
    batches = _batches(4, batch=DPT_BATCH)
    jnet, tnet, arrays = _pair(batches[0][0])
    gluon_ref = _gluon_steps(jgluon, jnet, jgluon.Trainer(
        jnet.collect_params(), name, dict(params)), batches)
    want = _params(jnet)
    mnet = _mlp(jgluon)
    mnet.initialize()
    mnet(jmx.nd.array(batches[0][0]))
    for p, v in zip(mnet.collect_params().values(), arrays.values()):
        p.set_data(jmx.nd.array(v))
    mesh_ref = _dpt_losses(JaxTrainer(
        mnet, jgluon.loss.SoftmaxCrossEntropyLoss(), name, dict(params)),
        [(jmx.nd.array(x), jmx.nd.array(y)) for x, y in batches])
    np.testing.assert_allclose(mesh_ref[:2], gluon_ref[:2], rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert abs(mesh_ref[2] - gluon_ref[2]) > 10 * LOSS_TOL
    got = _dpt_losses(DataParallelTrainer(
        tnet, gluon.loss.SoftmaxCrossEntropyLoss(), name, dict(params),
        device="cpu"), batches)
    np.testing.assert_allclose(got, gluon_ref, rtol=LOSS_TOL, atol=LOSS_TOL)
    _close_nets(want, _params(tnet))


@pytest.mark.parametrize("label", ["lbsgd", "dcasgd"])
def test_data_parallel_trainer_refuses_per_parameter_optimizers(label):
    name, params = OPTS[label]
    with pytest.raises(ValueError, match="elementwise"):
        DataParallelTrainer(_mlp(gluon), gluon.loss.SoftmaxCrossEntropyLoss(),
                            name, dict(params), device="cpu")


def _sgld_dpt(depth, seed=31):
    batches = _batches(4)
    _, tnet, _ = _pair(batches[0][0])
    mx.random.seed(seed)
    tr = DataParallelTrainer(tnet, gluon.loss.SoftmaxCrossEntropyLoss(),
                             "sgld", {"learning_rate": 0.01}, device="cpu")
    with engine.bulk(depth):
        losses = [tr.step(x, y) for x, y in batches]
    return [float(v) for v in losses], _params(tnet)


def test_data_parallel_sgld_repeats_at_depth_1_and_4():
    l1, p1 = _sgld_dpt(1)
    l4, p4 = _sgld_dpt(4)
    assert l1 == l4
    for k in p1:
        assert p1[k].tobytes() == p4[k].tobytes()
    l5, p5 = _sgld_dpt(1, seed=32)
    assert any(p1[k].tobytes() != p5[k].tobytes() for k in p1)


def test_data_parallel_sgld_moves_by_its_law():
    rng = np.random.RandomState(2)
    net = gluon.nn.Dense(1, in_units=20_000, use_bias=False)
    net.initialize(mx.init.Zero(), ctx="cpu")
    x = rng.rand(4, 20_000).astype(np.float32)
    y = rng.rand(4, 1).astype(np.float32)
    lr = 0.02
    tr = DataParallelTrainer(net, lambda out, lab: 0.0 * out.sum(), "sgld",
                             {"learning_rate": lr}, device="cpu")
    tr.step(x, y)
    w = net.weight.data().asnumpy()
    _normal_law(w / np.sqrt(lr))


# -- the update ops -----------------------------------------------------------
def _op_inputs(name, rng):
    n = {"sgd_update": 2, "sgd_mom_update": 3, "mp_sgd_update": 3,
         "mp_sgd_mom_update": 4, "signsgd_update": 2, "signum_update": 3,
         "adam_update": 4, "rmsprop_update": 3, "rmspropalex_update": 5,
         "ftrl_update": 4, "ftml_update": 5}[name]
    xs = [rng.randn(6, 5).astype(np.float32) for _ in range(n)]
    positive = {"adam_update": [3], "rmsprop_update": [2],
                "rmspropalex_update": [2], "ftrl_update": [3],
                "ftml_update": [3]}
    for k in positive.get(name, ()):
        xs[k] = np.abs(xs[k]) + 0.5
    if name == "rmspropalex_update":
        xs[3] *= 0.1
    return xs


OP_PARAMS = {
    "sgd_update": {"lr": 0.1, "wd": 1e-3, "rescale_grad": 0.5,
                   "clip_gradient": 0.4},
    "sgd_mom_update": {"lr": 0.1, "momentum": 0.9, "wd": 1e-3},
    "mp_sgd_update": {"lr": 0.1, "wd": 1e-3, "clip_gradient": 0.4},
    "mp_sgd_mom_update": {"lr": 0.1, "momentum": 0.9, "wd": 1e-3},
    "signsgd_update": {"lr": 0.1, "wd": 1e-3},
    "signum_update": {"lr": 0.1, "momentum": 0.9, "wd": 1e-3,
                      "wd_lh": 1e-2},
    "adam_update": {"lr": 0.01, "wd": 1e-3, "clip_gradient": 0.5},
    "rmsprop_update": {"lr": 0.01, "clip_weights": 1.0},
    "rmspropalex_update": {"lr": 0.01, "wd": 1e-3},
    "ftrl_update": {"lr": 0.1, "lamda1": 0.01, "wd": 1e-3},
    "ftml_update": {"lr": 0.05, "t": 3, "clip_grad": 0.5},
}


@pytest.mark.parametrize("name", sorted(OP_PARAMS))
def test_update_op_matches_reference(name):
    xs = _op_inputs(name, np.random.RandomState(sum(map(ord, name))))
    want = jreg.get(name).fn(*[jmx.nd.array(x)._data for x in xs],
                             **OP_PARAMS[name])
    got = treg.get(name).fn(*[torch.from_numpy(x) for x in xs],
                            **OP_PARAMS[name])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    assert treg.get(name).mutates == jreg.get(name).mutates


def test_nd_update_op_writes_its_state_in_place():
    xs = _op_inputs("sgd_mom_update", np.random.RandomState(0))
    jw, jg, jm = [jmx.nd.array(x) for x in xs]
    tw, tg, tm = [nd.array(x) for x in xs]
    jmx.nd.sgd_mom_update(jw, jg, jm, out=jw, lr=0.1, momentum=0.9)
    nd.sgd_mom_update(tw, tg, tm, out=tw, lr=0.1, momentum=0.9)
    for a, b in ((jw, tw), (jm, tm)):
        np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), rtol=TOL,
                                   atol=TOL)


def test_updater_states_pickle_round_trip_for_tuple_states():
    # (optimizers whose step does not read the update count, which a
    # fresh optimizer restarts)
    for name, params in (("rmsprop", {"centered": True}), ("dcasgd", {}),
                         ("adadelta", {})):
        up = topt.get_updater(topt.create(name, **params))
        w = torch.ones(3)
        up(0, torch.full((3,), 0.5), w)
        blob = up.get_states()
        again = topt.get_updater(topt.create(name, **params))
        again.set_states(blob)
        w2 = w.clone()
        up(0, torch.full((3,), 0.25), w)
        again(0, torch.full((3,), 0.25), w2)
        assert torch.equal(w, w2)
        assert isinstance(pickle.loads(blob)[0], tuple)
