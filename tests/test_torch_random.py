"""``mx.random`` / ``nd.random`` and the samplers of ``ops/random.py``,
held to ``mxnet_tpu`` on the CPU.

The reference samples with JAX's threefry and the port with torch's
generators, so a sampler is held by its law: 10^5 draws of each package
under one fixed seed each, compared by a two-sample Kolmogorov-Smirnov
test (continuous laws) or a chi-squared test of the two count tables
(discrete laws), failing at p < 0.001.  The seeds were fixed before the
first run.  Shapes, dtypes and the ``_sample_*`` broadcasting are
compared directly, ``get_prob`` against the reference's log-probability
of the same indices, and the seed and state round-trips, and the
independence from torch's default generators, bitwise.
"""
import numpy as np
import pytest
import scipy.stats
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _rng, autograd, context, gluon, initializer, nd

N = 100_000
ALPHA = 0.001
PORT_SEED, REF_SEED = 1801, 1802


def _port(fn):
    with context.use("cpu"):
        mx.random.seed(PORT_SEED)
        return fn(mx, nd)


def _ref(fn):
    jmx.random.seed(REF_SEED)
    return fn(jmx, jmx.nd)


def _np(a):
    return a.asnumpy()


def _same_law(a, b, discrete):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    if not discrete:
        p = scipy.stats.ks_2samp(a, b).pvalue
    else:
        cats, counts = np.unique(np.concatenate([a, b]), return_counts=True)
        keep = cats[counts >= 20]
        table = np.array([[np.sum(x == c) for c in keep]
                          + [np.sum(~np.isin(x, keep))] for x in (a, b)])
        table = table[:, table.sum(axis=0) > 0]
        p = scipy.stats.chi2_contingency(table).pvalue
    assert p > ALPHA, p
    return p


# public sampler -> (positional args, discrete?)
SCALAR = {
    "uniform": ((-1.0, 2.0), False),
    "normal": ((0.5, 2.0), False),
    "gamma": ((2.5, 1.5), False),
    "exponential": ((3.0,), False),
    "poisson": ((4.0,), True),
    "negative_binomial": ((3, 0.4), True),
    "generalized_negative_binomial": ((2.0, 0.5), True),
    "randint": ((-3, 7), True),
}


@pytest.mark.parametrize("name", sorted(SCALAR))
def test_scalar_sampler_law_shape_dtype(name):
    args, discrete = SCALAR[name]

    def draw(pkg, pnd):
        return getattr(pnd.random, name)(*args, shape=(N,))

    got, want = _port(draw), _ref(draw)
    assert got.shape == want.shape == (N,)
    assert got.dtype == want.dtype
    _same_law(_np(got), _np(want), discrete)


def test_generalized_negative_binomial_alpha_zero_is_poisson():
    def draw(pkg, pnd):
        return pnd.random.generalized_negative_binomial(3.0, 0.0, shape=(N,))

    _same_law(_np(_port(draw)), _np(_ref(draw)), True)


def test_randn_and_sampler_dtypes():
    def draw(pkg, pnd):
        return (pnd.random.randn(3, 4), pnd.random.uniform(shape=(2,),
                                                          dtype="float64"),
                pnd.random.randint(0, 5, shape=(3,), dtype="int32"))

    got, want = _port(draw), _ref(draw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
    assert got[0].dtype == want[0].dtype == np.float32
    assert got[2].dtype == want[2].dtype == np.int32


# per-element sampler -> (parameter arrays, discrete?)
ELEMENTWISE = {
    "_sample_uniform": ([[0.0, -2.0], [1.0, 3.0]], False),
    "_sample_normal": ([[0.0, 5.0], [1.0, 0.5]], False),
    "_sample_gamma": ([[2.0, 0.7], [1.0, 3.0]], False),
    "_sample_exponential": ([[1.0, 10.0]], False),
    "_sample_poisson": ([[1.0, 20.0]], True),
    "_sample_negative_binomial": ([[5.0, 2.0], [0.5, 0.3]], True),
    "_sample_generalized_negative_binomial": ([[2.0, 6.0], [0.5, 0.2]],
                                              True),
}


@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_elementwise_sampler_law_and_broadcast(name):
    params, discrete = ELEMENTWISE[name]
    arrays = [np.asarray(p, np.float32) for p in params]
    per = N // 2

    def draw(pkg, pnd):
        return pnd.imperative_invoke(name, *[pnd.array(a) for a in arrays],
                                     shape=(per,))

    got, want = _port(draw), _ref(draw)
    assert got.shape == want.shape == (2, per)
    assert got.dtype == want.dtype
    for row in range(2):
        _same_law(_np(got)[row], _np(want)[row], discrete)

    def draw2(pkg, pnd):
        return pnd.imperative_invoke(name, *[pnd.array(np.stack([a, a]))
                                             for a in arrays], shape=(3, 2))

    assert _port(draw2).shape == _ref(draw2).shape == (2, 2, 3, 2)


def test_multinomial_law_and_get_prob():
    probs = np.array([[0.1, 0.2, 0.3, 0.4], [0.7, 0.1, 0.1, 0.1]],
                     np.float32)

    def draw(pkg, pnd):
        return pnd.random.multinomial(pnd.array(probs), shape=N // 2,
                                      get_prob=True)

    (got, lp), (want, _) = _port(draw), _ref(draw)
    assert got.shape == want.shape == (2, N // 2)
    assert got.dtype == want.dtype == np.int32
    for row in range(2):
        _same_law(_np(got)[row], _np(want)[row], True)
    ref_lp = np.log(probs)[np.arange(2)[:, None], _np(got)]
    np.testing.assert_allclose(_np(lp), ref_lp, rtol=1e-6, atol=1e-7)


def test_multinomial_shapes_match_reference():
    probs = np.full((2, 3, 5), 0.2, np.float32)

    def draw(pkg, pnd):
        return (pnd.random.multinomial(pnd.array(probs)),
                pnd.random.multinomial(pnd.array(probs[0, 0]), shape=(4, 2)))

    for g, w in zip(_port(draw), _ref(draw)):
        assert g.shape == w.shape and g.dtype == w.dtype


def test_shuffle_is_a_permutation_of_rows():
    x = np.arange(60, dtype=np.float32).reshape(20, 3)
    with context.use("cpu"):
        mx.random.seed(4)
        out = nd.random.shuffle(nd.array(x)).asnumpy()
    assert sorted(out[:, 0].tolist()) == x[:, 0].tolist()
    np.testing.assert_array_equal(out[:, 1:] - out[:, :1],
                                  x[:, 1:] - x[:, :1])
    assert not np.array_equal(out, x)


def _stream(n=4):
    """A run of draws through every kind of consumer, on the CPU."""
    with context.use("cpu"):
        x = nd.ones((6, 8))
        with autograd.record(train_mode=True):
            drop = nd.Dropout(x, p=0.5)
            rrelu = nd.LeakyReLU(-x, act_type="rrelu")
        return [nd.random.uniform(shape=(n,)).asnumpy(),
                nd.random.normal(shape=(n,)).asnumpy(),
                nd.random.poisson(2.0, shape=(n,)).asnumpy(),
                drop.asnumpy(), rrelu.asnumpy(), np.random.rand(n)]


def _bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()


def test_seed_repeats_bitwise_and_successive_calls_differ():
    mx.random.seed(11)
    first = _stream()
    second = _stream()
    mx.random.seed(11)
    _bitwise(first, _stream())
    assert first[0].tobytes() != second[0].tobytes()
    mx.random.seed(12)
    assert _stream()[0].tobytes() != first[0].tobytes()


def test_state_round_trip_is_bitwise():
    mx.random.seed(5)
    _stream()
    state = _rng.get_state()
    after = _stream()
    _stream()
    _rng.set_state(state)
    _bitwise(after, _stream())


def test_torch_default_generators_change_nothing():
    mx.random.seed(21)
    torch.manual_seed(0)
    a = _stream()
    mx.random.seed(21)
    torch.manual_seed(12345)
    torch.rand(100)
    b = _stream()
    _bitwise(a, b)


def test_executor_and_sym_random_draw_from_the_seeded_generator():
    from mxnet_tpu_torch import sym
    from mxnet_tpu_torch.executor import Executor
    net = sym.Dropout(sym.var("data"), p=0.5) + sym.random.uniform(
        shape=(4, 4))
    with context.use("cpu"):
        outs = []
        for _ in range(2):
            mx.random.seed(3)
            ex = Executor.simple_bind(net, ctx="cpu",
                                      shapes={"data": (4, 4)})
            ex.forward(is_train=True, data=np.ones((4, 4), np.float32))
            outs.append(ex.outputs[0].asnumpy())
    assert outs[0].tobytes() == outs[1].tobytes()


def _mlp(pkg_gluon, deferred):
    net = pkg_gluon.nn.HybridSequential()
    with net.name_scope():
        if deferred:
            net.add(pkg_gluon.nn.Dense(7, activation="relu"),
                    pkg_gluon.nn.Dense(3))
        else:
            net.add(pkg_gluon.nn.Dense(7, activation="relu", in_units=5),
                    pkg_gluon.nn.Dense(3, in_units=7))
    return net


@pytest.mark.parametrize("deferred", [False, True])
def test_seeded_initialize_is_bitwise_the_reference(deferred):
    x = np.ones((2, 5), np.float32)
    jmx.random.seed(9)
    jnet = _mlp(jmx.gluon, deferred)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    mx.random.seed(9)
    net = _mlp(gluon, deferred)
    net.initialize(initializer.Xavier(), ctx="cpu")
    with context.use("cpu"):
        net(nd.array(x))
    want = [p.data().asnumpy() for p in jnet.collect_params().values()]
    got = [p.data().asnumpy() for p in net.collect_params().values()]
    _bitwise(want, got)
