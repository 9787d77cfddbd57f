"""mxnet_tpu_torch.ndarray and its op set held against mxnet_tpu.ndarray.

The same seeded numpy arrays go through ``mx.nd`` (the reference, on the
CPU) and the port's ``nd`` on the CPU: arithmetic with scalars and
arrays (reflected and in-place forms), comparisons, the unary math, the
reductions of ``ops/reduce.py``, the shape and indexing ops the NDArray
methods reach, ``__getitem__`` / ``__setitem__`` and the creation
helpers.  Tolerance: 1e-6 (f32; a reduction may sum in another order,
elementwise results are the same roundings).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.context import use

TOL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _pair(*shape, seed=0, positive=False):
    rng = np.random.RandomState(seed)
    a = np.asarray(rng.randn(*shape), np.float32)
    if positive:
        a = np.abs(a) + 0.5
    return mx.nd.array(a), nd.array(a)


def _close(want, got, tol=TOL):
    if isinstance(want, (list, tuple)):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            _close(w, g, tol)
        return
    w, g = want.asnumpy(), got.asnumpy()
    assert w.shape == g.shape, (w.shape, g.shape)
    assert w.dtype == g.dtype, (w.dtype, g.dtype)
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


BINARY = ["__add__", "__sub__", "__mul__", "__truediv__", "__mod__",
          "__pow__", "__radd__", "__rsub__", "__rmul__", "__rtruediv__",
          "__eq__", "__ne__", "__gt__", "__ge__", "__lt__", "__le__"]


@pytest.mark.parametrize("op", BINARY)
@pytest.mark.parametrize("other", ["array", "broadcast", "scalar"])
def test_binary_operators_match_reference(op, other):
    ja, ta = _pair(3, 4, seed=1, positive=op in ("__pow__", "__rtruediv__"))
    if other == "scalar":
        jb = tb = 1.5
    else:
        shape = (3, 4) if other == "array" else (1, 4)
        jb, tb = _pair(*shape, seed=2, positive=op in (
            "__truediv__", "__mod__", "__pow__"))
    _close(getattr(ja, op)(jb), getattr(ta, op)(tb))


@pytest.mark.parametrize("op", ["__rpow__", "__rmod__"])
def test_reflected_scalar_operators_match_reference(op):
    ja, ta = _pair(2, 5, seed=3, positive=True)
    _close(getattr(ja, op)(2.0), getattr(ta, op)(2.0))


@pytest.mark.parametrize("op", ["__iadd__", "__isub__", "__imul__",
                                "__itruediv__"])
def test_inplace_operators_rebind_as_reference(op):
    ja, ta = _pair(3, 3, seed=4)
    jb, tb = _pair(3, 3, seed=5, positive=True)
    keep = ta._data
    ja = getattr(ja, op)(jb)
    ta = getattr(ta, op)(tb)
    _close(ja, ta)
    assert ta._data is not keep   # the handle was rebound, not written
    _close(-ja, -ta)
    _close(abs(ja), abs(ta))


UNARY = ["abs", "sign", "round", "rint", "ceil", "floor", "trunc", "fix",
         "square", "sqrt", "rsqrt", "cbrt", "rcbrt", "exp", "log", "log10",
         "log2", "log1p", "expm1", "sin", "cos", "tan", "arcsin", "arccos",
         "arctan", "sinh", "cosh", "tanh", "arcsinh", "arccosh", "arctanh",
         "degrees", "radians", "reciprocal", "negative", "logical_not",
         "gamma", "gammaln", "erf", "erfinv", "relu", "sigmoid", "softsign",
         "identity"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_ops_match_reference(name):
    rng = np.random.RandomState(6)
    x = rng.uniform(-0.9, 0.9, (4, 5)).astype(np.float32)
    if name in ("sqrt", "rsqrt", "log", "log10", "log2", "gamma",
                "gammaln", "rcbrt", "reciprocal"):
        x = np.abs(x) + 0.5
    if name == "arccosh":
        x = np.abs(x) + 1.5
    x[0, 0] = 0.5 if name not in ("arccosh",) else 2.5  # a tie for round
    want = getattr(mx.nd, name)(mx.nd.array(x))
    got = getattr(nd, name)(nd.array(x))
    _close(want, got, tol=1e-5 if name in ("gamma", "erfinv") else TOL)


@pytest.mark.parametrize("name", ["_maximum_scalar", "_minimum_scalar",
                                  "_hypot_scalar", "_logical_and_scalar",
                                  "_rmod_scalar", "_rpower_scalar"])
def test_scalar_ops_match_reference(name):
    ja, ta = _pair(3, 4, seed=7, positive=True)
    want = mx.nd._internal.__dict__[name](ja, scalar=0.75)
    got = nd.imperative_invoke(name, ta, scalar=0.75)
    _close(want, got)


@pytest.mark.parametrize("name", ["broadcast_maximum", "broadcast_minimum",
                                  "broadcast_hypot", "broadcast_logical_or",
                                  "elemwise_add", "elemwise_mul",
                                  "smooth_l1", "clip", "add_n"])
def test_named_elementwise_ops_match_reference(name):
    ja, ta = _pair(3, 4, seed=8)
    jb, tb = _pair(3, 4, seed=9)
    if name == "smooth_l1":
        args, kw = ((ja,), (ta,)), {"scalar": 1.5}
    elif name == "clip":
        args, kw = ((ja,), (ta,)), {"a_min": -0.5, "a_max": 0.3}
    elif name == "add_n":
        args, kw = ((ja, jb, ja), (ta, tb, ta)), {}
    else:
        args, kw = ((ja, jb), (ta, tb)), {}
    _close(getattr(mx.nd, name)(*args[0], **kw),
           getattr(nd, name)(*args[1], **kw))


REDUCTIONS = [("sum", {}), ("sum", {"axis": 1}),
              ("sum", {"axis": (0, 2), "keepdims": True}),
              ("sum", {"axis": 1, "exclude": True}),
              ("mean", {}), ("mean", {"axis": -1, "keepdims": True}),
              ("mean", {"axis": 0, "exclude": True}),
              ("prod", {"axis": 2}), ("prod", {"axis": (1, 2)}),
              ("max", {}), ("max", {"axis": 1}),
              ("min", {"axis": (0, 1), "keepdims": True}),
              ("norm", {}),
              ("norm", {"axis": 1, "keepdims": True}),
              ("norm", {"ord": 1, "axis": 2}),
              ("argmax", {}), ("argmax", {"axis": 1}),
              ("argmax", {"axis": 2, "keepdims": True}),
              ("argmin", {"axis": 0})]


@pytest.mark.parametrize("name,kw", REDUCTIONS,
                         ids=["%s-%s" % (n, "-".join(
                             "%s=%s" % i for i in sorted(k.items())))
                              for n, k in REDUCTIONS])
def test_reductions_match_reference(name, kw):
    ja, ta = _pair(3, 4, 5, seed=10)
    _close(getattr(mx.nd, name)(ja, **kw), getattr(nd, name)(ta, **kw))
    method = getattr(ta, name, None)
    if method is not None and "exclude" not in kw:
        _close(getattr(ja, name)(**kw), method(**kw))


SHAPE_METHODS = [
    ("reshape", ((2, -1, 0),), {}), ("reshape", ((-3, 0),), {}),
    ("reshape", ((-4, 1, -1, 0, 0),), {}), ("expand_dims", (1,), {}),
    ("flatten", (), {}), ("squeeze", (), {}), ("transpose", (), {}),
    ("transpose", ((1, 0, 2),), {}), ("swapaxes", (0, 2), {}),
    ("split", (2,), {"axis": 2}),
    ("split", (3,), {"axis": 1, "squeeze_axis": False}),
    ("slice", ((0, 1), (2, 3)), {}), ("slice_axis", (2, 1, 3), {}),
    ("tile", ((1, 2, 1),), {}), ("broadcast_to", ((2, 3, 4),), {}),
    ("clip", (-0.2, 0.4), {}), ("astype", ("float16",), {}),
    ("pad", ("constant", (0, 0, 0, 0, 1, 2)), {"constant_value": 0.5}),
]


@pytest.mark.parametrize("method,args,kw", SHAPE_METHODS,
                         ids=["%s%d" % (m, i) for i, (m, _, _)
                              in enumerate(SHAPE_METHODS)])
def test_shape_methods_match_reference(method, args, kw):
    shape = (2, 3, 4) if method != "broadcast_to" else (1, 3, 1)
    if method == "split" and args[0] == 3:
        shape = (2, 3, 4)
    if method == "squeeze":
        shape = (2, 1, 4)
    if method == "pad":
        shape = (1, 2, 3)
    ja, ta = _pair(*shape, seed=12)
    _close(getattr(ja, method)(*args, **kw), getattr(ta, method)(*args, **kw))


def test_matrix_and_indexing_ops_match_reference():
    ja, ta = _pair(3, 4, seed=13)
    jb, tb = _pair(4, 5, seed=14)
    _close(ja.dot(jb), ta.dot(tb))
    _close(mx.nd.dot(ja, ja, transpose_b=True), nd.dot(ta, ta,
                                                      transpose_b=True))
    idx = np.array([2, 0, 3], np.float32)
    _close(ja.take(mx.nd.array([0, 2, 5])), ta.take(nd.array([0, 2, 5])))
    _close(mx.nd.take(ja, mx.nd.array([[1, -1]]), axis=1, mode="wrap"),
           nd.take(ta, nd.array([[1, -1]]), axis=1, mode="wrap"))
    _close(mx.nd.pick(ja, mx.nd.array(idx), axis=1),
           nd.pick(ta, nd.array(idx), axis=1))
    _close(mx.nd.pick(ja, mx.nd.array([0, 1, 2, 1]), axis=0,
                      keepdims=True),
           nd.pick(ta, nd.array([0, 1, 2, 1]), axis=0, keepdims=True))
    _close(mx.nd.one_hot(mx.nd.array(idx), 5),
           nd.one_hot(nd.array(idx), 5))
    _close(mx.nd.array(idx).one_hot(4, on_value=2.0, off_value=-1.0),
           nd.array(idx).one_hot(4, on_value=2.0, off_value=-1.0))
    _close(mx.nd.where(ja > 0, ja, jb.T[:3]),
           nd.where(ta > 0, ta, tb.T[:3]))
    _close(mx.nd.concat(ja, ja * 2, dim=0), nd.concat(ta, ta * 2, dim=0))
    _close(mx.nd.Embedding(mx.nd.array([[0, 2]]), jb, input_dim=4,
                           output_dim=5),
           nd.Embedding(nd.array([[0, 2]]), tb, input_dim=4, output_dim=5))
    _close(ja.broadcast_like(mx.nd.zeros((2, 3, 4))),
           ta.broadcast_like(nd.zeros((2, 3, 4))))
    _close(mx.nd.zeros_like(ja), nd.zeros_like(ta))
    _close(mx.nd.ones_like(ja), nd.ones_like(ta))


@pytest.mark.parametrize("key", [1, -1, (0, 2), slice(1, 3),
                                 (slice(None), 1), (1, slice(0, 4, 2)),
                                 "nd_index"])
def test_getitem_setitem_match_reference(key):
    ja, ta = _pair(3, 4, seed=17)
    jk = tk = key
    if key == "nd_index":
        jk, tk = mx.nd.array([2, 0]), nd.array([2, 0])
    _close(ja[jk], ta[tk])
    ja[jk] = 7.5
    ta[tk] = 7.5
    _close(ja, ta)
    jb, tb = _pair(*ja[jk].shape, seed=18)
    ja[jk] = jb
    ta[tk] = tb
    _close(ja, ta)


def test_whole_array_assignment_and_iteration():
    ja, ta = _pair(2, 3, seed=19)
    ja[:] = 2.0
    ta[:] = 2.0
    _close(ja, ta)
    _close(list(ja), list(ta))
    assert len(ta) == 2 and ta.size == 6 and ta.ndim == 2
    assert ta.shape == ja.shape and ta.dtype == ja.dtype == np.float32


def test_creation_helpers_match_reference():
    _close(mx.nd.zeros((2, 3)), nd.zeros((2, 3)))
    _close(mx.nd.ones(4, dtype="int32"), nd.ones(4, dtype="int32"))
    _close(mx.nd.full((2, 2), 3.5), nd.full((2, 2), 3.5))
    _close(mx.nd.arange(1, 7, 1.5), nd.arange(1, 7, 1.5))
    _close(mx.nd.arange(3, repeat=2), nd.arange(3, repeat=2))
    _close(mx.nd.array([[1, 2], [3, 4]], dtype="int8"),
           nd.array([[1, 2], [3, 4]], dtype="int8"))
    _close(mx.nd.empty((2, 2)), nd.empty((2, 2)))
    _close(mx.nd.concatenate([mx.nd.ones((1, 2)), mx.nd.zeros((2, 2))]),
           nd.concatenate([nd.ones((1, 2)), nd.zeros((2, 2))]))


def test_scalars_copies_and_contexts():
    ja, ta = _pair(1, seed=20)
    assert ta.asscalar() == ja.asscalar()
    assert float(ta) == float(ja) and int(ta * 10) == int(ja * 10)
    assert bool(ta > -100) is True
    with pytest.raises(ValueError):
        bool(nd.ones((2,)))
    tb = ta.copy()
    tb[:] = 0.0
    assert ta.asscalar() != 0.0
    other = nd.zeros((1,))
    ta.copyto(other)
    _close(ja, other)
    assert ta.as_in_context("cpu") is ta
    assert ta.context == torch.device("cpu")
    ta.wait_to_read()
    nd.waitall()
    # asnumpy is a copy: writing the host array leaves the NDArray alone
    host = ta.asnumpy()
    host[:] = 123.0
    assert ta.asscalar() != 123.0


def test_ops_outside_record_build_no_graph():
    from mxnet_tpu_torch import autograd
    x = nd.array([1.0, 2.0])
    x.attach_grad()
    y = x * 3
    assert y._data.grad_fn is None and not y._data.requires_grad
    with autograd.record():
        z = x * 3
    assert z._data.grad_fn is not None


def test_bfloat16_arrays_keep_their_dtype():
    x = nd.array([1.5, -2.25], dtype="bfloat16")
    assert x.dtype == "bfloat16" and x._data.dtype == torch.bfloat16
    np.testing.assert_array_equal(x.asnumpy(), [1.5, -2.25])
    assert x.asnumpy().dtype == np.float32
    assert (x * 2).dtype == "bfloat16"


def test_entry_points_create_on_the_card_by_default():
    """Without ``ctx`` (and outside ``use("cpu")``) an array is made on
    the CUDA device, and with no card that raises instead of falling back
    to the host."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.context import current_context
    with _no_default():
        if torch.cuda.is_available():
            assert nd.zeros((1,)).context.type == "cuda"
            assert nd.array([1.0]).context.type == "cuda"
        else:
            for make in (lambda: nd.zeros((1,)),
                         lambda: nd.array([1.0]),
                         lambda: nd.ones((2,)), current_context):
                with pytest.raises(MXNetError, match="no CUDA device"):
                    make()


class _no_default:
    """Leave the ``use("cpu")`` of the autouse fixture for a block."""

    def __enter__(self):
        from mxnet_tpu_torch import context
        self._old = getattr(context._default, "value", None)
        context._default.value = None

    def __exit__(self, *exc):
        from mxnet_tpu_torch import context
        context._default.value = self._old
