"""``ops/linalg.py``, ``ops/control_flow.py`` and ``ops/image_ops.py`` of
mxnet_tpu_torch held against mxnet_tpu on the CPU, on the same seeded
numpy inputs.

- Every ``linalg`` name (its ``linalg_*`` alias the same op), forward and
  the gradient of ``sum(out * ct)`` over its float outputs (``ct`` seeded
  cotangents) with respect to every input, in float32 and float64 (the
  reference under ``jax.enable_x64``, compiled once a case by
  ``jax.jit`` at XLA's LLVM level 0): float32 within 1e-5, float64
  within 1e-10, of the larger of 1 and the reference's largest
  magnitude.  ``gelqf`` and ``syevd`` are unique up to one sign a row,
  which the two packages' LAPACK calls may fix apart (the reference's
  float32 ``eigh`` and torch's do on a 4 x 4): each row of the port's is
  held after taking the reference's sign (L's columns with Q's rows),
  and the sign-free checks (A rebuilt, Q orthonormal,
  ``|<u_i, u'_i>| = 1``), which ``chip_smoke.py`` phase 31 holds the
  card to, run here too.  Their gradients are of ``sum(cos(out))``,
  which no sign changes (``cos`` is even).
- ``nd.contrib.foreach`` (one and many data and states, its gradient),
  ``while_loop`` (with and without ``max_iterations``) and ``cond``:
  outputs and gradients within 1e-6; ``_histogram`` (edges given,
  ``bin_cnt`` with and without ``range``, values on edges, equal
  extremes) with counts equal and edges within 1e-6; ``square_sum``;
  the two image ops.
- Every case of ``tests/test_linalg_cf_quant.py`` apart from the
  quantization ones, through both packages (its linalg cases at the
  float32 linalg limit, 1e-5).
- ROADMAP.md C13: ``trmm`` multiplies by the whole matrix in both
  packages (upstream MXNet reads only the named triangle).
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.ops import registry as treg

treg.load_all()
TOL = {np.float32: 1e-5, np.float64: 1e-10}
CF_TOL = 1e-6


# the reference compiled once a case, by XLA's CPU backend at LLVM level 0
# (the same HLO in less compile time than its eager dispatch)
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def ref_jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _within(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want.astype(np.float64)).max(initial=0)))
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=0,
                               atol=tol * scale)


def _spd(rng, *shape):
    a = rng.randn(*shape)
    n = shape[-1]
    return a @ np.swapaxes(a, -1, -2) / n + np.eye(n)


def _lower(rng, *shape):
    return np.tril(rng.randn(*shape)) + 3 * np.eye(shape[-1])


def _sym(rng, *shape):
    a = rng.randn(*shape)
    return (a + np.swapaxes(a, -1, -2)) / 2


# name -> (inputs(rng), params); batched (2, n, n) matrices unless noted
LINALG = {
    "gemm": (lambda r: [r.randn(2, 3, 4), r.randn(2, 4, 5), r.randn(2, 3, 5)],
             dict(alpha=2.0, beta=0.5)),
    "gemm-t": (lambda r: [r.randn(2, 4, 3), r.randn(2, 5, 4),
                          r.randn(2, 3, 5)],
               dict(transpose_a=True, transpose_b=True, alpha=-1.5)),
    "gemm2": (lambda r: [r.randn(2, 3, 4), r.randn(2, 4, 5)],
              dict(alpha=0.5)),
    "gemm2-t": (lambda r: [r.randn(3, 4), r.randn(5, 3)],
                dict(transpose_a=True, transpose_b=True)),
    "potrf": (lambda r: [_spd(r, 2, 4, 4)], {}),
    "potri": (lambda r: [_lower(r, 2, 4, 4)], {}),
    "trmm": (lambda r: [_lower(r, 2, 4, 4), r.randn(2, 4, 3)],
             dict(alpha=2.0)),
    "trmm-rt": (lambda r: [_lower(r, 2, 4, 4), r.randn(2, 3, 4)],
                dict(rightside=True, transpose=True)),
    "trsm": (lambda r: [_lower(r, 2, 4, 4), r.randn(2, 4, 3)],
             dict(alpha=0.5)),
    "trsm-t": (lambda r: [_lower(r, 2, 4, 4), r.randn(2, 4, 3)],
               dict(transpose=True)),
    "trsm-r": (lambda r: [_lower(r, 2, 4, 4), r.randn(2, 3, 4)],
               dict(rightside=True)),
    "trsm-rt-upper": (lambda r: [np.swapaxes(_lower(r, 2, 4, 4), -1, -2),
                                 r.randn(2, 3, 4)],
                      dict(rightside=True, transpose=True, lower=False)),
    "sumlogdiag": (lambda r: [_spd(r, 2, 4, 4)], {}),
    "extractdiag": (lambda r: [r.randn(2, 4, 4)], {}),
    "extractdiag-o": (lambda r: [r.randn(2, 4, 4)], dict(offset=-1)),
    "makediag": (lambda r: [r.randn(2, 3)], {}),
    "makediag-o": (lambda r: [r.randn(2, 3)], dict(offset=-2)),
    "makediag-o+": (lambda r: [r.randn(3)], dict(offset=1)),
    "extracttrian": (lambda r: [r.randn(2, 4, 4)], {}),
    "extracttrian-up": (lambda r: [r.randn(2, 4, 4)],
                        dict(lower=False, offset=1)),
    "extracttrian-o": (lambda r: [r.randn(4, 4)], dict(offset=-1)),
    "syrk": (lambda r: [r.randn(2, 3, 4)], dict(alpha=1.5)),
    "syrk-t": (lambda r: [r.randn(2, 3, 4)], dict(transpose=True)),
    "gelqf": (lambda r: [r.randn(2, 3, 5)], {}),
    "syevd": (lambda r: [_sym(r, 2, 4, 4)], {}),
    "inverse": (lambda r: [r.randn(2, 4, 4) + 4 * np.eye(4)], {}),
    "det": (lambda r: [r.randn(2, 4, 4) + 4 * np.eye(4)], {}),
    "slogdet": (lambda r: [r.randn(2, 4, 4) - 4 * np.eye(4)], {}),
}


@contextlib.contextmanager
def _x64(dtype):
    with jax.enable_x64(dtype == np.float64):
        yield


def _linalg_both(key, dtype):
    """(reference outputs, port outputs, reference grads, port grads) as
    numpy, from the same inputs."""
    name = "_linalg_" + key.split("-")[0]
    make, params = LINALG[key]
    xs = [x.astype(dtype) for x in make(np.random.RandomState(0))]
    jop, top = jreg.get(name), treg.get(name)
    n = jop.n_outputs(params)
    signed = name in ("_linalg_gelqf", "_linalg_syevd")
    def outs_of(*a):
        out = jop.fn(*a, **params)
        return (list(out) if isinstance(out, (tuple, list)) else [out])[:n]

    with _x64(dtype):
        ja = [jnp.asarray(x) for x in xs]
        rng = np.random.RandomState(1)
        cts = [rng.randn(*o.shape).astype(dtype)
               for o in jax.eval_shape(outs_of, *ja)]

        def run(*a):
            def scalar(*a):
                outs = outs_of(*a)
                return sum(jnp.sum(jnp.cos(o) if signed else o * c)
                           for o, c in zip(outs, cts)), outs
            return jax.grad(scalar, argnums=tuple(range(len(a))),
                            has_aux=True)(*a)
        jg, jout = ref_jit(run, *ja)
        want = [np.asarray(o) for o in jout]
        want_g = [np.asarray(g) for g in jg]
    ta = [torch.from_numpy(x.copy()).requires_grad_(True) for x in xs]
    tout = top.fn(*ta, **params)
    tout = list(tout) if isinstance(tout, (tuple, list)) else [tout]
    torch.stack([(torch.cos(o) if signed else o * torch.from_numpy(c)).sum()
                 for o, c in zip(tout[:n], cts)]).sum().backward()
    got = [o.detach().numpy() for o in tout[:n]]
    got_g = [np.zeros_like(x) if t.grad is None else t.grad.numpy()
             for x, t in zip(xs, ta)]
    return want, got, want_g, got_g


def _align_signs(key, want, got):
    """The port's gelqf / syevd outputs with each row's sign (and L's
    matching column) set to the reference's."""
    if key not in ("gelqf", "syevd"):
        return got
    rows = got[1] if key == "gelqf" else got[0]
    ref = want[1] if key == "gelqf" else want[0]
    sign = np.where(np.einsum("...ij,...ij->...i", rows, ref) < 0, -1, 1)
    sign = sign.astype(rows.dtype)
    if key == "gelqf":
        return [got[0] * sign[..., None, :], got[1] * sign[..., :, None]]
    return [got[0] * sign[..., :, None], got[1]]


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("key", sorted(LINALG))
def test_linalg_forward_and_gradient(key, dtype):
    want, got, want_g, got_g = _linalg_both(key, dtype)
    assert len(got) == len(want)
    got = _align_signs(key.split("-")[0], want, got)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        _within(g, w, TOL[dtype])
    for w, g in zip(want_g, got_g):
        _within(g, w, TOL[dtype])


def test_linalg_aliases_are_the_same_ops():
    names = {n for n in jreg.list_ops() if "linalg_" in n}
    assert len(names) == 32
    for n in names:
        if n.startswith("linalg_"):
            assert treg.get(n) is treg.get("_" + n)
    nd = tmx.nd
    for short in ("gemm", "potrf", "syevd", "slogdet"):
        assert nd.linalg.__dict__[short].__name__ == "_linalg_" + short
        assert tmx.sym.linalg.__dict__[short].__name__ == "_linalg_" + short


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_gelqf_syevd_sign_free(dtype):
    """The checks the card is held to: A = L Q, Q's rows orthonormal, L
    lower; U^T diag(w) U = A, and each eigenvector equal to the
    reference's up to its sign."""
    tol = TOL[dtype] * 10
    rng = np.random.RandomState(3)
    a = rng.randn(3, 4, 7).astype(dtype)
    L, Q = treg.get("_linalg_gelqf").fn(torch.from_numpy(a))
    L, Q = L.numpy(), Q.numpy()
    _within(L @ Q, a, tol)
    _within(Q @ np.swapaxes(Q, -1, -2), np.broadcast_to(np.eye(4),
                                                         (3, 4, 4)), tol)
    _within(np.triu(L, 1), np.zeros_like(L), 0)
    s = _sym(rng, 3, 5, 5).astype(dtype)
    U, w = treg.get("_linalg_syevd").fn(torch.from_numpy(s))
    U, w = U.numpy(), w.numpy()
    _within(np.swapaxes(U, -1, -2) @ (w[..., None] * U), s, tol)
    with _x64(dtype):
        ju, jw = jreg.get("_linalg_syevd").fn(jnp.asarray(s))
    dots = np.abs(np.einsum("bij,bij->bi", U, np.asarray(ju)))
    _within(dots, np.ones_like(dots), tol)


def test_trmm_reads_the_whole_matrix_in_both_packages():
    """ROADMAP.md C13: ``lower`` is ignored: a full matrix is multiplied
    whole (upstream MXNet would use its lower triangle only)."""
    rng = np.random.RandomState(4)
    a = rng.randn(4, 4).astype(np.float32)
    b = rng.randn(4, 3).astype(np.float32)
    for lower in (True, False):
        want = np.asarray(jreg.get("_linalg_trmm").fn(
            jnp.asarray(a), jnp.asarray(b), lower=lower))
        got = treg.get("_linalg_trmm").fn(torch.from_numpy(a),
                                          torch.from_numpy(b),
                                          lower=lower).numpy()
        _within(got, want, 1e-6)
        _within(got, a @ b, 1e-5)
        assert not np.allclose(got, np.tril(a) @ b, atol=1e-3)


def test_linalg_shapes_on_the_meta_device():
    """Shape inference runs the op on meta tensors."""
    for key in ("potrf", "potri", "trsm", "syevd", "gelqf", "inverse",
                "det", "slogdet", "extracttrian", "makediag", "sumlogdiag"):
        name = "_linalg_" + key
        make, params = LINALG[key]
        xs = make(np.random.RandomState(0))
        metas = [torch.empty(x.shape, device="meta") for x in xs]
        out = treg.get(name).fn(*metas, **params)
        outs = out if isinstance(out, tuple) else (out,)
        ref = treg.get(name).fn(*[torch.from_numpy(x) for x in xs],
                                **params)
        refs = ref if isinstance(ref, tuple) else (ref,)
        assert [o.shape for o in outs] == [r.shape for r in refs], key


# -- control flow ----------------------------------------------------------
def _both(fn, tol=CF_TOL):
    """fn(package) run through the reference and the port (on the CPU),
    each result as a list of numpy arrays, held within ``tol``."""
    def flat(x):
        if isinstance(x, (list, tuple)):
            return [a for v in x for a in flat(v)]
        return [np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)]
    want = flat(fn(jmx))
    with use("cpu"):
        got = flat(fn(tmx))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _within(g, w, tol)
    return want, got


def test_foreach_scan():
    def run(mx):
        data = mx.nd.array(np.arange(12, dtype=np.float32).reshape(4, 3))
        return mx.nd.contrib.foreach(lambda x, s: (s + x, s + x), data,
                                     mx.nd.zeros((3,)))
    want, got = _both(run)
    np.testing.assert_allclose(got[1], np.arange(12).reshape(4, 3).sum(0))


def test_foreach_multi_state():
    def run(mx):
        data = mx.nd.array(np.ones((5, 2), np.float32))

        def body(x, states):
            s0, s1 = states
            return x * s1, [s0 + x, s1 * 2]
        return mx.nd.contrib.foreach(body, data,
                                     [mx.nd.zeros((2,)), mx.nd.ones((2,))])
    _, got = _both(run)
    np.testing.assert_allclose(got[1], 5.0)
    np.testing.assert_allclose(got[2], 32.0)
    assert got[0].shape == (5, 2)


def test_foreach_many_data_many_outputs_and_gradient():
    """Two data, two states, two outputs a step and a weight the body
    closes over: outputs and the gradients of data, states and weight.
    The reference drops the gradient of an array the body closes over
    (its scan is one tape node whose inputs are the data and the states:
    the weight's gradient comes out zero, shown here), and the port gives
    it: the port's closed-over weight is held to the reference's weight
    threaded through as a third state."""
    rng = np.random.RandomState(5)
    xa, xb = rng.randn(6, 2, 3), rng.randn(6, 2, 4)
    h0, c0 = rng.randn(2, 5), rng.randn(2, 5)
    w = rng.randn(12, 5) * 0.3

    def run(mx, threaded):
        arrs = [mx.nd.array(a.astype(np.float32)) for a in (xa, xb, h0, c0,
                                                            w)]
        for a in arrs:
            a.attach_grad()
        xa_, xb_, h_, c_, w_ = arrs

        def body(xs, states):
            h, c = states[:2]
            wt = states[2] if threaded else w_
            z = mx.nd.dot(mx.nd.concat(xs[0], xs[1], h, dim=1), wt)
            c2 = c * mx.nd.sigmoid(z) + mx.nd.tanh(z)
            h2 = mx.nd.tanh(c2)
            return [h2, z], [h2, c2] + ([wt] if threaded else [])
        with mx.autograd.record():
            (hs, zs), finals = mx.nd.contrib.foreach(
                body, [xa_, xb_], [h_, c_] + ([w_] if threaded else []))
            hT, cT = finals[:2]
            loss = (hs * hs).sum() + zs.sum() * 0.1 + (cT * hT).sum()
        loss.backward()
        return [np.asarray(a.asnumpy()) for a in
                [hs, zs, hT, cT] + [a.grad for a in arrs]]
    want = run(jmx, True)
    dropped = run(jmx, False)
    np.testing.assert_array_equal(dropped[-1], 0.0)
    for g, d in zip(want[:-1], dropped[:-1]):
        _within(d, g, CF_TOL)
    with use("cpu"):
        got = run(tmx, False)
    for g, d in zip(got, want):
        _within(g, d, CF_TOL)
    assert np.abs(got[-1]).max() > 0.1


def test_foreach_grad():
    def run(mx):
        data = mx.nd.array(np.ones((4, 2), np.float32) * 2)
        data.attach_grad()
        with mx.autograd.record():
            outs, final = mx.nd.contrib.foreach(
                lambda x, s: (x * s, s + x), data, mx.nd.ones((2,)))
            loss = mx.nd.sum(final)
        loss.backward()
        return data.grad
    _, got = _both(run)
    np.testing.assert_allclose(got[0], 1.0)


def test_foreach_body_sees_the_training_flag():
    """The body runs with the caller's training flag in both packages
    (the reference traces it once, the port calls it once a step)."""
    for pkg in (jmx, tmx):
        for mode in (True, False):
            seen = []

            def body(x, s):
                seen.append(pkg.autograd.is_training())
                return x, s
            with use("cpu"):
                data = pkg.nd.array(np.ones((2, 2), np.float32))
                with pkg.autograd.record(train_mode=mode):
                    pkg.nd.contrib.foreach(body, data, pkg.nd.zeros((2,)))
            assert seen and set(seen) == {mode}, (pkg.__name__, mode, seen)


def test_while_loop_and_cond():
    def run(mx):
        a = mx.nd.contrib.while_loop(lambda vs: vs[0] < 10,
                                     lambda vs: [vs[0] + 3],
                                     [mx.nd.array([0.0])], max_iterations=20)
        b = mx.nd.contrib.while_loop(lambda vs: vs[0] < 1e9,
                                     lambda vs: [vs[0] + 1],
                                     [mx.nd.array([0.0])], max_iterations=5)
        c = mx.nd.contrib.while_loop(lambda v: v.sum() < 7,
                                     lambda v: v * 2, mx.nd.array([1.0, 2.0]))
        d = mx.nd.contrib.cond(mx.nd.array([0.0]), lambda x: x * 2,
                               lambda x: x * 3, [mx.nd.array([5.0])])
        e = mx.nd.contrib.cond(mx.nd.array([1.0]),
                               lambda x, y: [x + y, x - y],
                               lambda x, y: [x, y],
                               [mx.nd.array([5.0]), mx.nd.array([2.0])])
        return [a, b, c, d, e]
    _, got = _both(run)
    assert float(got[0][0]) == 12.0 and float(got[1][0]) == 5.0
    np.testing.assert_allclose(got[2], [4.0, 8.0])
    assert float(got[3][0]) == 15.0
    np.testing.assert_allclose(got[4:], [[7.0], [3.0]])


def test_while_loop_tests_the_condition_once_a_step():
    calls = []

    def cond_fn(vs):
        calls.append(1)
        return vs[0] < 4
    with use("cpu"):
        out = tmx.nd.contrib.while_loop(cond_fn, lambda vs: [vs[0] + 1],
                                        [tmx.nd.array([0.0])])
        assert float(out[0].asscalar()) == 4.0 and len(calls) == 5
        del calls[:]
        tmx.nd.contrib.while_loop(cond_fn, lambda vs: [vs[0] + 1],
                                  [tmx.nd.array([0.0])], max_iterations=2)
        assert len(calls) == 2


# -- histogram, square_sum -------------------------------------------------
HIST = {
    "bin_cnt-range": (lambda r: [r.rand(50)], dict(bin_cnt=5,
                                                   range=(0.0, 1.2))),
    "bin_cnt-data-range": (lambda r: [r.randn(7, 9)], dict(bin_cnt=7)),
    "on-edges": (lambda r: [np.array([0.0, 0.25, 0.5, 0.5, 0.75, 1.0, 1.0,
                                      -0.5, 1.5])],
                 dict(bin_cnt=4, range=(0.0, 1.0))),
    "equal-extremes": (lambda r: [np.full(6, 3.0)], dict(bin_cnt=3)),
    "edges": (lambda r: [r.rand(40), np.array([0.0, 0.2, 0.5, 0.9, 1.0])],
              {}),
    "edges-hit": (lambda r: [np.array([0.0, 0.5, 0.8, 1.0, 0.8, 2.0, -1.0]),
                             np.array([0.0, 0.5, 0.8, 1.0])], {}),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("key", sorted(HIST))
def test_histogram(key, dtype):
    make, params = HIST[key]
    xs = [x.astype(dtype) for x in make(np.random.RandomState(6))]
    with _x64(dtype):
        jc, je = ref_jit(lambda *a: jreg.get("_histogram").fn(*a, **params),
                         *[jnp.asarray(x) for x in xs])
        jc, je = np.asarray(jc), np.asarray(je)
    tc, te = treg.get("histogram").fn(*[torch.from_numpy(x) for x in xs],
                                      **params)
    assert tc.dtype == torch.from_numpy(jc).dtype
    np.testing.assert_array_equal(tc.numpy(), jc)
    _within(te.numpy(), je, CF_TOL)


def test_histogram_and_square_sum():
    def run(mx):
        x = mx.nd.array(np.array([0.1, 0.4, 0.6, 0.9, 0.95], np.float32))
        counts, edges = mx.nd.histogram(x, bin_cnt=2, range=(0.0, 1.0))
        counts2, edges2 = mx.nd.histogram(
            x, mx.nd.array(np.array([0.0, 0.5, 0.8, 1.0], np.float32)))
        s = mx.nd.square_sum(mx.nd.array(np.array([[1.0, 2.0], [3.0, 4.0]],
                                                  np.float32)), axis=1)
        return [counts, edges, counts2, edges2, s]
    _, got = _both(run)
    np.testing.assert_array_equal(got[0], [2, 3])
    np.testing.assert_array_equal(got[2], [2, 1, 2])
    np.testing.assert_allclose(got[4], [5.0, 25.0])


@pytest.mark.parametrize("params", [dict(), dict(axis=1),
                                    dict(axis=(0, 2), keepdims=True),
                                    dict(keepdims=True)],
                         ids=["all", "axis1", "axes-keep", "all-keep"])
def test_square_sum(params):
    x = np.random.RandomState(7).randn(3, 4, 5).astype(np.float32)
    want = np.asarray(jreg.get("square_sum").fn(jnp.asarray(x), **params))
    t = torch.from_numpy(x).requires_grad_(True)
    got = treg.get("_square_sum").fn(t, **params)
    _within(got.detach().numpy(), want, CF_TOL)
    got.sum().backward()
    _within(t.grad.numpy(), 2 * x, CF_TOL)


# -- image ops -------------------------------------------------------------
IMAGE = {
    "to_tensor-hwc": ("_image_to_tensor",
                      lambda r: [r.randint(0, 256, (4, 5, 3)).astype(
                          np.uint8)], {}),
    "to_tensor-nhwc": ("_image_to_tensor",
                       lambda r: [r.randint(0, 256, (2, 4, 5, 3)).astype(
                           np.uint8)], {}),
    "normalize-chw": ("_image_normalize",
                      lambda r: [r.rand(3, 4, 5).astype(np.float32)],
                      dict(mean=(0.485, 0.456, 0.406),
                           std=(0.229, 0.224, 0.225))),
    "normalize-nchw": ("_image_normalize",
                       lambda r: [r.rand(2, 3, 4, 5).astype(np.float32)],
                       dict(mean=(0.1, 0.2, 0.3), std=(1.0, 2.0, 4.0))),
    "normalize-scalar": ("_image_normalize",
                         lambda r: [r.rand(3, 4, 5).astype(np.float32)],
                         dict(mean=0.5, std=0.25)),
}


@pytest.mark.parametrize("key", sorted(IMAGE))
def test_image_ops(key):
    name, make, params = IMAGE[key]
    xs = make(np.random.RandomState(8))
    want = np.asarray(jreg.get(name).fn(*[jnp.asarray(x) for x in xs],
                                        **params))
    got = treg.get(name).fn(*[torch.from_numpy(x) for x in xs], **params)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


# -- the reference's own cases (tests/test_linalg_cf_quant.py) -------------
def test_linalg_potrf_potri():
    def run(mx):
        rng = np.random.RandomState(0)
        A = rng.randn(3, 4, 4).astype(np.float32)
        spd = A @ A.transpose(0, 2, 1) + 4 * np.eye(4, dtype=np.float32)
        L = mx.nd.linalg_potrf(mx.nd.array(spd))
        return [L, mx.nd.linalg_potri(L)]
    _, got = _both(run, TOL[np.float32])
    rng = np.random.RandomState(0)
    A = rng.randn(3, 4, 4).astype(np.float32)
    spd = A @ A.transpose(0, 2, 1) + 4 * np.eye(4, dtype=np.float32)
    np.testing.assert_allclose(got[0] @ got[0].transpose(0, 2, 1), spd,
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got[1], np.linalg.inv(spd), rtol=1e-2,
                               atol=1e-3)


def test_linalg_gemm_trsm_syrk():
    def run(mx):
        rng = np.random.RandomState(1)
        A = rng.randn(2, 3, 3).astype(np.float32)
        B = rng.randn(2, 3, 3).astype(np.float32)
        C = rng.randn(2, 3, 3).astype(np.float32)
        L = np.tril(rng.randn(3, 3).astype(np.float32)) + 3 * np.eye(
            3, dtype=np.float32)
        return [mx.nd.linalg_gemm(mx.nd.array(A), mx.nd.array(B),
                                  mx.nd.array(C), alpha=2.0, beta=0.5),
                mx.nd.linalg_trsm(mx.nd.array(L[None]), mx.nd.array(B[:1])),
                mx.nd.linalg_trsm(mx.nd.array(L[None]), mx.nd.array(B[:1]),
                                  rightside=True),
                mx.nd.linalg_syrk(mx.nd.array(A))]
    _, got = _both(run, TOL[np.float32])
    rng = np.random.RandomState(1)
    A, B = rng.randn(2, 3, 3), rng.randn(2, 3, 3)
    rng.randn(2, 3, 3)
    L = np.tril(rng.randn(3, 3)) + 3 * np.eye(3)
    np.testing.assert_allclose(L @ got[1][0], B[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[2][0] @ L, B[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[3], A @ A.transpose(0, 2, 1), rtol=1e-5,
                               atol=1e-5)


def test_linalg_gelqf_syevd_det():
    def run(mx):
        rng = np.random.RandomState(2)
        A = rng.randn(2, 3, 5).astype(np.float32)
        L, Q = mx.nd.linalg_gelqf(mx.nd.array(A))
        S = rng.randn(4, 4).astype(np.float32)
        S = (S + S.T) / 2
        U, w = mx.nd.linalg_syevd(mx.nd.array(S[None]))
        U = U.asnumpy()
        # a sign a row: the reference's
        return [L, Q, U * np.sign(U[..., :1]), w,
                mx.nd.linalg_det(mx.nd.array(S[None]))]
    _, got = _both(run, TOL[np.float32])
    rng = np.random.RandomState(2)
    A = rng.randn(2, 3, 5).astype(np.float32)
    np.testing.assert_allclose(got[0] @ got[1], A, rtol=1e-4, atol=1e-4)
    S = rng.randn(4, 4).astype(np.float32)
    S = (S + S.T) / 2
    np.testing.assert_allclose(np.sort(got[3][0]), np.linalg.eigvalsh(S),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[4], np.linalg.det(S)[None], rtol=1e-3)
