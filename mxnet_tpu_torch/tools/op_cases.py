"""The op set of the port on a device against the CPU, and the samplers
against their laws: the case table and the checks ``chip_smoke.py``
phase 24 runs on the card (and ``tests/test_torch_random_cuda.py``
samples), at the sizes models give these ops.

    python -m mxnet_tpu_torch.tools.op_cases [--device cpu] [--draws N]

**Ops** (:data:`CASES`): every deterministic op that ``ops/init.py``,
``matrix.py``, ``indexing.py``, ``reduce.py``, ``elemwise.py``,
``nn.py`` and ``optimizer_ops.py`` gained with the seeded RNG (and the
repaired ``SoftmaxOutput``), one case per function, at a model's shapes
(``topk`` / ``sort`` over (256, 1000) logits, ``batch_dot`` at (256, 64,
64), ``LRN`` over AlexNet's conv1 output, ``ROIPooling`` 7 x 7 over a
VGG-16 conv5 map of a 600 x 800 image with 128 ROIs, ``Correlation`` at
FlowNet-C's setting, ``UpSampling`` x 2 over a ResNet stage-1 output
at batch 8...).
:func:`run_case` runs the op forward and, where it has float inputs to
differentiate, backward from a seeded head gradient, through
``test_utils.check_consistency`` on ``[device, cpu]``: index and integer
outputs exact, float outputs and gradients within :data:`REL_TOL` of the
largest magnitude of the CPU's.

**Samplers** (:func:`sampler_checks`): each sampler of ``nd.random`` and
each ``_sample_*`` op draws ``n`` values on the device; the sample's
mean and variance must lie within 6 standard errors of the law's, and a
Kolmogorov-Smirnov statistic against the law's CDF (continuous laws) or
a chi-squared statistic of the counts against its pmf (discrete laws,
bins of expected count under 5 pooled) under the alpha = 0.001 limit.
:func:`seed_checks`: ``mx.random.seed`` twice gives bitwise-equal draws,
a ``get_state`` / ``set_state`` round trip repeats them, and two
successive draws differ.
"""
from __future__ import annotations

import collections
import math
import sys
import time

import numpy as np
import torch

ALPHA = 1e-3
# the KS critical value sqrt(-ln(alpha / 2) / 2) at alpha = 0.001
KS_C = math.sqrt(-math.log(ALPHA / 2) / 2)
REL_TOL = 1e-5
SE_LIMIT = 6.0

Case = collections.namedtuple(
    "Case", "file name inputs params grads exact")


def _c(file, name, inputs, params=None, grads=(), exact=False):
    return Case(file, name, inputs, params or {}, tuple(grads), exact)


def _randn(*shape):
    return lambda rng: rng.randn(*shape).astype(np.float32)


def _distinct_nd(shape, m, rng):
    """(2, m) distinct index rows into ``shape`` (float32)."""
    flat = rng.choice(shape[0] * shape[1], m, replace=False)
    return np.stack([flat // shape[1], flat % shape[1]]).astype(np.float32)


def _rois(rng, n=128, w=800, h=600):
    x1 = rng.uniform(0, w - 64, n)
    y1 = rng.uniform(0, h - 64, n)
    x2 = np.minimum(x1 + rng.uniform(32, 400, n), w - 1)
    y2 = np.minimum(y1 + rng.uniform(32, 300, n), h - 1)
    return np.stack([np.zeros(n), x1, y1, x2, y2], 1).astype(np.float32)


def _nan_logits(rng):
    x = rng.randn(256, 1000).astype(np.float32)
    x[rng.rand(256, 1000) < 0.01] = np.nan
    return x


def _affine(rng, n=32):
    eye = np.tile([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], (n, 1))
    return (eye + 0.1 * rng.randn(n, 6)).astype(np.float32)


def _opt_arrays(n, positive=(), small=()):
    def gen(rng):
        xs = [rng.randn(2048, 1000).astype(np.float32) for _ in range(n)]
        for k in positive:
            xs[k] = np.abs(xs[k]) + 0.5
        for k in small:
            xs[k] *= 0.1
        return xs
    return gen


def _inputs(*gens):
    return lambda rng: [g(rng) for g in gens]


LOGITS = _randn(256, 1000)
LABELS = lambda rng: rng.randint(0, 1000, 256).astype(np.float32)  # noqa
SEQ = _randn(128, 64, 512)
SEQ_LEN = lambda rng: rng.randint(1, 129, 64).astype(np.float32)  # noqa

CASES = [
    # ops/init.py
    _c("init", "_zeros", _inputs(), {"shape": (256, 1000)}),
    _c("init", "_ones", _inputs(), {"shape": (256, 1000)}),
    _c("init", "_full", _inputs(), {"shape": (256, 1000), "value": 0.5}),
    _c("init", "_arange", _inputs(), {"start": 0, "stop": 50000,
                                      "step": 1, "repeat": 2}, exact=True),
    _c("init", "_linspace", _inputs(), {"start": 0.0, "stop": 1.0,
                                        "num": 100000}),
    _c("init", "_eye", _inputs(), {"N": 1024, "M": 1000, "k": 1}),
    _c("init", "_state_zeros_like", _inputs(_randn(256, 512)),
       {"shape": (0, 1024)}),
    # ops/matrix.py
    _c("matrix", "flip", _inputs(_randn(32, 3, 224, 224)), {"axis": 3},
       grads=(0,)),
    _c("matrix", "repeat", _inputs(LOGITS), {"repeats": 2, "axis": 1},
       grads=(0,)),
    _c("matrix", "stack", _inputs(LOGITS, LOGITS), {"axis": 1},
       grads=(0, 1)),
    _c("matrix", "slice_like", _inputs(_randn(8, 256, 57, 57),
                                       _randn(1, 1, 56, 56)),
       {"axes": (2, 3)}, grads=(0,)),
    _c("matrix", "broadcast_axis", _inputs(_randn(256, 1, 1000)),
       {"axis": 1, "size": 8}, grads=(0,)),
    _c("matrix", "batch_dot", _inputs(_randn(256, 64, 64),
                                      _randn(256, 64, 64)),
       {"transpose_b": True}, grads=(0, 1)),
    _c("matrix", "depth_to_space", _inputs(_randn(32, 256, 14, 14)),
       {"block_size": 2}, grads=(0,)),
    _c("matrix", "space_to_depth", _inputs(_randn(32, 64, 28, 28)),
       {"block_size": 2}, grads=(0,)),
    _c("matrix", "diag", _inputs(_randn(1000, 1000)), grads=(0,)),
    _c("matrix", "shape_array", _inputs(_randn(256, 3, 32, 32)),
       exact=True),
    _c("matrix", "size_array", _inputs(_randn(256, 3, 32, 32)), exact=True),
    _c("matrix", "_ravel_multi_index",
       _inputs(lambda rng: rng.randint(0, 1000, (2, 100000))
               .astype(np.float32)), {"shape": (1000, 1000)}, exact=True),
    _c("matrix", "_unravel_index",
       _inputs(lambda rng: rng.randint(0, 10 ** 6, 100000)
               .astype(np.float32)), {"shape": (1000, 1000)}, exact=True),
    _c("matrix", "_slice_assign", _inputs(LOGITS, _randn(128, 500)),
       {"begin": (0, 0), "end": (256, 1000), "step": (2, 2)},
       grads=(0, 1)),
    _c("matrix", "_slice_assign_scalar", _inputs(LOGITS),
       {"scalar": 3.0, "begin": (10,), "end": (200,)}, grads=(0,)),
    # ops/indexing.py and _getitem
    _c("indexing", "batch_take", _inputs(LOGITS, LABELS), grads=(0,)),
    _c("indexing", "gather_nd", _inputs(
        LOGITS, lambda rng: _distinct_nd((256, 1000), 4096, rng)),
       grads=(0,)),
    _c("indexing", "scatter_nd", _inputs(
        _randn(4096), lambda rng: _distinct_nd((256, 1000), 4096, rng)),
       {"shape": (256, 1000)}, grads=(0,)),
    _c("indexing", "_scatter_set_nd", _inputs(
        LOGITS, _randn(4096),
        lambda rng: _distinct_nd((256, 1000), 4096, rng)), grads=(0, 1)),
    _c("indexing", "SequenceMask", _inputs(SEQ, SEQ_LEN),
       {"use_sequence_length": True, "value": -1.0}, grads=(0,)),
    _c("indexing", "SequenceLast", _inputs(SEQ, SEQ_LEN),
       {"use_sequence_length": True}, grads=(0,)),
    _c("indexing", "SequenceReverse", _inputs(SEQ, SEQ_LEN),
       {"use_sequence_length": True}, grads=(0,)),
    _c("indexing", "_getitem", _inputs(LOGITS),
       {"_key": (slice(0, 128), slice(None, None, 2))}, grads=(0,)),
    # ops/reduce.py
    _c("reduce", "nansum", _inputs(_nan_logits), {"axis": 1}, grads=(0,)),
    _c("reduce", "nanprod", _inputs(
        lambda rng: (0.99 + 0.02 * rng.rand(256, 1000)).astype(np.float32)),
       {"axis": 1}, grads=(0,)),
    _c("reduce", "argmax_channel", _inputs(LOGITS), exact=True),
    _c("reduce", "topk", _inputs(LOGITS), {"k": 5, "ret_typ": "both"},
       exact=True),
    _c("reduce", "sort", _inputs(LOGITS), {"is_ascend": False},
       grads=(0,)),
    _c("reduce", "argsort", _inputs(LOGITS), exact=True),
    # ops/elemwise.py
    _c("elemwise", "_grad_add", _inputs(LOGITS, LOGITS), grads=(0, 1)),
    _c("elemwise", "_identity_with_attr_like_rhs", _inputs(LOGITS, LOGITS),
       grads=(0,)),
    _c("elemwise", "_scatter_plus_scalar", _inputs(LOGITS),
       {"scalar": 2.0}, grads=(0,)),
    _c("elemwise", "_scatter_minus_scalar", _inputs(LOGITS),
       {"scalar": 2.0}, grads=(0,)),
    _c("elemwise", "_scatter_elemwise_div", _inputs(
        LOGITS, lambda rng: (rng.rand(256, 1000) + 0.5).astype(np.float32)),
       grads=(0, 1)),
    # ops/nn.py
    _c("nn", "L2Normalization", _inputs(_randn(256, 2048)), grads=(0,)),
    _c("nn", "LRN", _inputs(_randn(32, 96, 55, 55)), {"nsize": 5},
       grads=(0,)),
    _c("nn", "SoftmaxActivation", _inputs(LOGITS), grads=(0,)),
    _c("nn", "SoftmaxOutput", _inputs(LOGITS, LABELS), grads=(0,)),
    _c("nn", "LinearRegressionOutput", _inputs(LOGITS, LOGITS),
       grads=(0,)),
    _c("nn", "MAERegressionOutput", _inputs(LOGITS, LOGITS), grads=(0,)),
    _c("nn", "LogisticRegressionOutput", _inputs(LOGITS, LOGITS),
       grads=(0,)),
    _c("nn", "MakeLoss", _inputs(LOGITS), grads=(0,)),
    _c("nn", "SVMOutput", _inputs(LOGITS, LABELS), grads=(0,)),
    _c("nn", "UpSampling", _inputs(_randn(8, 256, 56, 56)),
       {"scale": 2, "sample_type": "nearest"}, grads=(0,)),
    _c("nn", "UpSampling", _inputs(_randn(8, 256, 28, 28)),
       {"scale": 2, "sample_type": "bilinear"}, grads=(0,)),
    _c("nn", "Crop", _inputs(_randn(8, 256, 57, 57)),
       {"h_w": (56, 56), "offset": (1, 1)}, grads=(0,)),
    _c("nn", "GridGenerator", _inputs(_affine), {"target_shape": (224, 224)},
       grads=(0,)),
    _c("nn", "BilinearSampler", _inputs(
        _randn(32, 3, 224, 224),
        lambda rng: rng.uniform(-1.1, 1.1, (32, 2, 224, 224))
        .astype(np.float32)), grads=(0, 1)),
    _c("nn", "SpatialTransformer", _inputs(_randn(32, 3, 224, 224),
                                           _affine),
       {"target_shape": (224, 224)}, grads=(0, 1)),
    _c("nn", "ROIPooling", _inputs(_randn(1, 512, 38, 50), _rois),
       {"pooled_size": (7, 7), "spatial_scale": 1.0 / 16}, grads=(0,)),
    _c("nn", "Correlation", _inputs(_randn(8, 256, 48, 64),
                                    _randn(8, 256, 48, 64)),
       {"kernel_size": 1, "max_displacement": 20, "stride1": 1,
        "stride2": 2, "pad_size": 20}, grads=(0, 1)),
    # ops/optimizer_ops.py at a 2048 x 1000 weight (ResNet-50's fc)
    _c("optimizer_ops", "sgd_update", _opt_arrays(2),
       {"lr": 0.1, "wd": 1e-4, "clip_gradient": 0.5}),
    _c("optimizer_ops", "sgd_mom_update", _opt_arrays(3),
       {"lr": 0.1, "momentum": 0.9, "wd": 1e-4}),
    _c("optimizer_ops", "mp_sgd_update", _opt_arrays(3), {"lr": 0.1}),
    _c("optimizer_ops", "mp_sgd_mom_update", _opt_arrays(4),
       {"lr": 0.1, "momentum": 0.9}),
    _c("optimizer_ops", "signsgd_update", _opt_arrays(2), {"lr": 0.01}),
    _c("optimizer_ops", "signum_update", _opt_arrays(3),
       {"lr": 0.01, "momentum": 0.9, "wd_lh": 1e-3}),
    _c("optimizer_ops", "adam_update", _opt_arrays(4, positive=(3,)),
       {"lr": 0.001, "wd": 1e-4}),
    _c("optimizer_ops", "rmsprop_update", _opt_arrays(3, positive=(2,)),
       {"lr": 0.001}),
    _c("optimizer_ops", "rmspropalex_update",
       _opt_arrays(5, positive=(2,), small=(3,)), {"lr": 0.001}),
    _c("optimizer_ops", "ftrl_update", _opt_arrays(4, positive=(3,)),
       {"lr": 0.1}),
    _c("optimizer_ops", "ftml_update", _opt_arrays(5, positive=(3,)),
       {"lr": 0.01, "t": 3}),
]


def _host(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype.kind == "f" else a


def run_case(case, device, seed=24):
    """``case`` on ``[device, "cpu"]`` through ``check_consistency``:
    forward, and backward where the case differentiates.  Returns (the
    worst error of an output or gradient relative to its largest CPU
    magnitude, the number of arrays compared)."""
    from .. import autograd, nd
    from .. import test_utils as tu
    arrays = case.inputs(np.random.RandomState(seed))

    def fn(*xs):
        for k in case.grads:
            xs[k].attach_grad()
        with autograd.record():
            out = nd.imperative_invoke(case.name, *xs, **case.params)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        if not case.grads:
            return outs
        head = torch.randn(outs[0].shape,
                           generator=torch.Generator().manual_seed(seed))
        outs[0].backward(nd.array(head, ctx=outs[0].context))
        return outs[:1] + [xs[k].grad for k in case.grads] + outs[1:]

    try:
        if case.exact:
            res = tu.check_consistency(fn, arrays, ctx_list=["cpu", device],
                                       rtol=0, atol=0)
        else:
            res = tu.check_consistency(fn, arrays, ctx_list=["cpu", device],
                                       rtol=0, atol=REL_TOL, scale_atol=True)
    except AssertionError as e:
        raise AssertionError("%s (ops/%s.py) on %s against the CPU: %s"
                             % (case.name, case.file, device, e)) from None
    worst = 0.0
    for want, got in zip(*res):
        want, got = _host(want), _host(got)
        scale = np.abs(want[np.isfinite(want)]).max(initial=0.0) \
            if want.dtype.kind == "f" else np.abs(want).max(initial=0)
        diff = np.abs(got - want)
        diff = diff[np.isfinite(diff)] if diff.dtype.kind == "f" else diff
        err = float(diff.max(initial=0)) / max(float(scale), 1e-30)
        worst = max(worst, err)
    return worst, len(res[0])


def held_names(case_names):
    """Every registered name whose function one of ``case_names`` runs
    (the aliases of the cases' ops)."""
    from ..ops import registry
    registry.load_all()
    fns = {registry.get(n).fn for n in case_names}
    return sorted(n for n in registry.list_ops()
                  if registry.get(n).fn in fns)


# -- samplers -----------------------------------------------------------------
def _ks(x, cdf):
    """The Kolmogorov-Smirnov statistic of sample ``x`` (on its device,
    float64) against ``cdf``."""
    xs, _ = torch.sort(x.double().reshape(-1))
    n = xs.numel()
    f = cdf(xs)
    i = torch.arange(1, n + 1, device=xs.device, dtype=torch.float64)
    return float(torch.maximum((i / n - f).max(), (f - (i - 1) / n).max()))


def _chi2(x, log_pmf, n, first=0):
    """(statistic, degrees of freedom) of the counts of integer sample
    ``x`` against ``exp(log_pmf(k))`` over k >= ``first``, bins of
    expected count < 5 pooled into one."""
    x = x.reshape(-1).long()
    ks = torch.arange(first, int(x.max()) + 64, device=x.device,
                      dtype=torch.float64)
    obs = torch.bincount(x - first, minlength=ks.numel()).double()
    expect = torch.exp(log_pmf(ks)) * n
    keep = expect >= 5
    e_kept, o_kept = expect[keep], obs[keep]
    e_rest, o_rest = n - float(e_kept.sum()), n - float(o_kept.sum())
    stat = float(((o_kept - e_kept) ** 2 / e_kept).sum())
    bins = int(keep.sum())
    if e_rest >= 5 or o_rest > 0:
        stat += (o_rest - e_rest) ** 2 / max(e_rest, 1e-300)
        bins += 1
    return stat, bins - 1


def _chi2_limit(df):
    from scipy.stats import chi2
    return float(chi2.ppf(1 - ALPHA, df))


def _moments_ok(x, mean, var):
    """(mean and variance within SE_LIMIT standard errors, the two
    z-scores)."""
    x = x.double().reshape(-1)
    n = x.numel()
    m = float(x.mean())
    v = float(x.var(unbiased=False))
    m4 = float(((x - m) ** 4).mean())
    z_mean = (m - mean) / math.sqrt(var / n)
    z_var = (v - var) / math.sqrt(max(m4 - v * v, 1e-300) / n)
    return abs(z_mean) < SE_LIMIT and abs(z_var) < SE_LIMIT, z_mean, z_var


def _lgamma(t):
    return torch.lgamma(t)


def _nb_log_pmf(r, p):
    return lambda k: (_lgamma(k + r) - math.lgamma(r) - _lgamma(k + 1)
                      + r * math.log(p) + k * math.log1p(-p))


def _norm_cdf(loc, scale):
    return lambda x: 0.5 * (1 + torch.erf((x - loc) / (scale
                                                       * math.sqrt(2))))


# (label, draw(nd, n) -> NDArray of n values, law) with law one of
# ("cdf", cdf, mean, var) or ("pmf", log_pmf, mean, var[, first value])
def _samplers():
    def rnd(name, *args):
        return lambda ndm, n: getattr(ndm.random, name)(*args, shape=(n,))

    def elem(name, *params, row=0):
        def draw(ndm, n):
            arrs = [ndm.array(np.asarray(p, np.float32)) for p in params]
            return ndm.imperative_invoke(name, *arrs, shape=(n,))[row]
        return draw

    r_gnb, mu_gnb = 1 / 0.5, 2.0
    out = [
        ("uniform", rnd("uniform", -1.0, 2.0),
         ("cdf", lambda x: (x + 1.0) / 3.0, 0.5, 9.0 / 12)),
        ("normal", rnd("normal", 0.5, 2.0),
         ("cdf", _norm_cdf(0.5, 2.0), 0.5, 4.0)),
        ("gamma", rnd("gamma", 2.5, 1.5),
         ("cdf", lambda x: torch.special.gammainc(
             torch.full_like(x, 2.5), x / 1.5), 3.75, 2.5 * 2.25)),
        ("exponential", rnd("exponential", 3.0),
         ("cdf", lambda x: 1 - torch.exp(-3.0 * x), 1 / 3.0, 1 / 9.0)),
        ("poisson", rnd("poisson", 4.0),
         ("pmf", lambda k: k * math.log(4.0) - 4.0 - _lgamma(k + 1), 4.0,
          4.0)),
        ("negative_binomial", rnd("negative_binomial", 3, 0.4),
         ("pmf", _nb_log_pmf(3.0, 0.4), 3 * 0.6 / 0.4, 3 * 0.6 / 0.16)),
        ("generalized_negative_binomial",
         rnd("generalized_negative_binomial", mu_gnb, 0.5),
         ("pmf", _nb_log_pmf(r_gnb, r_gnb / (r_gnb + mu_gnb)), mu_gnb,
          mu_gnb + 0.5 * mu_gnb ** 2)),
        ("randint", rnd("randint", -3, 7),
         ("pmf", _uniform_log_pmf(-3, 7), 1.5, (100 - 1) / 12.0, -3)),
        ("_sample_uniform", elem("_sample_uniform", [0.0, -2.0],
                                 [1.0, 3.0], row=1),
         ("cdf", lambda x: (x + 2.0) / 5.0, 0.5, 25.0 / 12)),
        ("_sample_normal", elem("_sample_normal", [0.0, 5.0], [1.0, 0.5],
                                row=1),
         ("cdf", _norm_cdf(5.0, 0.5), 5.0, 0.25)),
        ("_sample_gamma", elem("_sample_gamma", [2.0, 0.7], [1.0, 3.0],
                               row=1),
         ("cdf", lambda x: torch.special.gammainc(
             torch.full_like(x, 0.7), x / 3.0), 2.1, 0.7 * 9.0)),
        ("_sample_exponential", elem("_sample_exponential", [1.0, 10.0],
                                     row=1),
         ("cdf", lambda x: 1 - torch.exp(-10.0 * x), 0.1, 0.01)),
        ("_sample_poisson", elem("_sample_poisson", [1.0, 20.0], row=1),
         ("pmf", lambda k: k * math.log(20.0) - 20.0 - _lgamma(k + 1), 20.0,
          20.0)),
        ("_sample_negative_binomial", elem("_sample_negative_binomial",
                                           [5.0, 2.0], [0.5, 0.3], row=1),
         ("pmf", _nb_log_pmf(2.0, 0.3), 2 * 0.7 / 0.3, 2 * 0.7 / 0.09)),
        ("_sample_generalized_negative_binomial",
         elem("_sample_generalized_negative_binomial", [2.0, 6.0],
              [0.5, 0.2], row=1),
         ("pmf", _nb_log_pmf(5.0, 5.0 / 11.0), 6.0, 6.0 + 0.2 * 36.0)),
    ]
    probs = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    out.append(("multinomial", lambda ndm, n: ndm.random.multinomial(
        ndm.array(probs), shape=n),
        ("pmf", _table_log_pmf(probs), 2.0, 1.0)))
    return out


def _uniform_log_pmf(lo, hi):
    return lambda k: torch.where((k >= lo) & (k < hi),
                                 torch.full_like(k, -math.log(hi - lo)),
                                 torch.full_like(k, -math.inf))


def _table_log_pmf(probs):
    def log_pmf(k):
        table = torch.log(torch.from_numpy(probs.astype(np.float64))
                          .to(k.device))
        inside = (k >= 0) & (k < len(probs))
        idx = k.clamp(0, len(probs) - 1).long()
        return torch.where(inside, table[idx], torch.full_like(k, -math.inf))
    return log_pmf


def sampler_checks(device, n=1 << 24, seed=24):
    """Every sampler's ``n`` draws on ``device`` against its law; returns
    one row per sampler and raises if any check fails."""
    from .. import context, nd
    from .. import random as mxr
    rows, bad = [], []
    with context.use(device):
        mxr.seed(seed)
        for label, draw, law in _samplers():
            x = draw(nd, n)._data
            if x.device.type != torch.device(device).type:
                bad.append("%s drew on %s" % (label, x.device))
            kind, fn, mean, var = law[:4]
            ok, zm, zv = _moments_ok(x, mean, var)
            if kind == "cdf":
                stat = _ks(x, fn)
                limit = KS_C / math.sqrt(x.numel())
            else:
                stat, df = _chi2(x, fn, x.numel(), *law[4:])
                limit = _chi2_limit(df)
            row = dict(sampler=label, n=x.numel(), z_mean=round(zm, 3),
                       z_var=round(zv, 3),
                       test="ks" if kind == "cdf" else "chi2",
                       stat=stat, limit=limit)
            rows.append(row)
            if not ok or not stat < limit:
                bad.append("%s: %s" % (label, row))
        x = nd.random.shuffle(nd.arange(n, dtype="int64"))._data
        if not torch.equal(torch.sort(x).values,
                           torch.arange(n, device=x.device)):
            bad.append("shuffle is not a permutation")
        rows.append(dict(sampler="shuffle", n=n, permutation=not bad))
    if bad:
        raise RuntimeError("samplers off their laws: %s" % bad)
    return rows


def seed_checks(device):
    """Seed, state and succession checks on ``device`` (raises)."""
    from .. import _rng, context, nd
    from .. import random as mxr
    with context.use(device):
        def draw():
            return [nd.random.uniform(shape=(4096,))._data.clone(),
                    nd.random.normal(shape=(4096,))._data.clone(),
                    nd.random.poisson(3.0, shape=(4096,))._data.clone()]

        mxr.seed(7)
        a, b = draw(), draw()
        mxr.seed(7)
        a2 = draw()
        state = _rng.get_state()
        c = draw()
        _rng.set_state(state)
        c2 = draw()
    same = all(torch.equal(x, y) for x, y in zip(a, a2))
    resumed = all(torch.equal(x, y) for x, y in zip(c, c2))
    differ = not torch.equal(a[0], b[0])
    if not (same and resumed and differ):
        raise RuntimeError("seed checks: reseeded bitwise %s, state round "
                           "trip bitwise %s, successive draws differ %s"
                           % (same, resumed, differ))
    return dict(reseeded_bitwise=same, state_round_trip_bitwise=resumed,
                successive_differ=differ)


def draw_ms(device, n=1 << 24, iters=10):
    """ms per ``n`` uniform and per ``n`` normal draws on ``device``."""
    from .. import _rng
    gen = _rng.next_generator(device)
    out = {}
    for label, fill in (("uniform", lambda t: t.uniform_(generator=gen)),
                        ("normal", lambda t: t.normal_(generator=gen))):
        t = torch.empty(n, device=device)
        fill(t)
        if torch.device(device).type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fill(t)
            end.record()
            torch.cuda.synchronize()
            out[label] = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fill(t)
            out[label] = (time.perf_counter() - t0) * 1e3 / iters
    return out


def main(argv=None):
    import argparse
    import json
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="the device held against the CPU (default: cuda)")
    p.add_argument("--draws", type=int, default=1 << 24)
    args = p.parse_args(argv)
    from ..base import resolve_device
    dev = str(resolve_device(args.device))
    for case in CASES:
        worst, n = run_case(case, dev)
        print(json.dumps(dict(file=case.file, op=case.name, arrays=n,
                              worst_rel_err=worst)))
    for row in sampler_checks(dev, args.draws):
        print(json.dumps(row))
    print(json.dumps(seed_checks(dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
