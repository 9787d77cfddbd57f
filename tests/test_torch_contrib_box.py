"""The box and detection ops of mxnet_tpu_torch (``ops/contrib.py``) held
against mxnet_tpu on the CPU, on the same seeded inputs.

- Each of the 20 names (``box_iou``, ``box_nms``, ``bipartite_matching``,
  ``MultiBoxPrior`` / ``Target`` / ``Detection``, ``ROIAlign``,
  ``Proposal`` / ``MultiProposal``, every alias): float outputs within
  1e-6 of the larger of 1 and the reference's largest magnitude; the
  integer, index and keep outputs equal (bipartite matches, class ids,
  the targets' classes and masks, NMS rows kept or dropped, roi batch
  indices).
- Every case of the reference's own tests (``tests/test_contrib.py``'s
  box tests and negative mining, ``tests/test_contrib_proposal.py``'s
  ``TestProposal`` and ``TestBipartiteMatching``), run through both
  packages' ``nd.contrib``.
- The order rules the reference's results hang on: score ties in
  ``box_nms`` and ``Proposal`` (stable order), ``-inf`` ties at
  ``Proposal``'s top-k, two ground truths claiming one anchor in
  ``MultiBoxTarget`` (the last one wins, as the reference's scatter lets
  it), an image with no objects, the ``center`` formats, ``topk``,
  ``force_suppress`` and ``background_id``.
- ``ROIAlign``'s gradient with respect to the data and the rois within
  1e-5, both ``aligned`` values; ``MultiBoxPrior``'s is zero, in both.

The reference runs under ``jax.jit``, one program per op and parameter
set (its aliases share it), which costs less than its eager dispatch of
every ``vmap`` / ``fori_loop`` primitive; the cases share a handful of
shapes.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.ops import contrib as tcontrib
from mxnet_tpu_torch.ops import registry as treg

treg.load_all()
TOL = 1e-6
GRAD_TOL = 1e-5
# the 20 names, by the kind of op each names
KIND = {n: kind for kind, names in (
    ("box_iou", ("_contrib_box_iou",)),
    ("box_nms", ("_contrib_box_nms", "box_nms")),
    ("bipartite_matching", ("_contrib_bipartite_matching",
                            "bipartite_matching")),
    ("prior", ("_contrib_MultiBoxPrior", "MultiBoxPrior",
               "_contrib_multibox_prior")),
    ("target", ("_contrib_MultiBoxTarget", "MultiBoxTarget",
                "_contrib_multibox_target")),
    ("detection", ("_contrib_MultiBoxDetection", "MultiBoxDetection",
                   "_contrib_multibox_detection")),
    ("roi_align", ("_contrib_ROIAlign", "ROIAlign")),
    ("proposal", ("_contrib_Proposal", "Proposal", "_contrib_MultiProposal",
                  "MultiProposal"))) for n in names}
NAMES = tuple(KIND)
# which outputs of each op are exact (ints, indices, masks): output index
# -> None (the whole array) or a function picking the exact part
EXACT = {
    "box_iou": {}, "box_nms": {0: None}, "bipartite_matching": {0: None,
                                                                 1: None},
    "prior": {}, "target": {1: None, 2: None},
    "detection": {0: lambda a: a[..., :2]}, "roi_align": {},
    "proposal": {0: lambda a: a[:, 0], 1: None},
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


_JITTED = {}
# XLA's CPU backend at LLVM level 0: the same HLO, compiled in a third
# less time
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def ref_jit(fn, *args):
    """``fn`` on ``args`` compiled once per function and shapes."""
    key = (fn, tuple((a.shape, str(a.dtype)) for a in args))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(fn).lower(*args).compile(FAST_COMPILE)
    return _JITTED[key](*args)


_FNS = {}


def ref_call(name, inputs, **params):
    """The reference's op ``name`` on ``inputs`` under ``jax.jit`` (one
    program per op function, parameter set and shapes), as numpy."""
    fn = jreg.get(name).fn
    key = (fn, repr(sorted(params.items())))
    if key not in _FNS:
        _FNS[key] = lambda *a: fn(*a, **params)
    out = ref_jit(_FNS[key], *[jnp.asarray(x) for x in inputs])
    return [np.asarray(w) for w in _list(out)]


def run_both(name, inputs, **params):
    """(reference outputs, port outputs) of op ``name`` as numpy."""
    got = _list(treg.get(name).fn(*[torch.from_numpy(np.array(x))
                                    for x in inputs], **params))
    return ref_call(name, inputs, **params), [g.detach().numpy()
                                               for g in got]


def held(want, got, exact=None):
    """Float outputs at ``TOL`` of max(1, |want|); the exact parts equal."""
    exact = exact or {}
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.shape == w.shape and g.dtype == w.dtype, (i, g.shape,
                                                           w.shape)
        if i in exact:
            pick = exact[i] or (lambda a: a)
            np.testing.assert_array_equal(pick(g), pick(w))
        scale = max(1.0, float(np.abs(w).max(initial=0.0)))
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * scale)


def check(kind, name, inputs, **params):
    want, got = run_both(name, inputs, **params)
    held(want, got, EXACT[kind])
    return want, got


# -- seeded inputs -------------------------------------------------------
def _anchors(h=4, w=4, sizes=(0.5, 0.25), ratios=(1, 2, 0.5)):
    x = jnp.zeros((1, 3, h, w))
    return np.asarray(jreg.get("MultiBoxPrior").fn(x, sizes=sizes,
                                                   ratios=ratios))


def _labels(rng, B=3, M=4, empty=()):
    """(B, M, 5) ground truths padded with -1; image b has b % M + 1
    objects, none for the images in ``empty``."""
    lab = np.full((B, M, 5), -1.0, np.float32)
    for b in range(B):
        if b in empty:
            continue
        for m in range(b % M + 1):
            x0, y0 = rng.uniform(0, 0.6, 2)
            lab[b, m] = [rng.randint(3), x0, y0, x0 + rng.uniform(0.1, 0.4),
                         y0 + rng.uniform(0.1, 0.4)]
    return lab


def _det_rows(rng, B=2, N=40, classes=3, ties=False):
    """(B, N, 6) [id, score, x1, y1, x2, y2] rows."""
    rows = np.zeros((B, N, 6), np.float32)
    rows[..., 0] = rng.randint(0, classes, (B, N))
    rows[..., 1] = rng.rand(B, N)
    if ties:
        rows[..., 1] = np.round(rows[..., 1] * 4) / 4
    xy = rng.rand(B, N, 2) * 0.6
    rows[..., 2:4] = xy
    rows[..., 4:6] = xy + 0.1 + rng.rand(B, N, 2) * 0.3
    return rows


def _rpn(rng, B=2, A=3, H=5, W=6, ties=False):
    cls = rng.rand(B, 2 * A, H, W).astype(np.float32)
    if ties:
        cls = np.round(cls * 3) / 3
    bbox = ((rng.rand(B, 4 * A, H, W) - 0.5) * 0.4).astype(np.float32)
    info = np.array([[80, 90, 1.0], [70, 60, 1.5]][:B], np.float32)
    return cls, bbox, info


# -- the 20 names --------------------------------------------------------
def _cases():
    rng = np.random.RandomState(0)
    anc = _anchors()
    N = anc.shape[1]
    lab = _labels(rng)
    cp = rng.randn(3, 4, N).astype(np.float32)
    prob = rng.rand(3, 4, N).astype(np.float32)
    prob /= prob.sum(1, keepdims=True)
    loc = (rng.randn(3, N * 4) * 0.3).astype(np.float32)
    rows = _det_rows(rng)
    data = rng.randn(2, 3, 9, 11).astype(np.float32)
    rois = np.array([[0, 1, 1, 6, 5], [1, -2, 0.5, 12, 9],
                     [0, 3.3, 2.2, 3.5, 2.4]], np.float32)
    rpn = _rpn(rng)
    return {
        "box_iou": ([rows[0, :, 2:], rows[1, :7, 2:]], {}),
        "box_nms": ([rows], dict(overlap_thresh=0.3, coord_start=2,
                                 score_index=1, id_index=0)),
        "bipartite_matching": ([rng.rand(4, 6, 5).astype(np.float32)],
                               dict(threshold=0.2)),
        "prior": ([np.zeros((2, 3, 5, 6), np.float32)],
                  dict(sizes=(0.5, 0.25), ratios=(1, 2, 0.5), clip=True)),
        "target": ([anc, lab, cp], dict(negative_mining_ratio=3.0)),
        "detection": ([prob, loc, anc], dict(nms_threshold=0.45,
                                             threshold=0.1)),
        "roi_align": ([data, rois], dict(pooled_size=(3, 2),
                                         spatial_scale=0.9)),
        "proposal": (list(rpn), dict(scales=(2, 4, 8), ratios=(1,),
                                     feature_stride=16, rpn_pre_nms_top_n=40,
                                     rpn_post_nms_top_n=10, rpn_min_size=4,
                                     output_score=True)),
    }


CASES = _cases()


def test_the_twenty_names_are_registered_in_both():
    assert len(NAMES) == 20
    assert set(NAMES) <= set(treg.list_ops()) & set(jreg.list_ops())


@pytest.mark.parametrize("name", NAMES)
def test_each_name_matches_reference(name):
    kind = KIND[name]
    inputs, params = CASES[kind]
    check(kind, name, inputs, **params)


# -- the reference's own test cases, through both nd.contrib -------------
def _both_nd(op, inputs, **params):
    """The port's op through its ``nd.contrib``, the reference's through
    the registry function its ``nd.contrib`` calls (jitted)."""
    got = _list(getattr(tmx.nd.contrib, op)(
        *[tmx.nd.array(x, ctx="cpu") for x in inputs], **params))
    assert getattr(jmx.nd.contrib, op) is not None
    return ref_call("_contrib_" + op, inputs, **params), [g.asnumpy()
                                                           for g in got]


def _ref_case_inputs():
    """The inputs of tests/test_contrib.py:83-165,263-280 and
    tests/test_contrib_proposal.py's TestProposal / TestBipartiteMatching
    (op, kind, inputs, params)."""
    x = np.zeros((1, 3, 4, 4), np.float32)
    a1 = _anchors(sizes=(0.5, 0.25), ratios=(1,))
    label = np.full((1, 2, 5), -1.0, np.float32)
    label[0, 0] = [1, 0.1, 0.1, 0.4, 0.4]
    rows = np.array([[[0, 0.9, 0.1, 0.1, 0.5, 0.5],
                      [0, 0.8, 0.12, 0.12, 0.52, 0.52],
                      [1, 0.85, 0.11, 0.11, 0.51, 0.51],
                      [0, 0.7, 0.6, 0.6, 0.9, 0.9]]], np.float32)
    a2 = _anchors(2, 2, sizes=(0.4,), ratios=(1,))
    cls_prob = np.zeros((1, 2, 4), np.float32)
    cls_prob[0, 1] = [0.9, 0.2, 0.8, 0.1]
    cls_prob[0, 0] = 1 - cls_prob[0, 1]

    def prop_inputs(seed, n=1, a=3):
        rng = np.random.RandomState(seed)
        cls = rng.rand(n, 2 * a, 4, 4).astype(np.float32)
        bbox = ((rng.rand(n, 4 * a, 4, 4) - 0.5) * 0.2).astype(np.float32)
        info = np.tile(np.array([[64.0, 64.0, 1.0]], np.float32), (n, 1))
        return [cls, bbox, info]

    return [
        ("MultiBoxPrior", "prior", [x], dict(sizes=(0.5, 0.25),
                                             ratios=(1, 2, 0.5))),
        ("MultiBoxTarget", "target", [a1, label, np.zeros((1, 3, 32),
                                                          np.float32)], {}),
        ("box_nms", "box_nms", [rows], dict(overlap_thresh=0.5,
                                            coord_start=2, score_index=1,
                                            id_index=0)),
        ("box_nms", "box_nms", [rows], dict(overlap_thresh=0.5,
                                            coord_start=2, score_index=1,
                                            id_index=0,
                                            force_suppress=True)),
        ("box_iou", "box_iou", [np.array([[0, 0, 2, 2]], np.float32),
                                np.array([[1, 1, 3, 3], [4, 4, 5, 5]],
                                         np.float32)], {}),
        ("MultiBoxDetection", "detection",
         [cls_prob, np.zeros((1, 16), np.float32), a2],
         dict(nms_threshold=0.5, threshold=0.5)),
        ("MultiBoxTarget", "target",
         [a1, label, np.random.RandomState(0).randn(1, 3, 32).astype(
             np.float32)], dict(negative_mining_ratio=3.0, ignore_label=-1.0)),
        ("Proposal", "proposal", prop_inputs(0),
         dict(scales=(8,), ratios=(0.5, 1, 2), feature_stride=16,
              rpn_pre_nms_top_n=20, rpn_post_nms_top_n=6, rpn_min_size=4)),
        ("Proposal", "proposal", prop_inputs(1, a=1),
         dict(scales=(8,), ratios=(1,), feature_stride=16,
              rpn_pre_nms_top_n=10, rpn_post_nms_top_n=4, rpn_min_size=4,
              output_score=True)),
        ("MultiProposal", "proposal", prop_inputs(2, n=2, a=1),
         dict(scales=(8,), ratios=(1,), feature_stride=16,
              rpn_pre_nms_top_n=10, rpn_post_nms_top_n=4, rpn_min_size=4)),
        ("bipartite_matching", "bipartite_matching",
         [np.array([[0.5, 0.6], [0.1, 0.2], [0.3, 0.4]], np.float32)],
         dict(threshold=1e-12)),
        ("bipartite_matching", "bipartite_matching",
         [np.array([[0.9, 0.05], [0.04, 0.03]], np.float32)],
         dict(threshold=0.5)),
        ("bipartite_matching", "bipartite_matching",
         [np.array([[0.9, 0.1], [0.2, 0.8]], np.float32)],
         dict(is_ascend=True, threshold=0.5)),
        ("bipartite_matching", "bipartite_matching",
         [np.random.RandomState(3).rand(4, 3, 5).astype(np.float32)],
         dict(threshold=1e-12)),
    ]


REF_CASES = _ref_case_inputs()


@pytest.mark.parametrize("i", range(len(REF_CASES)))
def test_reference_test_cases_through_both_packages(i):
    op, kind, inputs, params = REF_CASES[i]
    want, got = _both_nd(op, inputs, **params)
    held(want, got, EXACT[kind])


def test_reference_test_assertions_hold_on_the_port():
    """A few of the reference tests' own assertions, on the port's
    outputs."""
    nd = tmx.nd
    _, _, (rows,), params = REF_CASES[2]
    out = nd.contrib.box_nms(nd.array(rows, ctx="cpu"), **params).asnumpy()
    assert out[0, 1, 1] == -1 and out[0, 2, 1] == pytest.approx(0.85)
    _, _, inputs, params = REF_CASES[10]
    row, col = nd.contrib.bipartite_matching(nd.array(inputs[0], ctx="cpu"),
                                             **params)
    np.testing.assert_array_equal(row.asnumpy(), [1, -1, 0])
    np.testing.assert_array_equal(col.asnumpy(), [2, 0])
    _, _, inputs, params = REF_CASES[8]
    _, scores = nd.contrib.Proposal(*[nd.array(x, ctx="cpu")
                                      for x in inputs], **params)
    s = scores.asnumpy()[:, 0]
    assert np.all(np.diff(s[s > 0]) <= 1e-6)


# -- the order rules -----------------------------------------------------
def test_box_nms_score_ties_keep_stable_order():
    rng = np.random.RandomState(1)
    rows = _det_rows(rng, ties=True)
    assert len(np.unique(rows[0, :, 1])) < rows.shape[1] // 4
    for p in (dict(overlap_thresh=0.3, coord_start=2, score_index=1,
                   id_index=0),
              dict(overlap_thresh=0.2, coord_start=2, score_index=1,
                   force_suppress=True)):
        want, got = check("box_nms", "box_nms", [rows], **p)
        assert (want[0][..., 1] == -1).any()


@pytest.mark.parametrize("params", [
    dict(topk=10, background_id=1, id_index=0),
    dict(force_suppress=True, id_index=0, in_format="center"),
    dict(valid_thresh=0.5, topk=5, id_index=0, background_id=2)])
def test_box_nms_options(params):
    rows = _det_rows(np.random.RandomState(2))
    check("box_nms", "_contrib_box_nms", [rows], overlap_thresh=0.3,
          coord_start=2, score_index=1, **params)


def test_box_iou_center_format():
    rows = _det_rows(np.random.RandomState(3))
    check("box_iou", "_contrib_box_iou", [rows[0, :, 2:], rows[1, :7, 2:]],
          format="center")


def test_proposal_score_ties_and_inf_ties():
    """Tied scores, and a min size that drops most boxes so their -inf
    scores tie at the top-k and fill the tail."""
    rng = np.random.RandomState(4)
    rpn = _rpn(rng, ties=True)
    p = dict(scales=(2, 4, 8), ratios=(1,), feature_stride=16,
             output_score=True)
    check("proposal", "Proposal", list(rpn), rpn_pre_nms_top_n=40,
          rpn_post_nms_top_n=10, rpn_min_size=4, **p)
    want, _ = check("proposal", "MultiProposal", list(rpn),
                    rpn_pre_nms_top_n=40, rpn_post_nms_top_n=30,
                    rpn_min_size=40, threshold=0.5, **p)
    assert (want[1] == 0).any()       # rows with no box left


def test_multibox_target_two_truths_claim_one_anchor():
    """Ground truths 0 and 2 of an image are the same box: both claim one
    best anchor, and the last one's class wins, as in the reference."""
    rng = np.random.RandomState(5)
    anc = _anchors()
    lab = _labels(rng, B=2, M=3)
    lab[1, 2] = lab[1, 0]
    lab[1, 0, 0], lab[1, 2, 0] = 0, 2
    cp = rng.randn(2, 4, anc.shape[1]).astype(np.float32)
    want, got = check("target", "MultiBoxTarget", [anc, lab, cp],
                      negative_mining_ratio=3.0)
    (iou,) = ref_call("_contrib_box_iou", [anc[0], lab[1, :1, 1:]])
    best = int(iou[:, 0].argmax())
    assert want[2][1, best] == 3.0        # class 2 + 1: the last truth


def test_multibox_target_without_objects_and_options():
    rng = np.random.RandomState(6)
    anc = _anchors()
    lab = _labels(rng, B=3, M=4, empty=(1,))
    cp = rng.randn(3, 4, anc.shape[1]).astype(np.float32)
    for p in (dict(overlap_threshold=0.3, variances=(0.2, 0.2, 0.1, 0.1)),
              dict(negative_mining_ratio=2.0, minimum_negative_samples=5,
                   ignore_label=-2.0)):
        want, _ = check("target", "MultiBoxTarget", [anc, lab, cp], **p)
        assert not want[1][1].any()           # no positive in image 1


@pytest.mark.parametrize("params", [
    dict(nms_topk=20, force_suppress=True),
    dict(background_id=2, clip=False, threshold=0.2, nms_threshold=0.3)])
def test_multibox_detection_options(params):
    inputs, base = CASES["detection"]
    check("detection", "MultiBoxDetection", inputs, **dict(base, **params))


def test_bipartite_matching_options():
    s = np.random.RandomState(7).rand(2, 3, 6, 5).astype(np.float32)
    check("bipartite_matching", "bipartite_matching", [s], threshold=0.3,
          topk=3)
    check("bipartite_matching", "bipartite_matching", [s], threshold=0.6,
          is_ascend=True)


# -- gradients -----------------------------------------------------------
@pytest.mark.parametrize("aligned", [False, True])
def test_roi_align_gradient(aligned):
    """The gradient of sum(cos(out)) with respect to the data and the rois
    (the op sweep's scalarization)."""
    inputs, params = CASES["roi_align"]
    params = dict(params, aligned=aligned, sample_ratio=2)
    jop = jreg.get("ROIAlign").fn
    jg = ref_jit(jax.grad(lambda d, r: jnp.sum(jnp.cos(jop(d, r, **params))),
                          argnums=(0, 1)), *[jnp.asarray(x) for x in inputs])
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    out = tcontrib.roi_align(*ts, **params)
    tg = torch.autograd.grad(torch.cos(out).sum(), ts)
    for w, g in zip(jg, tg):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * scale)


def test_multibox_prior_gradient_is_zero():
    x = np.random.RandomState(8).randn(1, 2, 3, 3).astype(np.float32)
    jg = ref_jit(jax.grad(lambda d: jnp.sum(jreg.get("MultiBoxPrior").fn(
        d, sizes=(0.4,)))), jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad(
        tcontrib.multibox_prior(t, sizes=(0.4,)).sum(), t)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert not g.any()


def test_non_differentiable_ops_cut_the_graph():
    inputs, params = CASES["detection"]
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    assert not tcontrib.multibox_detection(*ts, **params).requires_grad
    inputs, params = CASES["target"]
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    assert not any(o.requires_grad
                   for o in tcontrib.multibox_target(*ts, **params))


def test_nms_counts_no_host_sync_on_the_cpu():
    tcontrib.reset_host_sync_counts()
    inputs, params = CASES["box_nms"]
    tcontrib.box_nms(torch.from_numpy(inputs[0]), **params)
    assert tcontrib.host_sync_counts() == {}
