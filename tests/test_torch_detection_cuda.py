"""The box and detection ops of mxnet_tpu_torch (``ops/contrib.py``) on the
card (marked ``cuda``; skipped without one).  This file imports no JAX, so
it runs on the GPU host:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_detection_cuda.py

Each op runs on the card and on the CPU of the card's host from the same
seeded inputs, in float64, where the two devices compute the same
arithmetic: integer, index and keep outputs equal, floats within 1e-10 of
the larger of 1 and their largest magnitude (``ROIAlign``'s data gradient
too).  The greedy NMS synchronizes the host once a call on the card, and
nothing launches the port's hand kernels (B1-B10): the reference's box
ops reach no ``pallas_call``.  ``chip_smoke.py`` phase 29 holds the same
ops at the published sizes, in float32 too.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import contrib, fused_optimizer, generated_kernels
from mxnet_tpu_torch.ops import pallas_kernels

pytestmark = pytest.mark.cuda
COUNTERS = (fused_optimizer, pallas_kernels, generated_kernels)
TOL = 1e-10


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for m in COUNTERS:
        m.reset_launch_counts()
    contrib.reset_host_sync_counts()
    yield
    assert not {k: v for m in COUNTERS for k, v in
                m.launch_counts().items() if v}


def _both(fn, arrays):
    """``fn`` on float64 copies of ``arrays`` on the card and on the CPU:
    (card outputs, CPU outputs) as numpy."""
    out = []
    for dev in ("cuda", "cpu"):
        res = fn(*[torch.tensor(a, dtype=torch.float64, device=dev)
                   for a in arrays])
        res = res if isinstance(res, (tuple, list)) else (res,)
        out.append([r.detach().cpu().numpy() for r in res])
    return out


def _held(card, host, exact=(), cols=None):
    """Floats within TOL; the outputs in ``exact`` equal (their first
    ``cols`` columns only, where given: a detection row's class and
    score)."""
    for i, (c, h) in enumerate(zip(card, host)):
        assert c.shape == h.shape
        if i in exact:
            np.testing.assert_array_equal(c[..., :cols], h[..., :cols])
        scale = max(1.0, float(np.abs(h).max(initial=0.0)))
        np.testing.assert_allclose(c, h, rtol=0, atol=TOL * scale)


def _anchors(side=8):
    return contrib.multibox_prior(torch.zeros(1, 1, side, side),
                                  sizes=(0.3, 0.6),
                                  ratios=(1, 2, 0.5)).numpy()


def _labels(rng, B=4, M=5):
    lab = np.full((B, M, 5), -1.0)
    for b in range(B):
        for m in range(1 + b % M):
            x0, y0 = rng.uniform(0, 0.6, 2)
            lab[b, m] = [rng.randint(3), x0, y0, x0 + rng.uniform(0.1, 0.4),
                         y0 + rng.uniform(0.1, 0.4)]
    return lab


def test_multibox_family_on_the_card(card):
    rng = np.random.RandomState(0)
    anc = _anchors()
    N = anc.shape[1]
    lab = _labels(rng)
    cls = rng.randn(4, 4, N)
    c, h = _both(lambda a, b, p: contrib.multibox_target(
        a, b, p, negative_mining_ratio=3.0), [anc, lab, cls])
    _held(c, h, exact=(1, 2))
    prob = np.exp(cls) / np.exp(cls).sum(1, keepdims=True)
    loc = rng.randn(4, N * 4) * 0.3
    c, h = _both(lambda p, lo, a: contrib.multibox_detection(
        p, lo, a, nms_threshold=0.45, threshold=0.05, nms_topk=100),
        [prob, loc, anc])
    _held(c, h, exact=(0,), cols=2)
    assert contrib.host_sync_counts() == {"MultiBoxDetection": 1}
    c, h = _both(lambda x: contrib.multibox_prior(x, sizes=(0.2, 0.4),
                                                  ratios=(1, 3)),
                 [np.zeros((1, 2, 5, 7))])
    _held(c, h)


def test_box_ops_on_the_card(card):
    rng = np.random.RandomState(1)
    rows = np.concatenate([rng.randint(0, 3, (3, 60, 1)), rng.rand(3, 60, 1),
                           rng.rand(3, 60, 2) * 0.5,
                           rng.rand(3, 60, 2) * 0.5 + 0.5], -1)
    for kw in (dict(id_index=0), dict(force_suppress=True, topk=20),
               dict(id_index=0, background_id=1, in_format="center")):
        c, h = _both(lambda d: contrib.box_nms(
            d, overlap_thresh=0.3, coord_start=2, score_index=1, **kw),
            [rows])
        _held(c, h, exact=(0,))
    c, h = _both(lambda a, b: contrib.box_iou(a, b),
                 [rows[0, :, 2:], rows[1, :9, 2:]])
    _held(c, h)
    c, h = _both(lambda s: contrib.bipartite_matching(s, threshold=0.1),
                 [rng.rand(4, 12, 7)])
    _held(c, h, exact=(0, 1))


def test_proposal_and_roi_align_on_the_card(card):
    rng = np.random.RandomState(2)
    cls = rng.rand(2, 6, 10, 12)
    box = rng.randn(2, 12, 10, 12) * 0.2
    info = np.array([[160, 190, 1.0], [150, 170, 1.5]])
    c, h = _both(lambda a, b, i: contrib.proposal(
        a, b, i, scales=(2, 4, 8), ratios=(1,), feature_stride=16,
        rpn_pre_nms_top_n=200, rpn_post_nms_top_n=40, rpn_min_size=4,
        output_score=True), [cls, box, info])
    _held(c, h, exact=(1,))
    rois = np.array([[0, 3, 4, 90, 100], [1, -8, 10, 150, 60],
                     [0, 40, 40, 41, 41]])
    data = rng.randn(2, 5, 12, 14)
    for aligned in (False, True):
        got = []
        for dev in ("cuda", "cpu"):
            d = torch.tensor(data, device=dev, requires_grad=True)
            out = contrib.roi_align(d, torch.tensor(rois, device=dev,
                                                    dtype=d.dtype),
                                    pooled_size=(3, 4), spatial_scale=1 / 8,
                                    sample_ratio=2, aligned=aligned)
            (g,) = torch.autograd.grad(torch.cos(out).sum(), d)
            got.append([out.detach().cpu().numpy(), g.cpu().numpy()])
        _held(*got)
