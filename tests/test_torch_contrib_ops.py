"""The rest of ``ops/contrib.py`` of mxnet_tpu_torch (adaptive pooling,
the bilinear resize, count sketch, the FFTs, Khatri-Rao, deformable
convolution, deformable and plain PS RoI pooling, ``div_sqrt_dim``,
``quadratic``, ``IdentityAttachKLSparseReg``: 21 names with their
aliases) held against mxnet_tpu on the CPU, on the same seeded numpy
inputs.

- Each case: the forward and the gradient of ``sum(out * ct)`` (``ct``
  seeded cotangents) with respect to every float input, in float32 and
  float64 (the reference under ``jax.enable_x64``, compiled once a case
  by ``jax.jit`` at XLA's LLVM level 0): float32 within 1e-5,
  float64 within 1e-10, of the larger of 1 and the reference's largest
  magnitude (the deformable GEMMs and pooled means sum in another order
  than XLA's).  The deformable ops take zero, shifted and random offsets,
  groups, deformable groups, dilation, stride and bias; deformable PS RoI
  pooling runs with ``trans`` at a small R-FCN-like shape.
- Every case of ``tests/test_contrib.py`` and
  ``tests/test_contrib_proposal.py`` that touches these names, through
  both packages.
- ROADMAP.md C12: ``BilinearResize2D`` samples at half pixels and
  antialiases where it shrinks in both packages (upstream MXNet aligns
  the corners); C14: ``IdentityAttachKLSparseReg``'s gradient takes the
  batch's mean activation alone in both packages (``momentum`` changes
  nothing and no moving average is kept; upstream MXNet keeps one).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.ops import registry as treg
from test_torch_linalg_cf import TOL, _within, ref_jit

treg.load_all()

NAMES = {"AdaptiveAvgPooling2D", "BilinearResize2D", "DeformableConvolution",
         "DeformablePSROIPooling", "IdentityAttachKLSparseReg",
         "PSROIPooling", "_contrib_AdaptiveAvgPooling2D",
         "_contrib_BilinearResize2D", "_contrib_DeformableConvolution",
         "_contrib_DeformablePSROIPooling", "_contrib_PSROIPooling",
         "_contrib_count_sketch", "_contrib_div_sqrt_dim", "_contrib_fft",
         "_contrib_ifft", "_contrib_quadratic", "count_sketch", "fft",
         "ifft", "khatri_rao", "quadratic"}


def _rois(r, n, batch, side_h, side_w):
    """``n`` RoIs [batch index, x1, y1, x2, y2] in image pixels."""
    x1 = r.uniform(0, side_w * 0.6, n)
    y1 = r.uniform(0, side_h * 0.6, n)
    w = r.uniform(side_w * 0.1, side_w * 0.5, n)
    h = r.uniform(side_h * 0.1, side_h * 0.5, n)
    return np.stack([r.randint(0, batch, n), x1, y1, x1 + w, y1 + h], 1)


# case -> (op name, inputs(rng), params, indices of the float inputs to
# differentiate)
CASES = {
    "adaptive-6to3": ("_contrib_AdaptiveAvgPooling2D",
                      lambda r: [r.randn(2, 3, 6, 6)], dict(output_size=3),
                      (0,)),
    "adaptive-7to3x2": ("AdaptiveAvgPooling2D",
                        lambda r: [r.randn(1, 2, 7, 5)],
                        dict(output_size=(3, 2)), (0,)),
    "resize-up": ("_contrib_BilinearResize2D",
                  lambda r: [r.randn(1, 2, 4, 5)],
                  dict(height=8, width=11), (0,)),
    "resize-down": ("BilinearResize2D", lambda r: [r.randn(2, 3, 17, 23)],
                    dict(height=9, width=11), (0,)),
    "resize-mixed": ("BilinearResize2D", lambda r: [r.randn(1, 2, 17, 23)],
                     dict(height=40, width=10), (0,)),
    "resize-scale": ("BilinearResize2D", lambda r: [r.randn(1, 2, 7, 9)],
                     dict(scale_height=1.5, scale_width=0.5), (0,)),
    "count_sketch": ("_contrib_count_sketch",
                     lambda r: [r.randn(3, 10), r.randint(0, 4, 10) * 1.0,
                                r.choice([-1.0, 1.0], 10)],
                     dict(out_dim=4), (0, 2)),
    "count_sketch-alias": ("count_sketch",
                           lambda r: [r.randn(2, 6),
                                      np.array([[0, 1, 0, 2, 2, 0]]) * 1.0,
                                      r.choice([-1.0, 1.0], (1, 6))],
                           dict(out_dim=3), (0, 2)),
    "fft": ("_contrib_fft", lambda r: [r.randn(3, 8)], {}, (0,)),
    "fft-alias": ("fft", lambda r: [r.randn(2, 2, 6)], {}, (0,)),
    "ifft": ("_contrib_ifft", lambda r: [r.randn(3, 16)], {}, (0,)),
    "ifft-alias": ("ifft", lambda r: [r.randn(2, 12)], {}, (0,)),
    "khatri_rao-2": ("khatri_rao", lambda r: [r.randn(2, 3), r.randn(4, 3)],
                     {}, (0, 1)),
    "khatri_rao-3": ("khatri_rao",
                     lambda r: [r.randn(2, 2), r.randn(3, 2), r.randn(2, 2)],
                     {}, (0, 1, 2)),
    "deform-zero": ("_contrib_DeformableConvolution",
                    lambda r: [r.randn(2, 4, 7, 7), np.zeros((2, 18, 5, 5)),
                               r.randn(6, 4, 3, 3)],
                    dict(kernel=(3, 3), num_filter=6, no_bias=True),
                    (0, 1, 2)),
    "deform-random": ("DeformableConvolution",
                      lambda r: [r.randn(2, 4, 9, 8),
                                 r.randn(2, 36, 4, 3) * 1.5,
                                 r.randn(6, 4, 3, 3), r.randn(6)],
                      dict(kernel=(3, 3), num_filter=6, stride=(2, 2),
                           pad=(1, 1), dilate=(2, 2),
                           num_deformable_group=2),
                      (0, 1, 2, 3)),
    "deform-groups": ("DeformableConvolution",
                      lambda r: [r.randn(1, 4, 7, 7),
                                 r.randn(1, 18, 7, 7) * 0.7,
                                 r.randn(4, 2, 3, 3), r.randn(4)],
                      dict(kernel=(3, 3), num_filter=4, num_group=2,
                           pad=(1, 1)),
                      (0, 1, 2, 3)),
    "deform-1x1-rect": ("DeformableConvolution",
                        lambda r: [r.randn(1, 2, 5, 6),
                                   r.randn(1, 12, 5, 4) * 2.0,
                                   r.randn(3, 2, 1, 3)],
                        dict(kernel=(1, 3), num_filter=3, no_bias=True,
                             num_deformable_group=2),
                        (0, 1, 2)),
    "dpsroi-trans": ("_contrib_DeformablePSROIPooling",
                     lambda r: [r.randn(2, 18, 12, 14),
                                _rois(r, 5, 2, 48, 56),
                                r.randn(5, 4, 3, 3)],
                     dict(spatial_scale=0.25, output_dim=2, group_size=3,
                          pooled_size=3, part_size=3, sample_per_part=2,
                          trans_std=0.1),
                     (0, 2)),
    "dpsroi-part": ("DeformablePSROIPooling",
                    lambda r: [r.randn(1, 32, 10, 9),
                               _rois(r, 4, 1, 40, 36),
                               r.randn(4, 2, 2, 2)],
                    dict(spatial_scale=0.25, output_dim=2, group_size=4,
                         pooled_size=4, part_size=2, sample_per_part=3,
                         trans_std=0.2),
                    (0, 2)),
    "dpsroi-notrans": ("DeformablePSROIPooling",
                       lambda r: [r.randn(1, 18, 8, 8),
                                  _rois(r, 3, 1, 32, 32)],
                       dict(spatial_scale=0.25, output_dim=2, group_size=3,
                            pooled_size=3, sample_per_part=2,
                            no_trans=True),
                       (0,)),
    "psroi": ("_contrib_PSROIPooling",
              lambda r: [r.randn(2, 18, 12, 14), _rois(r, 5, 2, 48, 56)],
              dict(spatial_scale=0.25, output_dim=2, pooled_size=3),
              (0,)),
    "psroi-alias": ("PSROIPooling",
                    lambda r: [r.randn(1, 8, 8, 8),
                               np.array([[0, 0, 0, 7, 7]], np.float64)],
                    dict(spatial_scale=1.0, output_dim=2, pooled_size=2),
                    (0,)),
    "div_sqrt_dim": ("_contrib_div_sqrt_dim", lambda r: [r.randn(2, 3, 12)],
                     {}, (0,)),
    "quadratic": ("_contrib_quadratic", lambda r: [r.randn(3, 4)],
                  dict(a=1.5, b=-2.0, c=0.5), (0,)),
    "quadratic-alias": ("quadratic", lambda r: [r.randn(5)],
                        dict(a=-0.5), (0,)),
    "kl-sparse": ("IdentityAttachKLSparseReg",
                  lambda r: [r.rand(16, 5) * 0.9 + 0.05],
                  dict(sparseness_target=0.05, penalty=0.05), (0,)),
    "kl-sparse-clip": ("IdentityAttachKLSparseReg",
                       lambda r: [np.concatenate([np.zeros((4, 2)),
                                                  np.ones((4, 1)),
                                                  r.rand(4, 2)], 1)],
                       dict(), (0,)),
}


def test_cases_cover_every_name():
    assert len(NAMES) == 21
    assert NAMES <= set(jreg.list_ops()) and NAMES <= set(treg.list_ops())
    assert {c[0] for c in CASES.values()} | {
        "_contrib_DeformableConvolution", "_contrib_count_sketch",
        "_contrib_fft", "_contrib_ifft", "count_sketch", "fft", "ifft",
        "_contrib_quadratic", "_contrib_BilinearResize2D",
        "_contrib_AdaptiveAvgPooling2D"} >= NAMES


def _case_both(key, dtype):
    """(reference outputs, port outputs, reference grads, port grads)."""
    name, make, params, diff = CASES[key]
    xs = [np.asarray(x, np.float64).astype(dtype)
          for x in make(np.random.RandomState(0))]
    jop, top = jreg.get(name), treg.get(name)
    with jax.enable_x64(dtype == np.float64):
        ja = [jnp.asarray(x) for x in xs]
        shape = jax.eval_shape(lambda *a: jop.fn(*a, **params), *ja).shape
        ct = np.random.RandomState(1).randn(*shape).astype(dtype)

        def run(*a):
            def scalar(*d):
                b = list(a)
                for i, v in zip(diff, d):
                    b[i] = v
                out = jop.fn(*b, **params)
                return jnp.sum(out * ct), out
            grads, out = jax.grad(scalar, argnums=tuple(range(len(diff))),
                                  has_aux=True)(*[a[i] for i in diff])
            return out, grads
        out, grads = ref_jit(run, *ja)
        want = np.asarray(out)
        want_g = [np.asarray(g) for g in grads]
    ta = [torch.from_numpy(x.copy()) for x in xs]
    for i in diff:
        ta[i].requires_grad_(True)
    out = top.fn(*ta, **params)
    (out * torch.from_numpy(ct)).sum().backward()
    got_g = [np.zeros_like(xs[i]) if ta[i].grad is None
             else ta[i].grad.numpy() for i in diff]
    return want, out.detach().numpy(), want_g, got_g


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("key", sorted(CASES))
def test_contrib_op_forward_and_gradient(key, dtype):
    want, got, want_g, got_g = _case_both(key, dtype)
    assert got.dtype == want.dtype
    _within(got, want, TOL[dtype])
    for w, g in zip(want_g, got_g):
        _within(g, w, TOL[dtype])


def test_dpsroi_gathers_the_reference_samples_at_rfcn_like_scale():
    """A larger class map (8 classes x 3 x 3 = 72 channels) and 12 RoIs
    with trans: the per-channel gather equals the reference's gather of
    every channel, forward and data / trans gradients."""
    rng = np.random.RandomState(9)
    x = rng.randn(1, 72, 16, 20).astype(np.float32)
    rois = _rois(rng, 12, 1, 256, 320).astype(np.float32)
    tr = rng.randn(12, 2, 3, 3).astype(np.float32)
    kw = dict(spatial_scale=1 / 16, output_dim=8, group_size=3,
              pooled_size=3, part_size=3, sample_per_part=4, trans_std=0.1)
    ct = rng.randn(12, 8, 3, 3).astype(np.float32)
    jop = jreg.get("DeformablePSROIPooling").fn

    def run(a, r, t):
        return jax.grad(lambda a, t: jnp.sum(jop(a, r, t, **kw) * ct),
                        argnums=(0, 1))(a, t), jop(a, r, t, **kw)
    jg, want = ref_jit(run, jnp.asarray(x), jnp.asarray(rois),
                       jnp.asarray(tr))
    want = np.asarray(want)
    tx, tt = (torch.from_numpy(a).requires_grad_(True) for a in (x, tr))
    got = treg.get("DeformablePSROIPooling").fn(tx, torch.from_numpy(rois),
                                                tt, **kw)
    (got * torch.from_numpy(ct)).sum().backward()
    _within(got.detach().numpy(), want, TOL[np.float32])
    _within(tx.grad.numpy(), np.asarray(jg[0]), TOL[np.float32])
    _within(tt.grad.numpy(), np.asarray(jg[1]), TOL[np.float32])


def test_shapes_on_the_meta_device():
    """Shape inference runs the op on meta tensors."""
    for key in ("resize-down", "deform-random", "dpsroi-trans", "psroi"):
        name, make, params, _ = CASES[key]
        xs = make(np.random.RandomState(0))
        meta = treg.get(name).fn(*[torch.empty(np.shape(x), device="meta")
                                   for x in xs], **params)
        real = treg.get(name).fn(*[torch.from_numpy(np.asarray(x))
                                   for x in xs], **params)
        assert meta.shape == real.shape, key


# -- ROADMAP.md C12 and C14 ----------------------------------------------
def test_bilinear_resize_is_half_pixel_and_antialiased_in_both():
    """C12: both packages resize as ``F.interpolate(align_corners=False,
    antialias=True)`` does; upstream MXNet's op aligns the corners."""
    x = np.random.RandomState(10).randn(2, 3, 17, 23).astype(np.float32)
    for h, w in ((34, 46), (9, 11), (40, 10)):
        want = np.asarray(jreg.get("BilinearResize2D").fn(
            jnp.asarray(x), height=h, width=w))
        got = treg.get("BilinearResize2D").fn(torch.from_numpy(x), height=h,
                                              width=w).numpy()
        plain = F.interpolate(torch.from_numpy(x), size=(h, w),
                              mode="bilinear", align_corners=False,
                              antialias=True).numpy()
        corners = F.interpolate(torch.from_numpy(x), size=(h, w),
                                mode="bilinear", align_corners=True).numpy()
        _within(want, plain, 1e-6)
        _within(got, plain, 1e-6)
        assert np.abs(want - corners).max() > 0.1


def test_kl_sparse_reg_keeps_no_moving_average_in_both():
    """C14: the added gradient is the batch's own KL term in both
    packages: ``momentum`` changes nothing, and a second call with another
    batch gives that batch's term (no state carried over)."""
    rng = np.random.RandomState(11)
    a, b = (rng.rand(8, 4).astype(np.float32) * 0.8 + 0.1 for _ in range(2))
    ct = np.ones((8, 4), np.float32)

    def term(x, rho=0.1, penalty=0.001):
        rh = np.clip(x.mean(0), 1e-6, 1 - 1e-6)
        return penalty * (-rho / rh + (1 - rho) / (1 - rh))

    for momentum in (0.0, 0.9, 0.99):
        for x in (a, b, a):
            jg = np.asarray(jax.grad(lambda v: jnp.sum(jreg.get(
                "IdentityAttachKLSparseReg").fn(
                    v, momentum=momentum) * ct))(jnp.asarray(x)))
            t = torch.from_numpy(x).requires_grad_(True)
            (treg.get("IdentityAttachKLSparseReg").fn(t, momentum=momentum)
             * torch.from_numpy(ct)).sum().backward()
            _within(jg, np.broadcast_to(1 + term(x), x.shape), 1e-6)
            _within(t.grad.numpy(), jg, 1e-6)


# -- the reference's own cases (tests/test_contrib.py) ---------------------
def _both(fn, tol=1e-5):
    want = fn(jmx)
    with use("cpu"):
        got = fn(tmx)
    _within(got, want, tol)
    return got


def _inv(mx, name, *args, **kwargs):
    return mx.nd.imperative_invoke(
        name, *[mx.nd.array(a) for a in args], **kwargs).asnumpy()


def test_deformable_conv_zero_offset_equals_conv():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 9, 9).astype(np.float32)
    w = rng.randn(6, 4, 3, 3).astype(np.float32)
    off = np.zeros((2, 18, 7, 7), np.float32)
    got = _both(lambda mx: _inv(mx, "_contrib_DeformableConvolution", x, off,
                                w, kernel=(3, 3), num_filter=6,
                                no_bias=True))
    with use("cpu"):
        ref = tmx.nd.Convolution(tmx.nd.array(x), tmx.nd.array(w),
                                 kernel=(3, 3), num_filter=6,
                                 no_bias=True).asnumpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_deformable_conv_shift_offset():
    """Constant offset (0, 1) equals sampling the input shifted."""
    rng = np.random.RandomState(1)
    x = rng.randn(1, 1, 8, 8).astype(np.float32)
    w = np.ones((1, 1, 1, 1), np.float32)
    off = np.zeros((1, 2, 8, 8), np.float32)
    off[:, 1] = 1.0
    got = _both(lambda mx: _inv(mx, "_contrib_DeformableConvolution", x, off,
                                w, kernel=(1, 1), num_filter=1,
                                no_bias=True))
    np.testing.assert_allclose(got[0, 0, :, :-1], x[0, 0, :, 1:], atol=1e-5)


def test_fft_ifft_roundtrip():
    x = np.random.RandomState(0).randn(3, 16).astype(np.float32)

    def run(mx):
        f = mx.nd.imperative_invoke("_contrib_fft", mx.nd.array(x))
        assert f.shape == (3, 32)
        return mx.nd.imperative_invoke("_contrib_ifft", f).asnumpy()
    got = _both(run)
    np.testing.assert_allclose(got, x, rtol=1e-4, atol=1e-5)


def test_adaptive_avg_pooling():
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    got = _both(lambda mx: _inv(mx, "_contrib_AdaptiveAvgPooling2D", x,
                                output_size=(2, 2)))
    np.testing.assert_allclose(got[0, 0], [[2.5, 4.5], [10.5, 12.5]])


def test_bilinear_resize():
    x = np.arange(4, dtype=np.float32).reshape(1, 1, 2, 2)
    got = _both(lambda mx: _inv(mx, "_contrib_BilinearResize2D", x, height=4,
                                width=4))
    assert got.shape == (1, 1, 4, 4)
    assert got[0, 0, 0, 0] == pytest.approx(0.0)


def test_khatri_rao():
    a = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    b = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    got = _both(lambda mx: _inv(mx, "khatri_rao", a, b))
    np.testing.assert_allclose(got, [[1, 0], [0, 2], [3, 0], [0, 4]])


def test_count_sketch():
    x = np.array([[1.0, 2.0, 3.0]], np.float32)
    h = np.array([0, 1, 0], np.float32)
    s = np.array([1, -1, 1], np.float32)
    got = _both(lambda mx: _inv(mx, "_contrib_count_sketch", x, h, s,
                                out_dim=2))
    np.testing.assert_allclose(got, [[4.0, -2.0]])


def test_deformable_conv_groups():
    rng = np.random.RandomState(0)
    x = rng.randn(1, 4, 7, 7).astype(np.float32)
    w = rng.randn(4, 2, 3, 3).astype(np.float32)
    off = np.zeros((1, 18, 5, 5), np.float32)
    got = _both(lambda mx: _inv(mx, "_contrib_DeformableConvolution", x, off,
                                w, kernel=(3, 3), num_filter=4, num_group=2,
                                no_bias=True))
    with use("cpu"):
        ref = tmx.nd.Convolution(tmx.nd.array(x), tmx.nd.array(w),
                                 kernel=(3, 3), num_filter=4, num_group=2,
                                 no_bias=True).asnumpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_symbolic_deformable_psroi_infers_shapes():
    """The Symbol front end composes the new ops (shape inference runs
    them on meta tensors); ``no_trans`` makes ``trans`` optional."""
    sym = tmx.sym
    data, rois = sym.Variable("data"), sym.Variable("rois")
    out = sym.contrib.DeformablePSROIPooling(
        data, rois, spatial_scale=0.0625, output_dim=21, group_size=7,
        pooled_size=7, no_trans=True)
    assert out.list_arguments() == ["data", "rois"]
    _, shapes, _ = out.infer_shape(data=(1, 1029, 38, 63), rois=(300, 5))
    assert shapes == [(300, 21, 7, 7)]
    conv = sym.contrib.DeformableConvolution(
        data, sym.Variable("offset"), kernel=(3, 3), num_filter=8,
        pad=(2, 2), dilate=(2, 2), num_deformable_group=4, name="dc")
    assert conv.list_arguments() == ["data", "offset", "dc_weight",
                                     "dc_bias"]
    # as in the reference, the weight's shape is not inferred
    assert conv.infer_shape(data=(1, 16, 10, 12),
                            offset=(1, 72, 10, 12)) == (None, None, None)
    _, shapes, _ = conv.infer_shape(data=(1, 16, 10, 12),
                                    offset=(1, 72, 10, 12),
                                    dc_weight=(8, 16, 3, 3), dc_bias=(8,))
    assert shapes == [(1, 8, 10, 12)]


# -- the reference's own cases (tests/test_contrib_proposal.py) ------------
def test_dpsroi_zero_trans_matches_psroi_average():
    rng = np.random.RandomState(4)
    D, G, P = 2, 2, 2
    data = rng.rand(1, D * G * G, 8, 8).astype(np.float32)
    rois = np.array([[0, 0, 0, 7, 7]], np.float32)
    trans = np.zeros((1, 2, P, P), np.float32)

    def run(mx):
        out = mx.nd.contrib.DeformablePSROIPooling(
            mx.nd.array(data), mx.nd.array(rois), mx.nd.array(trans),
            spatial_scale=1.0, output_dim=D, group_size=G, pooled_size=P,
            sample_per_part=2, trans_std=0.0)
        assert out.shape == (1, D, P, P)
        return out.asnumpy()
    assert np.isfinite(_both(run)).all()


def test_dpsroi_trans_shifts_sampling():
    rng = np.random.RandomState(5)
    D, G, P = 1, 1, 2
    data = rng.rand(1, 1, 12, 12).astype(np.float32)
    rois = np.array([[0, 2, 2, 9, 9]], np.float32)

    def run(mx, t):
        return mx.nd.contrib.DeformablePSROIPooling(
            mx.nd.array(data), mx.nd.array(rois),
            mx.nd.array(np.full((1, 2, P, P), t, np.float32)),
            spatial_scale=1.0, output_dim=D, group_size=G, pooled_size=P,
            sample_per_part=2, trans_std=0.2).asnumpy()
    o0 = _both(lambda mx: run(mx, 0.0))
    o1 = _both(lambda mx: run(mx, 1.0))
    assert not np.allclose(o0, o1)
