"""The Gluon convolution, pooling and padding layers of mxnet_tpu_torch
(``gluon/nn/conv_layers.py``) held against mxnet_tpu's, in every layout.

Each layer is built in both packages, the reference's seeded Xavier
weights are carried into the port (``from_jax_params``), and the same
seeded input goes through both, called on NDArrays inside
``autograd.record()`` with a seeded head: the output, the input's
gradient and every parameter's gradient within 1e-5 (f32; only the
reduction orders differ).  Every parameter's shape equals the
reference's: ``(O, *k, I/g)`` for a channels-last convolution, ``(I,
O/g, *k)`` for a transposed one in every layout, ``in_channels`` given
or read at the first forward.  The ``Deconvolution`` op alone takes an
``adj`` of at least the stride (outside torch's ``output_padding``
range) as the reference does.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.gluon.utils import from_jax_params

TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _close(want, got, msg=""):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=msg)


# name -> (layer factory over a gluon package's nn, input shape)
CONV = {
    "conv1d_ncw": (lambda nn: nn.Conv1D(4, 3, strides=2, padding=1,
                                        in_channels=3), (2, 3, 9)),
    "conv1d_nwc": (lambda nn: nn.Conv1D(4, 3, padding=2, dilation=2,
                                        layout="NWC"), (2, 9, 3)),
    "conv2d_nchw_groups": (lambda nn: nn.Conv2D(
        6, 3, strides=(2, 1), padding=1, groups=3, in_channels=6),
        (2, 6, 7, 8)),
    "conv2d_nhwc": (lambda nn: nn.Conv2D(
        4, (3, 2), strides=2, padding=(1, 0), dilation=(1, 2),
        layout="NHWC"), (2, 7, 8, 3)),
    "conv2d_nhwc_groups_relu": (lambda nn: nn.Conv2D(
        6, 3, padding=1, groups=2, layout="NHWC", activation="relu",
        in_channels=4), (2, 5, 5, 4)),
    "conv2d_nhwc_depthwise": (lambda nn: nn.Conv2D(
        4, 3, strides=2, padding=1, groups=4, layout="NHWC",
        use_bias=False), (2, 6, 6, 4)),
    "conv3d_ncdhw": (lambda nn: nn.Conv3D(4, 3, padding=1, in_channels=2),
                     (2, 2, 4, 5, 5)),
    "conv3d_ndhwc": (lambda nn: nn.Conv3D(
        4, (2, 3, 3), strides=(1, 2, 2), layout="NDHWC", use_bias=False),
        (2, 4, 6, 6, 2)),
    "conv1dT_ncw": (lambda nn: nn.Conv1DTranspose(
        4, 3, strides=2, padding=1, output_padding=1), (2, 3, 5)),
    "conv1dT_nwc": (lambda nn: nn.Conv1DTranspose(
        4, 3, strides=2, layout="NWC", in_channels=3), (2, 5, 3)),
    "conv2dT_nchw": (lambda nn: nn.Conv2DTranspose(
        4, 3, strides=2, padding=1, output_padding=1), (2, 3, 4, 5)),
    "conv2dT_nchw_groups_dilated": (lambda nn: nn.Conv2DTranspose(
        4, 3, strides=(2, 1), padding=(1, 2), dilation=2, groups=2,
        in_channels=4), (2, 4, 4, 5)),
    "conv2dT_nhwc": (lambda nn: nn.Conv2DTranspose(
        4, (3, 2), strides=2, output_padding=(1, 0), layout="NHWC",
        activation="tanh"), (2, 4, 5, 3)),
    "conv2dT_adj_past_stride": (lambda nn: nn.Conv2DTranspose(
        3, 3, strides=1, padding=1, output_padding=2), (2, 2, 4, 4)),
    "conv3dT_ncdhw": (lambda nn: nn.Conv3DTranspose(3, 2, strides=2),
                      (2, 2, 3, 3, 3)),
    "conv3dT_ndhwc": (lambda nn: nn.Conv3DTranspose(
        3, 3, strides=(1, 2, 2), padding=1, output_padding=(0, 1, 1),
        layout="NDHWC"), (1, 3, 4, 4, 2)),
}

POOL = {
    "maxpool1d_ncw": (lambda nn: nn.MaxPool1D(3, 2, 1), (2, 3, 9)),
    "maxpool1d_nwc_ceil": (lambda nn: nn.MaxPool1D(
        3, 2, ceil_mode=True, layout="NWC"), (2, 10, 3)),
    "maxpool2d_nchw_ceil": (lambda nn: nn.MaxPool2D(3, 2, ceil_mode=True),
                            (2, 3, 8, 8)),
    "maxpool2d_nhwc": (lambda nn: nn.MaxPool2D(3, 2, 1, layout="NHWC"),
                       (2, 7, 7, 3)),
    "maxpool3d_ncdhw": (lambda nn: nn.MaxPool3D(2), (2, 2, 4, 4, 4)),
    "maxpool3d_ndhwc_ceil": (lambda nn: nn.MaxPool3D(
        (2, 3, 3), 2, ceil_mode=True, layout="NDHWC"), (1, 5, 6, 6, 2)),
    "avgpool1d_ncw_pad": (lambda nn: nn.AvgPool1D(
        3, 2, 1, count_include_pad=False), (2, 3, 9)),
    "avgpool1d_nwc": (lambda nn: nn.AvgPool1D(2, layout="NWC"), (2, 8, 3)),
    "avgpool2d_nchw_pad": (lambda nn: nn.AvgPool2D(3, 1, 1), (2, 3, 6, 6)),
    "avgpool2d_nhwc_ceil": (lambda nn: nn.AvgPool2D(
        3, 2, ceil_mode=True, count_include_pad=False, layout="NHWC"),
        (2, 8, 8, 3)),
    "avgpool3d_ncdhw": (lambda nn: nn.AvgPool3D(2, 1), (2, 2, 3, 4, 4)),
    "avgpool3d_ndhwc_pad": (lambda nn: nn.AvgPool3D(
        3, 2, 1, layout="NDHWC"), (1, 5, 5, 5, 2)),
    "reflectionpad2d": (lambda nn: nn.ReflectionPad2D(2), (2, 3, 5, 6)),
}
for _kind in ("Max", "Avg"):
    for _n, _layouts in ((1, ("NCW", "NWC")), (2, ("NCHW", "NHWC")),
                         (3, ("NCDHW", "NDHWC"))):
        for _layout in _layouts:
            _shape = (2,) + (3,) * _n
            _shape = _shape[:1] + (4,) + _shape[1:] if _layout[1] == "C" \
                else _shape + (4,)
            POOL["global%spool%dd_%s" % (_kind.lower(), _n,
                                         _layout.lower())] = (
                lambda nn, k=_kind, n=_n, lay=_layout: getattr(
                    nn, "Global%sPool%dD" % (k, n))(layout=lay), _shape)


def _run(pkg, block, x, head):
    """(output, input gradient) of ``block`` on ``x`` recorded, the
    head-weighted sum backpropagated."""
    ag = mx.autograd if pkg is mx.nd else autograd
    a = pkg.array(x)
    a.attach_grad()
    with ag.record():
        out = block(a)
        total = (out * pkg.array(head)).sum()
    total.backward()
    return out.asnumpy(), a.grad.asnumpy()


def _check(name, make, shape):
    rng = np.random.RandomState(sum(map(ord, name)))
    x = rng.randn(*shape).astype(np.float32)
    jb, tb = make(jgluon.nn), make(gluon.nn)
    np.random.seed(0)
    jb.initialize(mx.init.Xavier())
    head = rng.randn(*jb(mx.nd.array(x)).shape).astype(np.float32)
    jp = jb.collect_params()
    if len(jp.keys()):
        from_jax_params(tb, {n: p.data().asnumpy() for n, p in jp.items()},
                        device="cpu")
    jy, jg = _run(mx.nd, jb, x, head)
    ty, tg = _run(nd, tb, x, head)
    assert ty.shape == jy.shape
    _close(jy, ty, name)
    _close(jg, tg, name + " input grad")
    tp = tb.collect_params()
    assert [p.shape for p in tp.values()] == [p.shape for p in jp.values()]
    for (jn, pj), pt in zip(jp.items(), tp.values()):
        _close(pj.grad().asnumpy(), pt.grad().asnumpy(), msg=jn)
    return jb, tb


@pytest.mark.parametrize("name", sorted(CONV))
def test_conv_layer_matches_reference(name):
    make, shape = CONV[name]
    jb, tb = _check(name, make, shape)
    w = tb.weight.shape
    if "T_" in name:
        cin = shape[-1] if tb._channels_last else shape[1]
        assert w[0] == cin and w[2:] == tb._kernel
    elif tb._channels_last:
        assert w[1:-1] == tb._kernel and w[-1] == shape[-1] // \
            tb._kwargs["num_group"]


@pytest.mark.parametrize("name", sorted(POOL))
def test_pool_and_pad_layer_matches_reference(name):
    make, shape = POOL[name]
    _check(name, make, shape)


@pytest.mark.parametrize("adj,pad", [((2,), (1,)), ((0,), (2,)),
                                     ((3,), (0,))])
def test_deconvolution_op_takes_any_adj(adj, pad):
    """The reference's output size ``(n - 1) s + k - 2 pad + adj`` for an
    ``adj`` torch's ``output_padding`` refuses (>= stride), a bias and
    groups."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 4, 6).astype(np.float32)
    w = rng.randn(4, 3, 3).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    kw = dict(kernel=(3,), stride=(1,), pad=pad, adj=adj, num_filter=6,
              num_group=2, no_bias=False)
    want = mx.nd.Deconvolution(mx.nd.array(x), mx.nd.array(w),
                               mx.nd.array(b), **kw).asnumpy()
    got = nd.Deconvolution(nd.array(x), nd.array(w), nd.array(b),
                           **kw).asnumpy()
    assert got.shape == want.shape == (2, 6, 6 + 3 - 1 - 2 * pad[0] + adj[0])
    _close(want, got)


def test_check_layout_is_gone():
    """Every layout builds (no layer raises for channels-last)."""
    for layout, cls in (("NWC", gluon.nn.Conv1D), ("NHWC", gluon.nn.Conv2D),
                        ("NDHWC", gluon.nn.Conv3D)):
        c = cls(4, 3, layout=layout, in_channels=8, groups=2)
        assert c.weight.shape == (4,) + (3,) * (len(layout) - 2) + (4,)
    assert gluon.nn.MaxPool2D(layout="NHWC")._kwargs["layout"] == "NHWC"


# -- gluon.contrib.nn and the clip of RELU6 -----------------------------------
def test_contrib_blocks_match_reference():
    from mxnet_tpu.gluon import contrib as jcontrib
    from mxnet_tpu_torch.gluon import contrib
    x = np.random.RandomState(4).randn(2, 3).astype(np.float32)

    def build(pkg, nn, cls, axis):
        c = getattr(nn, cls)(axis=axis)
        with c.name_scope():
            c.add(pkg.nn.Dense(4))
            c.add(nn.Identity())
        return c

    for cls, axis in (("Concurrent", -1), ("HybridConcurrent", 1)):
        jc = build(jgluon, jcontrib.nn, cls, axis)
        tc = build(gluon, contrib.nn, cls, axis)
        np.random.seed(0)
        jc.initialize(mx.init.Xavier())
        want = jc(mx.nd.array(x)).asnumpy()
        from_jax_params(tc, {n: p.data().asnumpy() for n, p in
                             jc.collect_params().items()}, device="cpu")
        _close(want, tc(nd.array(x)).asnumpy(), cls)
    with pytest.raises(NotImplementedError, match="item 10"):
        contrib.nn.SparseEmbedding(10, 4)


def test_clip_gradient_at_its_bounds_is_the_reference():
    """``clip`` (MobileNet's ``RELU6``) passes half the gradient at a
    bound, as ``jnp.clip`` does (``torch.clamp`` would pass all of it)."""
    x = np.array([0.0, 6.0, 3.0, -1.0, 7.0], np.float32)
    grads = []
    for pkg, ag in ((mx.nd, mx.autograd), (nd, autograd)):
        a = pkg.array(x)
        a.attach_grad()
        with ag.record():
            y = pkg.clip(a, 0, 6)
        y.backward()
        grads.append(a.grad.asnumpy())
    np.testing.assert_array_equal(grads[1], grads[0])
    np.testing.assert_array_equal(grads[1], [0.5, 0.5, 1, 0, 0])
