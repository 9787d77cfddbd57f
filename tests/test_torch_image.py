"""mxnet_tpu_torch.image held against mxnet_tpu.image, bitwise.

Both packages run the same numpy and OpenCV calls on the host, so every
check is exact (values and dtypes): the image functions on numpy and
NDArray inputs, each of the 16 augmenters and ``CreateAugmenter`` chains
under one ``random.seed`` / ``np.random.seed``, and ``ImageIter`` over
record files on both decode paths (the native libjpeg batch decoder and
OpenCV), over image lists, without an ``.idx``, sharded, shuffled, with
PNG records (which fall back from the native path to OpenCV) and in
grayscale.  The port's NDArrays stay on the CPU.
"""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import image as jimage
from mxnet_tpu_torch import image, nd
from mxnet_tpu_torch.ndarray import NDArray

import torch_io_cases as cases

cv2 = pytest.importorskip("cv2")

EIGVAL = np.array([55.46, 4.794, 1.148])
EIGVEC = np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                   [-0.5836, -0.6948, 0.4203]])


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _img(seed=0):
    return cases.image(np.random.RandomState(seed), 36, 44)


def test_decode_and_functions_match_reference(tmp_path):
    raw = cv2.imencode(".jpg", _img())[1].tobytes()
    for kw in ({}, {"to_rgb": False}, {"flag": 0}):
        got = image.imdecode(raw, **kw)
        assert isinstance(got, NDArray) and got.context.type == "cpu"
        _same(got, jimage.imdecode(raw, **kw))
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, _img(1))
    _same(image.imread(path), jimage.imread(path))
    assert image.scale_down((40, 30), (64, 64)) == \
        jimage.scale_down((40, 30), (64, 64))
    for src, jsrc in ((_img(), _img()),
                      (nd.array(_img(), ctx="cpu", dtype=np.uint8),
                       jmx.nd.array(_img(), dtype=np.uint8))):
        _same(image.imresize(src, 20, 14), jimage.imresize(jsrc, 20, 14))
        _same(image.resize_short(src, 24, 1),
              jimage.resize_short(jsrc, 24, 1))
        _same(image.fixed_crop(src, 3, 4, 20, 16, (10, 8)),
              jimage.fixed_crop(jsrc, 3, 4, 20, 16, (10, 8)))
        _same(image.center_crop(src, (30, 50))[0],
              jimage.center_crop(jsrc, (30, 50))[0])
        _same(image.color_normalize(src, (1.0, 2.0, 3.0), (4.0, 5.0, 6.0)),
              jimage.color_normalize(jsrc, (1.0, 2.0, 3.0),
                                     (4.0, 5.0, 6.0)))
        for s in range(3):
            _seed(s)
            g, gbox = image.random_crop(src, (20, 20))
            _seed(s)
            w, wbox = jimage.random_crop(jsrc, (20, 20))
            _same(g, w)
            assert gbox == wbox
            _seed(s)
            g, gbox = image.random_size_crop(src, (16, 16), (0.08, 1.0),
                                             (0.75, 1.333))
            _seed(s)
            w, wbox = jimage.random_size_crop(jsrc, (16, 16), (0.08, 1.0),
                                              (0.75, 1.333))
            _same(g, w)
            assert gbox == wbox
        if isinstance(src, NDArray):
            assert image.imresize(src, 8, 8).context.type == "cpu"


AUGMENTERS = {
    "ResizeAug": lambda m: m.ResizeAug(24, 1),
    "ForceResizeAug": lambda m: m.ForceResizeAug((30, 20)),
    "RandomCropAug": lambda m: m.RandomCropAug((24, 20)),
    "RandomSizedCropAug": lambda m: m.RandomSizedCropAug(
        (24, 24), (0.08, 1.0), (0.75, 1.333)),
    "CenterCropAug": lambda m: m.CenterCropAug((24, 20)),
    "BrightnessJitterAug": lambda m: m.BrightnessJitterAug(0.3),
    "ContrastJitterAug": lambda m: m.ContrastJitterAug(0.3),
    "SaturationJitterAug": lambda m: m.SaturationJitterAug(0.3),
    "HueJitterAug": lambda m: m.HueJitterAug(0.2),
    "ColorJitterAug": lambda m: m.ColorJitterAug(0.2, 0.3, 0.4),
    "LightingAug": lambda m: m.LightingAug(0.1, EIGVAL, EIGVEC),
    "ColorNormalizeAug": lambda m: m.ColorNormalizeAug(cases.MEAN,
                                                       cases.STD),
    "RandomGrayAug": lambda m: m.RandomGrayAug(0.5),
    "HorizontalFlipAug": lambda m: m.HorizontalFlipAug(0.5),
    "CastAug": lambda m: m.CastAug(),
    "SequentialAug": lambda m: m.SequentialAug(
        [m.CastAug(), m.BrightnessJitterAug(0.2),
         m.HorizontalFlipAug(0.5)]),
}


@pytest.mark.parametrize("name", sorted(AUGMENTERS))
def test_each_augmenter_matches_reference(name):
    """Constructed under one seed (ColorJitterAug shuffles its order
    there), then applied under each of four seeds, to numpy and to an
    NDArray; ``dumps`` too."""
    assert issubclass(getattr(image, name), image.Augmenter)
    _seed(11)
    aug = AUGMENTERS[name](image)
    _seed(11)
    jaug = AUGMENTERS[name](jimage)
    assert aug.dumps() == jaug.dumps()
    src = _img(2).astype(np.float32) if name in (
        "BrightnessJitterAug", "HueJitterAug") else _img(2)
    for s in range(4):
        _seed(s)
        got = aug(src)
        _seed(s)
        _same(got, jaug(src))
        _seed(s)
        got = aug(nd.array(src, ctx="cpu", dtype=src.dtype))
        _seed(s)
        want = jaug(jmx.nd.array(src, dtype=src.dtype))
        _same(got, want)
        if isinstance(got, NDArray):
            assert got.context.type == "cpu"


CHAINS = [
    {},
    {"resize": 40, "rand_crop": True, "rand_mirror": True},
    {"rand_crop": True, "rand_resize": True, "inter_method": 1},
    {"brightness": 0.2, "contrast": 0.2, "saturation": 0.2, "hue": 0.1,
     "pca_noise": 0.1, "rand_gray": 0.3},
    {"mean": True, "std": True, "rand_mirror": True},
    {"mean": np.array(cases.MEAN), "std": np.array(cases.STD),
     "resize": 30},
]


@pytest.mark.parametrize("kw", CHAINS, ids=range(len(CHAINS)))
def test_create_augmenter_chain_matches_reference(kw):
    _seed(5)
    augs = image.CreateAugmenter((3, 24, 24), **kw)
    _seed(5)
    jaugs = jimage.CreateAugmenter((3, 24, 24), **kw)
    assert [a.dumps() for a in augs] == [a.dumps() for a in jaugs]
    for s in range(3):
        x = jx = _img(s)
        _seed(s)
        for a in augs:
            x = a(x)
        _seed(s)
        for a in jaugs:
            jx = a(jx)
        _same(x, jx)


def _iters(kw):
    """(port, reference) ImageIter on one set of kwargs."""
    return [mod.ImageIter(**kw) for mod in (image, jimage)]


def _same_streams(kw, seed=0):
    """One epoch of each package's ImageIter, each built and drained
    after ``_seed(seed)`` (its ``reset`` shuffles, its augmenters draw)."""
    streams = []
    for mod in (image, jimage):
        _seed(seed)
        streams.append(cases.drain(mod.ImageIter(**kw)))
    cases.assert_same_stream(*streams)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("layout,dtype,norm,last", [
    ("NCHW", "float32", False, "pad"), ("NHWC", "uint8", False, "keep"),
    ("NCHW", "float32", True, "discard"), ("NHWC", "float32", True, "pad")])
def test_image_iter_matches_reference(tmp_path, native, layout, dtype, norm,
                                      last):
    rec, idx = cases.make_rec(tmp_path, n=10)
    kw = dict(batch_size=cases.BATCH, data_shape=(3, 32, 32),
              path_imgrec=rec, path_imgidx=idx, resize=34, layout=layout,
              dtype=dtype, last_batch_handle=last, native_decode=native,
              preprocess_threads=2)
    if norm:
        kw.update(mean=np.array(cases.MEAN), std=np.array(cases.STD))
    it, jit = _iters(kw)
    assert (it._native_tail is not None) == native
    assert (jit._native_tail is not None) == native
    assert it.provide_data[0].shape == jit.provide_data[0].shape
    for _ in range(2):
        cases.assert_same_stream(cases.drain(it), cases.drain(jit))
        it.reset()
        jit.reset()
    assert it.next().data[0].context.type == "cpu"


def test_image_iter_sources_match_reference(tmp_path):
    """Shuffled, sharded, a second label column, no ``.idx`` sidecar, an
    image list (file and in memory), and grayscale."""
    rec, idx = cases.make_rec(tmp_path, n=12, label_width=2)
    base = dict(batch_size=cases.BATCH, data_shape=(3, 32, 32), resize=34,
                label_width=2)
    _same_streams(dict(base, path_imgrec=rec, shuffle=True, rand_crop=True),
                  seed=3)
    _same_streams(dict(base, path_imgrec=rec, path_imgidx=idx, num_parts=2,
                       part_index=1))
    rng = np.random.RandomState(4)
    lines = []
    for i in range(6):
        cv2.imwrite(str(tmp_path / ("%d.png" % i)), cases.image(rng))
        lines.append("%d\t%f\t%d.png\n" % (i, i * 2.0, i))
    (tmp_path / "list.lst").write_text("".join(lines))
    lst = dict(batch_size=2, data_shape=(3, 32, 32), resize=34,
               path_root=str(tmp_path))
    _same_streams(dict(lst, path_imglist=str(tmp_path / "list.lst")))
    mem = [[float(i), "%d.png" % i] for i in range(6)]
    _same_streams(dict(lst, imglist=mem))
    _same_streams(dict(batch_size=3, data_shape=(1, 28, 28), path_imgrec=rec,
                       path_imgidx=idx, label_width=2))


def test_png_records_fall_back_to_cv2(tmp_path):
    rec, idx = cases.make_rec(tmp_path, n=6, fmt=".png")
    kw = dict(batch_size=3, data_shape=(3, 32, 32), path_imgrec=rec,
              path_imgidx=idx)
    it, jit = _iters(kw)
    assert it._native_tail is not None
    cases.assert_same_stream(cases.drain(it), cases.drain(jit))
    assert it._native_tail is None and jit._native_tail is None
    batch = image.ImageIter(**kw).next()
    assert batch.data[0].context.type == "cpu"
