"""The detection image pipeline of mxnet_tpu_torch (``image/detection.py``
and ``io.ImageDetRecordIter``) held against mxnet_tpu on the CPU, bitwise.

- The augmenters (``DetBorrowAug``, ``DetHorizontalFlipAug``,
  ``DetRandomCropAug``, ``DetRandomSelectAug``) and
  ``CreateDetAugmenter``'s chains give the same images and labels from
  one seed of Python's ``random``, which both packages draw from.
- ``ImageDetIter`` and ``ImageDetRecordIter`` batches over a ``.rec``
  packed by the reference's writer: data and labels equal, labels padded
  with -1 rows to the estimated shape, under shuffle, random crop and
  mirror, ``reshape``, every ``last_batch_handle`` and the ``mean_*`` /
  ``std_*`` / ``round_batch`` mapping.  Both iterators draw from the one
  process-wide ``random`` (``ImageDetRecordIter``'s prefetch thread draws
  from its construction on), so each comparison seeds ``random``, builds
  and drains the reference's iterator, then re-seeds and does the same
  for the port's.
- The cases of ``tests/test_det_libsvm_io.py``'s ``TestImageDetRecordIter``
  run through both packages.
"""
import io as pyio
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrecordio
from mxnet_tpu.image import detection as jdet
from mxnet_tpu_torch import context, io
from mxnet_tpu_torch.image import detection as tdet

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

DSHAPE = (3, 32, 32)


@pytest.fixture(autouse=True)
def _on_cpu():
    with context.use("cpu"):
        yield


def pack_det(tmp_path, n=10, max_obj=3, fmt="JPEG", seed=0, h=40, w=48):
    """(rec, idx, truth) of ``n`` seeded images packed by the reference's
    writer; image i holds ``1 + i % max_obj`` objects (normalized corner
    boxes, label header ``[2, 5]``)."""
    rng = np.random.RandomState(seed)
    rec, idx = str(tmp_path / "det.rec"), str(tmp_path / "det.idx")
    wr = jrecordio.MXIndexedRecordIO(idx, rec, "w")
    truth = []
    for i in range(n):
        img = rng.randint(0, 255, (h, w, 3), np.uint8)
        label, objs = [2.0, 5.0], []
        for k in range(1 + i % max_obj):
            x1, y1 = rng.uniform(0, 0.5, 2)
            bw, bh = rng.uniform(0.2, 0.4, 2)
            objs.append([float(k), x1, y1, min(1.0, x1 + bw),
                         min(1.0, y1 + bh)])
            label += objs[-1]
        truth.append(objs)
        buf = pyio.BytesIO()
        Image.fromarray(img).save(buf, format=fmt)
        hdr = jrecordio.IRHeader(len(label), np.asarray(label, np.float32),
                                 i, 0)
        wr.write_idx(i, jrecordio.pack(hdr, buf.getvalue()))
    wr.close()
    return rec, idx, truth


def drain(it, epochs=1):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def same(got, want):
    assert len(got) == len(want) and len(want) > 0
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gd.dtype == wd.dtype and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp


def both(make_ref, make_port, epochs=1, seed=7):
    """Seed ``random``, build and drain the reference's iterator; re-seed,
    build and drain the port's."""
    random.seed(seed)
    want = drain(make_ref(), epochs)
    random.seed(seed)
    got = drain(make_port(), epochs)
    same(got, want)
    return got


# -- augmenters ----------------------------------------------------------
def _image_and_label(rng):
    img = rng.randint(0, 255, (40, 56, 3), np.uint8)
    label = np.full((4, 6), -1.0, np.float32)
    for k in range(3):
        x1, y1 = rng.uniform(0, 0.6, 2)
        label[k] = [k, x1, y1, x1 + rng.uniform(0.1, 0.4),
                    y1 + rng.uniform(0.1, 0.4), 0.5]
    return img, label


def _run_chain(augs, samples):
    out = []
    for img, lab in samples:
        for a in augs:
            img, lab = a(img, lab)
        out.append((np.asarray(img), np.asarray(lab)))
    return out


AUG_CHAINS = {
    "flip": lambda m: [m.DetHorizontalFlipAug(0.5)],
    "crop": lambda m: [m.DetRandomCropAug(min_object_covered=0.5,
                                          area_range=(0.3, 1.0))],
    "select": lambda m: [m.DetRandomSelectAug(
        [m.DetRandomCropAug(), m.DetHorizontalFlipAug(1.0)], 0.3)],
    "create": lambda m: m.CreateDetAugmenter(DSHAPE, rand_crop=0.5,
                                             rand_mirror=True),
    "create_resize_norm": lambda m: m.CreateDetAugmenter(
        DSHAPE, resize=36, rand_crop=1.0, rand_mirror=True, mean=True,
        std=True, area_range=(0.1, 1.0), min_eject_coverage=0.5),
}


@pytest.mark.parametrize("chain", sorted(AUG_CHAINS))
def test_det_augmenters_bitwise_under_one_seed(chain):
    rng = np.random.RandomState(0)
    samples = [_image_and_label(rng) for _ in range(12)]
    random.seed(3)
    want = _run_chain(AUG_CHAINS[chain](jdet), samples)
    random.seed(3)
    got = _run_chain(AUG_CHAINS[chain](tdet), samples)
    assert [type(a).__name__ for a in AUG_CHAINS[chain](tdet)] == \
        [type(a).__name__ for a in AUG_CHAINS[chain](jdet)]
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    if chain in ("flip", "crop", "create"):
        assert any(not np.array_equal(gl, lab)
                   for (_, gl), (_, lab) in zip(got, samples))


def test_borrow_aug_and_dumps():
    img = np.random.RandomState(1).randint(0, 255, (20, 24, 3), np.uint8)
    lab = np.array([[0, 0.1, 0.2, 0.5, 0.6]], np.float32)
    outs = [m.DetBorrowAug(m.CastAug() if m is tdet else
                           jmx.image.CastAug())(img, lab) for m in (jdet,
                                                                    tdet)]
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[1][1] is lab
    assert tdet.DetHorizontalFlipAug(0.5).dumps() == \
        jdet.DetHorizontalFlipAug(0.5).dumps()


# -- iterators -----------------------------------------------------------
@pytest.mark.parametrize("last", ["pad", "keep", "discard"])
def test_image_det_iter_every_last_batch_handle(tmp_path, last):
    rec, idx, _ = pack_det(tmp_path)

    def make(m):
        return lambda: m.ImageDetIter(4, DSHAPE, path_imgrec=rec,
                                      path_imgidx=idx, shuffle=True,
                                      rand_crop=0.5, rand_mirror=True,
                                      last_batch_handle=last)
    got = both(make(jdet), make(tdet), epochs=2)
    assert len(got) == (6 if last != "discard" else 4)
    if last == "pad":
        assert got[2][2] == 2 and got[2][0].shape[0] == 4
    if last == "keep":
        assert got[2][0].shape[0] == 2 and got[2][2] == 0


def test_image_det_iter_label_padding_and_reshape(tmp_path):
    rec, idx, truth = pack_det(tmp_path)
    its = []
    for m in (jdet, tdet):
        it = m.ImageDetIter(4, DSHAPE, path_imgrec=rec, path_imgidx=idx)
        assert it._label_shape == (3, 5)
        assert it.provide_label[0].shape == (4, 3, 5)
        its.append(it)
    got = drain(its[1])
    same(got, drain(its[0]))
    lab = got[0][1]
    assert (lab[0, 1:, :] == -1).all()          # one object, two pad rows
    np.testing.assert_allclose(lab[0, 0], truth[0][0], atol=1e-6)
    for it in its:
        it.reset()
        it.reshape(data_shape=DSHAPE, label_shape=(5, 5))
        assert it.provide_data[0].shape == (4,) + DSHAPE
        assert it.provide_label[0].shape == (4, 5, 5)
    got = drain(its[1])
    same(got, drain(its[0]))
    assert got[0][1].shape == (4, 5, 5) and (got[0][1][:, 3:] == -1).all()


def test_image_det_iter_parse_label_errors():
    it = tdet.ImageDetIter.__new__(tdet.ImageDetIter)
    from mxnet_tpu_torch.base import MXNetError
    for raw in ([2.0], [2.0, 4.0, 0, 0.1, 0.1, 0.2], [2.0, 5.0, 0, 0.1]):
        with pytest.raises(MXNetError):
            it._parse_label(raw)
    raw = np.array([4.0, 5.0, 9, 9, 1, 0.1, 0.2, 0.3, 0.4], np.float32)
    np.testing.assert_array_equal(it._parse_label(raw), [raw[4:]])
    np.testing.assert_array_equal(
        it._parse_label(raw),
        jdet.ImageDetIter.__new__(jdet.ImageDetIter)._parse_label(raw))


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, rand_crop=0.5, rand_mirror=True),
    dict(mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.395,
         std_g=57.12, std_b=57.375, round_batch=False),
    dict(mean_g=10.0, prefetch_buffer=1, shuffle=True),
])
def test_image_det_record_iter_matches_reference(tmp_path, kw):
    rec, idx, _ = pack_det(tmp_path)
    common = dict(path_imgrec=rec, path_imgidx=idx, batch_size=4,
                  data_shape=DSHAPE, **kw)
    got = both(lambda: jmx.io.ImageDetRecordIter(**common),
               lambda: io.ImageDetRecordIter(**common))
    assert isinstance(io.ImageDetRecordIter(**common), io.PrefetchingIter)
    if kw.get("round_batch") is False:
        assert got[-1][0].shape[0] == 2


def test_image_det_record_iter_warns_once_on_threads(tmp_path):
    rec, idx, _ = pack_det(tmp_path, n=4)
    with pytest.warns(RuntimeWarning, match="preprocess_threads"):
        it = io.ImageDetRecordIter(path_imgrec=rec, path_imgidx=idx,
                                   batch_size=2, data_shape=DSHAPE,
                                   preprocess_threads=3)
    assert len(drain(it)) == 2


# -- tests/test_det_libsvm_io.py:115-165 through both packages ----------
def _libsvm_rec(tmp_path):
    """The reference test's ``_pack_det``: 8 PNG images of 40 x 40, one or
    two objects."""
    return pack_det(tmp_path, n=8, max_obj=2, fmt="PNG", h=40, w=40)


def test_ref_case_batches_and_label_padding(tmp_path):
    rec, idx, truth = _libsvm_rec(tmp_path)
    kw = dict(path_imgrec=rec, path_imgidx=idx, batch_size=4,
              data_shape=(3, 32, 32))
    got = both(lambda: jmx.io.ImageDetRecordIter(**kw),
               lambda: io.ImageDetRecordIter(**kw))
    d, lab, _ = got[0]
    assert d.shape == (4, 3, 32, 32) and lab.shape == (4, 2, 5)
    assert lab[0, 1, 0] == -1.0
    np.testing.assert_allclose(lab[0, 0], truth[0][0], atol=1e-5)


def test_ref_case_shuffle_and_reset(tmp_path):
    rec, idx, _ = _libsvm_rec(tmp_path)
    kw = dict(path_imgrec=rec, path_imgidx=idx, batch_size=8,
              data_shape=(3, 32, 32), shuffle=True)
    for m in (jmx.io, io):
        it = m.ImageDetRecordIter(**kw)
        b1 = it.next()
        it.reset()
        b2 = it.next()
        assert b1.data[0].shape == b2.data[0].shape == (8, 3, 32, 32)


def test_ref_case_flip_aug_mirrors_boxes():
    img = np.arange(2 * 4 * 3, dtype=np.uint8).reshape(2, 4, 3)
    label = np.array([[0, 0.1, 0.2, 0.4, 0.8]], np.float32)
    outs = [m.DetHorizontalFlipAug(p=1.0)(img, label) for m in (jdet, tdet)]
    for out, lab in outs:
        np.testing.assert_array_equal(out, img[:, ::-1])
        np.testing.assert_allclose(lab[0], [0, 0.6, 0.2, 0.9, 0.8],
                                   atol=1e-6)
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_ref_case_random_crop_keeps_box_geometry():
    img = np.random.RandomState(0).randint(0, 255, (40, 40, 3), np.uint8)
    label = np.array([[1, 0.3, 0.3, 0.7, 0.7]], np.float32)
    outs = []
    for m in (jdet, tdet):
        random.seed(11)
        out, lab = m.DetRandomCropAug(min_object_covered=0.5,
                                      area_range=(0.5, 1.0))(img, label)
        for row in lab[lab[:, 0] >= 0]:
            assert 0.0 <= row[1] <= row[3] <= 1.0
            assert 0.0 <= row[2] <= row[4] <= 1.0
        outs.append((np.asarray(out), lab))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_ref_case_create_det_augmenter_chain():
    img = np.random.RandomState(2).randint(0, 255, (48, 64, 3), np.uint8)
    label = np.array([[0, 0.2, 0.2, 0.8, 0.8]], np.float32)
    outs = []
    for m in (jdet, tdet):
        random.seed(5)
        x, lab = img, label
        for aug in m.CreateDetAugmenter((3, 32, 32), rand_mirror=True,
                                        rand_crop=0.5):
            x, lab = aug(x, lab)
        assert np.asarray(x).shape == (32, 32, 3)
        outs.append((np.asarray(x), lab))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
