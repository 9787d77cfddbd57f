"""Shared inputs of the data-pipeline parity tests (``test_torch_recordio``,
``test_torch_image``, ``test_torch_io_*``, ``test_torch_gluon_data``,
``test_torch_data_train``): seeded images packed into record files by the
reference's writer, and the batch-drain helpers."""
import os

import numpy as np

from mxnet_tpu import recordio as jrecordio

SIDE = 32
BATCH = 4
# the ImageNet normalization of chip_smoke.py phase 26
MEAN = (123.68, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)
MEAN_STD = dict(mean_r=MEAN[0], mean_g=MEAN[1], mean_b=MEAN[2],
                std_r=STD[0], std_g=STD[1], std_b=STD[2])


def image(rng, h=SIDE + 8, w=SIDE + 12):
    """One seeded BGR uint8 image: a smooth gradient plus noise (JPEG
    keeps it close, so crops and flips stay visible)."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // w, yy * 255 // h,
                     (xx + yy) * 255 // (h + w)], -1)
    return np.clip(base + rng.randint(0, 40, (h, w, 3)), 0,
                   255).astype(np.uint8)


def make_rec(tmp_path, n=24, fmt=".jpg", name="data", h=SIDE + 8,
             w=SIDE + 12, seed=0, label_width=1):
    """(rec, idx) of ``n`` seeded images packed by the reference's
    ``pack_img``; record ``i`` has label ``i`` (or ``[i, i + 0.5, ...]``)."""
    rng = np.random.RandomState(seed)
    rec = os.path.join(str(tmp_path), name + ".rec")
    idx = os.path.join(str(tmp_path), name + ".idx")
    wr = jrecordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        label = float(i) if label_width == 1 else \
            np.arange(label_width, dtype=np.float32) * 0.5 + i
        wr.write_idx(i, jrecordio.pack_img(
            jrecordio.IRHeader(0, label, i, 0), image(rng, h, w),
            quality=90, img_fmt=fmt))
    wr.close()
    return rec, idx


def drain(it):
    """[(data, label, pad)] of an iterator's epoch, as numpy."""
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def assert_same_stream(got, want):
    assert len(got) == len(want)
    for (d0, l0, p0), (d1, l1, p1) in zip(got, want):
        assert d0.dtype == d1.dtype and d0.shape == d1.shape
        np.testing.assert_array_equal(d0, d1)
        np.testing.assert_array_equal(l0, l1)
        assert p0 == p1


def f32_ulps(got, want):
    """Largest distance in float32 ulps (at ``want``'s magnitude)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = np.spacing(np.abs(want))
    return float(np.max(np.abs(got.astype(np.float64) - want) / ulp))


def host_tail(u8, dtype=np.float32):
    """The device tail's arithmetic in numpy, as written in both packages:
    widen to float32, subtract the mean, divide by the std (true
    division), NHWC."""
    y = (u8.astype(np.float32) - np.asarray(MEAN, np.float32)) \
        / np.asarray(STD, np.float32)
    return y.astype(dtype)
