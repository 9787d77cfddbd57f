"""The iterators of mxnet_tpu_torch.io held against mxnet_tpu.io, bitwise.

Every iterator here is host code over numpy, so each check is exact:
``NDArrayIter`` in every mode (shuffled from a seed, ``pad`` /
``discard`` / ``roll_over``, ``getindex``, two epochs), ``CSVIter``,
``LibSVMIter`` (its CSR batches densified), ``MNISTIter`` (gzip and
raw idx files), ``ResizeIter``, ``PrefetchingIter`` and
``ImageRecordIter`` with a seed and ``round_batch`` on and off (through
the in-process pipeline and, with ``device_tail=True``, its device feed,
here onto the CPU: the tail is held to the reference's ``jax.jit`` tail in
``test_torch_io_pipeline.py``).  Host iterators yield CPU NDArrays.
``ImageDetRecordIter`` runs here over a detection ``.rec``; its parity
with the reference is ``test_torch_image_det.py``.
"""
import gzip
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu_torch import context, io
from mxnet_tpu_torch.ndarray import sparse
from mxnet_tpu_torch.io import (DeviceFeedIter, NDArrayIter,
                                PrefetchToDeviceIter, make_device_tail)

import torch_io_cases as cases

cv2 = pytest.importorskip("cv2")


def _epochs(it, n=2):
    """``n`` epochs of [(data..., label..., pad, index)] as numpy."""
    out = []
    for _ in range(n):
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [lab.asnumpy() for lab in (b.label or [])], b.pad,
                        None if b.index is None else np.asarray(b.index)))
            assert all(d.context.type == "cpu" for d in b.data
                       if hasattr(d.context, "type"))
        it.reset()
    return out


def _same_epochs(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp, gi), (wd, wl, wp, wi) in zip(got, want):
        assert len(gd) == len(wd) and len(gl) == len(wl)
        for a, b in zip(gd + gl, wd + wl):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert gp == wp
        if wi is None:
            assert gi is None
        else:
            np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("last", ["pad", "discard", "roll_over"])
def test_ndarray_iter_modes_match_reference(shuffle, last):
    rng = np.random.RandomState(0)
    data = {"a": rng.rand(10, 3).astype(np.float32),
            "b": rng.randint(0, 9, (10, 2)).astype(np.int32)}
    label = np.arange(10, dtype=np.float32)
    kw = dict(batch_size=4, shuffle=shuffle, shuffle_seed=7,
              last_batch_handle=last)
    it = NDArrayIter(data, label, **kw)
    jt = jmx.io.NDArrayIter(data, label, **kw)
    assert it.provide_data == jt.provide_data
    assert [d.dtype for d in it.provide_label] == \
        [d.dtype for d in jt.provide_label]
    _same_epochs(_epochs(it, 3), _epochs(jt, 3))


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_matches_reference(tmp_path, round_batch):
    rng = np.random.RandomState(1)
    data_csv, label_csv = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(data_csv, rng.rand(7, 6), delimiter=",")
    np.savetxt(label_csv, rng.randint(0, 3, (7, 1)), delimiter=",")
    kw = dict(data_csv=data_csv, data_shape=(2, 3), label_csv=label_csv,
              batch_size=3, round_batch=round_batch)
    _same_epochs(_epochs(io.CSVIter(**kw)), _epochs(jmx.io.CSVIter(**kw)))
    kw.pop("label_csv")
    _same_epochs(_epochs(io.CSVIter(**kw)), _epochs(jmx.io.CSVIter(**kw)))


def _libsvm_epochs(it):
    """The CSR batches' arrays; ``indptr`` / ``indices`` widened to int64
    (asked as int64 by both; the reference's JAX keeps 32-bit ints)."""
    out = []
    for b in it:
        d = b.data[0]
        assert d.stype == "csr"
        out.append(([d.asnumpy(), d.todense().asnumpy(),
                     d.indptr.asnumpy().astype(np.int64),
                     d.indices.asnumpy().astype(np.int64), d.data.asnumpy()],
                    [b.label[0].asnumpy()], b.pad, None))
    it.reset()
    return out


@pytest.mark.parametrize("case", ["inline", "label_file", "keep", "parts"])
def test_libsvm_iter_matches_reference(tmp_path, case):
    p, lp = str(tmp_path / "d.svm"), str(tmp_path / "l.svm")
    with open(p, "w") as f:
        f.write("1 0:1.5 3:2.0\n0 1:0.5\n\n1 2:3.0 4:1.0 2:0.25\n"
                "0 0:0.25 4:4.0\n1 4:7.5\n")
    with open(lp, "w") as f:
        f.write("0:5.0\n0:7.0\n0:1.0\n\n0:2.0\n0:3.0\n")
    kw = dict(data_libsvm=p, data_shape=(5,), batch_size=2)
    if case == "label_file":
        kw["label_libsvm"] = lp
    elif case == "keep":
        kw["round_batch"] = False
    elif case == "parts":
        kw.update(num_parts=2, part_index=1)
    it, jt = io.LibSVMIter(**kw), jmx.io.LibSVMIter(**kw)
    assert it.provide_data == jt.provide_data
    first = it.next().data[0]
    assert isinstance(first, sparse.CSRNDArray)
    assert first.indptr.dtype == np.int64
    it.reset()
    _same_epochs(_libsvm_epochs(it) + _libsvm_epochs(it),
                 _libsvm_epochs(jt) + _libsvm_epochs(jt))


@pytest.mark.parametrize("gz", [True, False])
def test_mnist_iter_matches_reference(tmp_path, gz):
    rng = np.random.RandomState(2)
    imgs = rng.randint(0, 256, (11, 5, 4)).astype(np.uint8)
    labs = rng.randint(0, 10, 11).astype(np.uint8)
    opener = gzip.open if gz else open
    ext = ".gz" if gz else ""
    ip, lp = str(tmp_path / ("i" + ext)), str(tmp_path / ("l" + ext))
    with opener(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 11, 5, 4) + imgs.tobytes())
    with opener(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, 11) + labs.tobytes())
    for kw in (dict(batch_size=3, seed=4), dict(batch_size=4, flat=True,
                                                shuffle=False)):
        it = io.MNISTIter(image=ip, label=lp, **kw)
        jt = jmx.io.MNISTIter(image=ip, label=lp, **kw)
        assert it.provide_data == jt.provide_data
        _same_epochs(_epochs(it), _epochs(jt))


def test_resize_and_prefetching_iters_match_reference():
    rng = np.random.RandomState(3)
    x, y = rng.rand(10, 2).astype(np.float32), np.arange(10, dtype="f4")
    _same_epochs(_epochs(io.ResizeIter(NDArrayIter(x, y, 3), 5)),
                 _epochs(jmx.io.ResizeIter(jmx.io.NDArrayIter(x, y, 3), 5)))
    _same_epochs(_epochs(io.ResizeIter(NDArrayIter(x, y, 3), 2, False)),
                 _epochs(jmx.io.ResizeIter(jmx.io.NDArrayIter(x, y, 3), 2,
                                           False)))
    ports = io.PrefetchingIter([NDArrayIter(x, y, 4),
                                NDArrayIter(x * 2, y, 4)],
                               rename_data=[{"data": "a"}, {"data": "b"}],
                               depth=3)
    refs = jmx.io.PrefetchingIter([jmx.io.NDArrayIter(x, y, 4),
                                   jmx.io.NDArrayIter(x * 2, y, 4)],
                                  rename_data=[{"data": "a"},
                                               {"data": "b"}], depth=3)
    assert [d.name for d in ports.provide_data] == ["a", "b"]
    _same_epochs(_epochs(ports), _epochs(refs))
    assert ports._queue.maxsize == 3


@pytest.mark.parametrize("round_batch", [True, False])
def test_image_record_iter_matches_reference(tmp_path, round_batch):
    """Seeded (through the in-process pipeline), shuffled, augmented,
    host-normalized; ``round_batch`` pads the tail batch or keeps it
    partial."""
    rec, idx = cases.make_rec(tmp_path, n=10)
    kw = dict(path_imgrec=rec, path_imgidx=idx, batch_size=cases.BATCH,
              data_shape=(3, 28, 28), resize=34, rand_crop=True,
              rand_mirror=True, shuffle=True, seed=0,
              round_batch=round_batch, **cases.MEAN_STD)
    it = io.ImageRecordIter(**kw)
    jt = jmx.io.ImageRecordIter(**kw)
    assert type(it).__name__ == type(jt).__name__ == "ImagePipelineIter"
    got, want = _epochs(it), _epochs(jt)
    _same_epochs(got, want)
    assert [b[0][0].shape[0] for b in got] == \
        ([4, 4, 4] if round_batch else [4, 4, 2]) * 2
    # without a seed nor workers: ImageIter behind a prefetch thread
    plain = dict(kw, seed=None, shuffle=False, rand_crop=False,
                 rand_mirror=False)
    plain.pop("seed")
    it = io.ImageRecordIter(prefetch_buffer=3, **plain)
    assert isinstance(it, io.PrefetchingIter) and it._queue.maxsize == 3
    _same_epochs(_epochs(it), _epochs(jmx.io.ImageRecordIter(**plain)))


def test_image_record_iter_device_tail_on_the_cpu(tmp_path):
    """``device_tail=True``: the host ships uint8 NHWC and the feed runs
    the tail; on the CPU (``context.use``) the batches are bitwise the
    tail's arithmetic (true division) over the reference's uint8 stream,
    and within one float32 ulp of the reference's tail, whose XLA CPU
    build turns ``/ std`` into ``* (1 / std)``."""
    rec, idx = cases.make_rec(tmp_path, n=8)
    kw = dict(path_imgrec=rec, path_imgidx=idx, batch_size=cases.BATCH,
              data_shape=(3, 28, 28), resize=34, seed=0)
    with context.use("cpu"):
        it = io.ImageRecordIter(device_tail=True, **kw, **cases.MEAN_STD)
    assert isinstance(it, DeviceFeedIter)
    assert it.provide_data[0].shape == (cases.BATCH, 3, 28, 28)
    assert it.base.provide_data[0].dtype == np.uint8
    got = _epochs(it, 1)
    u8 = _epochs(jmx.io.ImageRecordIter(dtype="uint8", layout="NHWC", **kw),
                 1)
    want = _epochs(jmx.io.ImageRecordIter(device_tail=True, **kw,
                                          **cases.MEAN_STD), 1)
    assert len(got) == len(u8) == len(want) == 2
    for g, h, w in zip(got, u8, want):
        assert g[0][0].dtype == np.float32
        np.testing.assert_array_equal(
            g[0][0], cases.host_tail(h[0][0]).transpose(0, 3, 1, 2))
        assert cases.f32_ulps(g[0][0], w[0][0]) <= 1
        np.testing.assert_array_equal(g[1][0], w[1][0])


def test_image_det_record_iter_raises_naming_a10(tmp_path):
    """``ImageDetRecordIter`` no longer raises (ROADMAP.md A10(b) is
    ported): over records whose header holds one detection object each it
    yields CPU batches with (batch, 1, 5) labels, padded by the last
    record at the tail."""
    rng = np.random.RandomState(3)
    rec, idx = str(tmp_path / "det.rec"), str(tmp_path / "det.idx")
    wr = jmx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(6):
        label = np.array([2, 5, i % 2, 0.1, 0.2, 0.6, 0.7], np.float32)
        wr.write_idx(i, jmx.recordio.pack_img(
            jmx.recordio.IRHeader(0, label, i, 0), cases.image(rng)))
    wr.close()
    it = io.ImageDetRecordIter(path_imgrec=rec, path_imgidx=idx,
                               batch_size=4, data_shape=(3, 28, 28))
    got = _epochs(it, 1)
    assert [b[2] for b in got] == [0, 2]
    assert got[0][0][0].shape == (4, 3, 28, 28)
    assert got[0][1][0].shape == (4, 1, 5)
    np.testing.assert_allclose(got[1][1][0][1, 0], [1, 0.1, 0.2, 0.6, 0.7])


def test_device_feeds_with_transform_on_the_cpu():
    """The feeds apply ``transform`` to the data only, on their device
    (here the CPU); ``PrefetchToDeviceIter`` counts the transformed
    geometry from ``data_desc``."""
    rng = np.random.RandomState(5)
    u8 = rng.randint(0, 256, (12, 4, 4, 3)).astype(np.uint8)
    y = np.arange(12, dtype=np.float32)
    tail = make_device_tail(cases.MEAN, cases.STD, "float32", "NCHW")
    want = ((u8.astype(np.float32) - np.float32(cases.MEAN))
            / np.float32(cases.STD)).transpose(0, 3, 1, 2)
    desc = [io.DataDesc("data", (4, 3, 4, 4), np.float32, "NCHW")]
    for cls in (DeviceFeedIter, PrefetchToDeviceIter):
        feed = cls(NDArrayIter(u8, y, 4), transform=tail, depth=2,
                   data_desc=desc, device="cpu")
        got = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in feed]
        assert len(got) == 3 and feed.live_slots_max <= 2
        np.testing.assert_array_equal(np.concatenate([g[0] for g in got]),
                                      want)
        np.testing.assert_array_equal(np.concatenate([g[1] for g in got]),
                                      y)
    assert feed.batch_bytes() == 4 * 3 * 4 * 4 * 4 + 4 * 4
