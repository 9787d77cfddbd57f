"""mxnet_tpu_torch.gluon.data held against mxnet_tpu.gluon.data, bitwise.

Datasets, samplers, the ``DataLoader`` and the vision transforms are numpy
and OpenCV on the host in both packages, so every check is exact: the
order of ``SequentialSampler`` / ``RandomSampler`` / ``BatchSampler``
(keep, discard, rollover) after one ``np.random.seed``; ``DataLoader``
batches at ``num_workers`` 0 and 2 and on a thread pool against the
reference's in-process loader (``shuffle``, ``last_batch``, a custom
``batchify_fn``, ``pin_memory``); every transform on NDArray and numpy
inputs under one seed; the dataset API; MNIST, FashionMNIST, CIFAR10 and
CIFAR100 from local files; ``ImageRecordDataset``,
``ImageFolderDataset`` and ``RecordFileDataset``.  The port's host items
are CPU NDArrays; its loader makes each batch on the current context
(here ``context.use("cpu")``).
"""
import functools
import gzip
import random
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as JT
from mxnet_tpu_torch import context, nd
from mxnet_tpu_torch.gluon import data
from mxnet_tpu_torch.gluon.data.vision import transforms as T

import torch_io_cases as cases

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True)
def on_the_cpu():
    with context.use("cpu"):
        yield


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _seed(s):
    random.seed(s)
    np.random.seed(s)


@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_samplers_match_reference(last):
    for mod in (data, jdata):
        assert list(mod.SequentialSampler(5)) == [0, 1, 2, 3, 4]
    orders = []
    for mod in (data, jdata):
        _seed(3)
        bs = mod.BatchSampler(mod.RandomSampler(11), 4, last)
        orders.append([list(bs), list(bs), len(bs)])
    assert orders[0] == orders[1]


def _images(n=10, seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([cases.image(rng, 12, 14) for _ in range(n)])


@pytest.mark.parametrize("workers", ["0", "2", "thread_pool"])
def test_dataloader_order_matches_reference(workers):
    x, y = _images(), np.arange(10, dtype=np.float32)
    tf = T.Compose([T.ToTensor(), T.Normalize(cases.MEAN, cases.STD)])
    jtf = JT.Compose([JT.ToTensor(), JT.Normalize(cases.MEAN, cases.STD)])
    ds = data.ArrayDataset(x, y).transform_first(tf)
    jds = jdata.ArrayDataset(x, y).transform_first(jtf)
    kw = dict(num_workers=0 if workers == "0" else 2,
              thread_pool=workers == "thread_pool")
    for opts in (dict(batch_size=4, shuffle=True),
                 dict(batch_size=3, last_batch="discard", pin_memory=True),
                 dict(batch_size=4, last_batch="rollover", shuffle=True)):
        loader = data.DataLoader(ds, **opts, **kw)
        ref = jdata.DataLoader(jds, **{k: v for k, v in opts.items()
                                       if k != "pin_memory"})
        for epoch in range(2):
            _seed(epoch)
            got = list(loader)
            _seed(epoch)
            want = list(ref)
            assert all(b[0].context.type == "cpu" for b in got)
            _same(got, want)
        assert len(loader) == len(ref)
        loader.shutdown()
    # a custom batchify_fn runs in the workers and its batch is returned
    # as it is (the worker-side numpy batchify; functions the workers can
    # import without this test module, which imports JAX)
    fill = functools.partial(np.full, (2,), dtype=np.float32)
    sds = data.SimpleDataset(list(range(9))).transform(fill)
    batchify = data.dataloader.default_mp_batchify_fn
    loader = data.DataLoader(data.ArrayDataset(sds, list(range(9))), 4,
                             batchify_fn=batchify, **kw)
    jloader = jdata.DataLoader(
        jdata.ArrayDataset(jdata.SimpleDataset(list(range(9))).transform(
            fill), list(range(9))), 4,
        batchify_fn=jdata.dataloader.default_mp_batchify_fn)
    got = list(loader)
    assert isinstance(got[0][0], np.ndarray)
    _same(got, list(jloader))
    loader.shutdown()


TRANSFORMS = {
    "Compose": lambda m: m.Compose([m.Resize(10), m.ToTensor()]),
    "Cast": lambda m: m.Cast("float16"),
    "ToTensor": lambda m: m.ToTensor(),
    "Normalize": lambda m: m.Compose([m.ToTensor(),
                                      m.Normalize((0.4, 0.5, 0.6),
                                                  (0.2, 0.25, 0.3))]),
    "Resize": lambda m: m.Resize((9, 7)),
    "Resize_keep_ratio": lambda m: m.Resize(10, keep_ratio=True),
    "CenterCrop": lambda m: m.CenterCrop(8),
    "RandomResizedCrop": lambda m: m.RandomResizedCrop(8),
    "RandomFlipLeftRight": lambda m: m.RandomFlipLeftRight(),
    "RandomFlipTopBottom": lambda m: m.RandomFlipTopBottom(),
    "RandomBrightness": lambda m: m.RandomBrightness(0.3),
    "RandomContrast": lambda m: m.RandomContrast(0.3),
    "RandomSaturation": lambda m: m.RandomSaturation(0.3),
    "RandomHue": lambda m: m.RandomHue(0.2),
    "RandomColorJitter": lambda m: m.RandomColorJitter(0.2, 0.2, 0.2, 0.1),
    "RandomLighting": lambda m: m.RandomLighting(0.1),
    "RandomGray": lambda m: m.RandomGray(0.5),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_each_transform_matches_reference(name):
    img = _images(1, seed=4)[0]
    for s in range(4):
        _seed(s)
        t = TRANSFORMS[name](T)
        got = t(nd.array(img, ctx="cpu", dtype=np.uint8))
        _seed(s)
        jt = TRANSFORMS[name](JT)
        _same(got, jt(jmx.nd.array(img, dtype=np.uint8)))
        assert got.context.type == "cpu"
        # numpy in: the same values (a transform that leaves its input
        # hands the numpy array back, in both packages)
        _seed(s)
        got = TRANSFORMS[name](T)(img)
        _seed(s)
        _same(got, TRANSFORMS[name](JT)(img))


def test_dataset_api_matches_reference():
    for mod in (data, jdata):
        ds = mod.SimpleDataset(list(range(7)))
        assert [ds.filter(lambda v: v % 2)[i] for i in range(3)] == [1, 3, 5]
        assert len(ds.take(3)) == 3 and ds.take(30)[6] == 6
        eager = ds.transform(lambda v: v * 2, lazy=False)
        assert isinstance(eager, mod.SimpleDataset) and eager[3] == 6
        pairs = mod.ArrayDataset(np.arange(4), [10, 11, 12, 13])
        assert pairs.transform_first(lambda v: v + 1)[2] == (3, 12)
        single = mod.ArrayDataset(np.arange(4))
        assert single.transform_first(lambda v: v * 3)[3] == 9
    with pytest.raises(AssertionError):
        data.ArrayDataset(np.arange(3), np.arange(4))


def _write_mnist(root, prefix, n, rng):
    imgs = rng.randint(0, 256, (n, 6, 5)).astype(np.uint8)
    labs = rng.randint(0, 10, n).astype(np.uint8)
    with gzip.open(root / (prefix + "-images-idx3-ubyte.gz"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 6, 5) + imgs.tobytes())
    with open(root / (prefix + "-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labs.tobytes())


def _ds_items(ds):
    return [(_np(ds[i][0]), _np(ds[i][1])) for i in range(len(ds))]


def test_local_vision_datasets_match_reference(tmp_path):
    rng = np.random.RandomState(6)
    mnist = tmp_path / "mnist"
    mnist.mkdir()
    _write_mnist(mnist, "train", 5, rng)
    _write_mnist(mnist, "t10k", 3, rng)
    c10 = tmp_path / "c10" / "cifar-10-batches-bin"
    c10.mkdir(parents=True)
    for name in ["data_batch_%d.bin" % i for i in range(1, 6)] + \
            ["test_batch.bin"]:
        (c10 / name).write_bytes(rng.randint(0, 256, 2 * 3073).astype(
            np.uint8).tobytes())
    c100 = tmp_path / "c100"
    c100.mkdir()
    for name in ("train.bin", "test.bin"):
        (c100 / name).write_bytes(rng.randint(0, 256, 3 * 3074).astype(
            np.uint8).tobytes())
    cases_ = [("MNIST", dict(root=str(mnist))),
              ("MNIST", dict(root=str(mnist), train=False)),
              ("FashionMNIST", dict(root=str(mnist))),
              ("CIFAR10", dict(root=str(tmp_path / "c10"))),
              ("CIFAR10", dict(root=str(tmp_path / "c10"), train=False)),
              ("CIFAR100", dict(root=str(c100))),
              ("CIFAR100", dict(root=str(c100), fine_label=True,
                                train=False))]
    for name, kw in cases_:
        ds = getattr(data.vision, name)(**kw)
        jds = getattr(jdata.vision, name)(**kw)
        assert len(ds) == len(jds) > 0
        for (g, gl), (w, wl) in zip(_ds_items(ds), _ds_items(jds)):
            _same(g, w)
            _same(gl, wl)
        assert ds[0][0].context.type == "cpu"
    tf = data.vision.MNIST(root=str(mnist), transform=lambda d, lab:
                           (d.astype("float32") / 255, lab + 1))
    jtf = jdata.vision.MNIST(root=str(mnist), transform=lambda d, lab:
                             (d.astype("float32") / 255, lab + 1))
    for (g, gl), (w, wl) in zip(_ds_items(tf), _ds_items(jtf)):
        _same(g, w)
        _same(gl, wl)
    with pytest.raises(FileNotFoundError, match="no network"):
        data.vision.MNIST(root=str(tmp_path / "empty"))


def test_record_and_folder_datasets_match_reference(tmp_path):
    rec, _ = cases.make_rec(tmp_path, n=5)
    raw, jraw = data.RecordFileDataset(rec), jdata.RecordFileDataset(rec)
    assert len(raw) == 5 and [raw[i] for i in range(5)] == \
        [jraw[i] for i in range(5)]
    for flag in (1, 0):
        ds = data.vision.ImageRecordDataset(rec, flag=flag)
        jds = jdata.vision.ImageRecordDataset(rec, flag=flag)
        for (g, gl), (w, wl) in zip(_ds_items(ds), _ds_items(jds)):
            _same(g, w)
            np.testing.assert_array_equal(gl, wl)
    tf = T.Compose([T.RandomResizedCrop(16), T.RandomFlipLeftRight(),
                    T.ToTensor(), T.Normalize(cases.MEAN, cases.STD)])
    jtf = JT.Compose([JT.RandomResizedCrop(16), JT.RandomFlipLeftRight(),
                      JT.ToTensor(), JT.Normalize(cases.MEAN, cases.STD)])
    _seed(2)
    got = _ds_items(data.vision.ImageRecordDataset(rec).transform_first(tf))
    _seed(2)
    want = _ds_items(jdata.vision.ImageRecordDataset(rec).transform_first(
        jtf))
    for (g, gl), (w, wl) in zip(got, want):
        _same(g, w)
        np.testing.assert_array_equal(gl, wl)
    root = tmp_path / "folder"
    rng = np.random.RandomState(8)
    for cls in ("b", "a"):
        (root / cls).mkdir(parents=True)
        for i in range(2):
            cv2.imwrite(str(root / cls / ("%d.png" % i)),
                        cases.image(rng, 10, 12))
    (root / "a" / "notes.txt").write_text("not an image")
    ds = data.vision.ImageFolderDataset(str(root))
    jds = jdata.vision.ImageFolderDataset(str(root))
    assert ds.synsets == jds.synsets == ["a", "b"]
    assert ds.items == jds.items
    for (g, gl), (w, wl) in zip(_ds_items(ds), _ds_items(jds)):
        _same(g, w)
        assert gl == wl
