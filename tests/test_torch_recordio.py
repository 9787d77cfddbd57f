"""mxnet_tpu_torch.recordio, ._native and tools.im2rec held against
mxnet_tpu's.

The files the port writes are byte for byte the reference's (``.rec`` and
``.idx``, scalar and array labels, every padding length); ``pack`` /
``unpack`` / ``pack_img`` / ``unpack_img`` give the same bytes and arrays;
the port's native runtime (the same ``native/mxtpu_io.cc``, built into
``mxnet_tpu_torch/_build/``) indexes, reads and decodes bitwise as the
reference's; ``im2rec`` makes the same ``.lst``, ``.rec`` and ``.idx``.
All exact: nothing here is floating-point arithmetic but OpenCV's and
libjpeg's, which both packages call the same way.
"""
import importlib.util
import os
import pickle

import numpy as np
import pytest

from mxnet_tpu import _native as jnative
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import _native
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.tools import im2rec

import torch_io_cases as cases

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(mod, tmp_path, name):
    rec = str(tmp_path / (name + ".rec"))
    idx = str(tmp_path / (name + ".idx"))
    w = mod.MXIndexedRecordIO(idx, rec, "w")
    for i in range(9):
        label = float(i) / 3 if i % 2 else \
            np.arange(i + 1, dtype=np.float32) - 0.25
        # payload lengths 0..8 cover every padding of the 4-byte frame
        w.write_idx(10 * i, mod.pack(mod.IRHeader(0, label, i, 7),
                                     bytes(range(i))))
    w.close()
    plain = str(tmp_path / (name + "_seq.rec"))
    s = mod.MXRecordIO(plain, "w")
    for i in range(5):
        s.write(b"x" * i)
    s.close()
    return [open(p, "rb").read() for p in (rec, idx, plain)]


def test_written_files_are_the_reference_bytes(tmp_path):
    assert _write(recordio, tmp_path, "port") == \
        _write(jrec, tmp_path, "ref")


@pytest.mark.parametrize("label", [3.0, [1.0, 2.0, 5.0], np.float32(0.5)])
def test_pack_unpack_match_reference(label):
    h = (0, np.asarray(label, np.float32) if isinstance(label, list)
         else label, 11, 2)
    got = recordio.pack(recordio.IRHeader(*h), b"payload")
    assert got == jrec.pack(jrec.IRHeader(*h), b"payload")
    gh, gp = recordio.unpack(got)
    rh, rp = jrec.unpack(got)
    assert gp == rp == b"payload"
    assert (gh.flag, gh.id, gh.id2) == (rh.flag, rh.id, rh.id2)
    np.testing.assert_array_equal(gh.label, rh.label)


@pytest.mark.parametrize("fmt,quality", [(".jpg", 90), (".png", 3)])
def test_pack_img_unpack_img_match_reference(fmt, quality):
    img = cases.image(np.random.RandomState(1))
    h = recordio.IRHeader(0, 4.0, 3, 0)
    got = recordio.pack_img(h, img, quality=quality, img_fmt=fmt)
    assert got == jrec.pack_img(jrec.IRHeader(0, 4.0, 3, 0), img,
                                quality=quality, img_fmt=fmt)
    for flag in (-1, 0, 1):
        gh, gimg = recordio.unpack_img(got, flag)
        rh, rimg = jrec.unpack_img(got, flag)
        np.testing.assert_array_equal(gimg, rimg)
        assert gh == rh


def test_readers_and_pickling(tmp_path):
    rec, idx = cases.make_rec(tmp_path, n=6)
    r = recordio.MXIndexedRecordIO(idx, rec, "r")
    j = jrec.MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == j.keys == list(range(6))
    for k in (4, 0, 5):
        assert r.read_idx(k) == j.read_idx(k)
    # positional reads never move the sequential cursor
    assert r.read() == j.read()
    assert r.read_at(r.idx[3]) == j.read_at(j.idx[3])
    assert r.read() == j.read()
    r.seek(2)
    j.seek(2)
    assert r.read() == j.read()
    # a pickled reader reopens its own handle (DataLoader workers), and
    # the reader pickled stays open for the next worker's copy
    r2 = pickle.loads(pickle.dumps(r))
    r3 = pickle.loads(pickle.dumps(r))
    assert r2.read_idx(5) == r3.read_idx(5) == r.read_idx(5) == \
        j.read_idx(5)
    r.reset()
    assert r.tell() == 0
    for h in (r, r2, r3, j):
        h.close()
    # a continuation record (a dmlc writer's split payload) is refused
    bad = str(tmp_path / "cont.rec")
    with open(bad, "wb") as f:
        f.write(np.array([0xCED7230A, (1 << 29) | 4], "<u4").tobytes()
                + b"abcd")
    with pytest.raises(IOError, match="continuation"):
        recordio.MXRecordIO(bad, "r").read()


def test_native_runtime_matches_reference(tmp_path):
    """Index, read and batch decode (resize-short, center crop, and the
    crop-then-grow of an image smaller than the target) bitwise."""
    assert _native.available() and jnative.available()
    rec, idx = cases.make_rec(tmp_path, n=5)
    offs = _native.recordio_index(rec)
    assert offs == jnative.recordio_index(rec)
    bufs = []
    for o in offs:
        raw = _native.recordio_read(rec, o)
        assert raw == jnative.recordio_read(rec, o)
        bufs.append(recordio.unpack(raw)[1])
    for h, w, short, threads in ((32, 32, 36, 2), (28, 20, 0, 1),
                                 (64, 64, 0, 0)):
        got, gfail = _native.decode_batch(bufs, h, w, 3, short, threads)
        want, wfail = jnative.decode_batch(bufs, h, w, 3, short, threads)
        assert gfail == wfail == 0
        np.testing.assert_array_equal(got, want)
    # a corrupt buffer is counted and zero-filled, as in the reference
    got, fails = _native.decode_batch([b"\xff\xd8junk"] + bufs[:1], 8, 8)
    assert fails == 1 and not got[0].any() and got[1].any()


def test_native_builds_into_the_port_build_dir():
    so = _native.library_path()
    assert os.path.dirname(so) == os.path.join(REPO, "mxnet_tpu_torch",
                                               "_build")
    assert _native._SRC == os.path.join(REPO, "native", "mxtpu_io.cc")
    assert _native.get_lib() is not None and os.path.isfile(so)


def _reference_im2rec():
    spec = importlib.util.spec_from_file_location(
        "reference_im2rec", os.path.join(REPO, "tools", "im2rec.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [[], ["--resize", "24", "--center-crop",
                                        "--quality", "80", "--num-thread",
                                        "2"], ["--pass-through"]])
def test_im2rec_matches_reference(tmp_path, extra):
    root = tmp_path / "images"
    rng = np.random.RandomState(3)
    for cls in ("cat", "dog"):
        (root / cls).mkdir(parents=True)
        for i in range(3):
            cv2.imwrite(str(root / cls / ("%d.jpg" % i)),
                        cases.image(rng, 30 + 4 * i, 40))
    ref = _reference_im2rec()
    out = {}
    for name, mod in (("port", im2rec), ("ref", ref)):
        d = tmp_path / name
        d.mkdir()
        prefix = str(d / "set")
        lst = ["--list", "--recursive", prefix, str(root)]
        mod.make_list(mod.parse_args(lst))
        mod.make_rec(mod.parse_args([prefix, str(root)] + extra))
        out[name] = [open(prefix + ext, "rb").read()
                     for ext in (".lst", ".rec", ".idx")]
    assert out["port"] == out["ref"]
    assert len(out["port"][1]) > 0
