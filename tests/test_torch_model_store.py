"""``gluon.model_zoo.model_store`` and ``gluon.utils.download`` of
mxnet_tpu_torch held against mxnet_tpu's, scenario by scenario (the flow
of ``tests/test_model_store.py``): each resolves the same files in the
same order, returns the same path or raises the same kind of error.

- a plain ``{name}.params`` under ``$MXNET_HOME/models``, then
  ``get_model(name, pretrained=True)`` giving the saving net's logits
  (1e-5; the file written by the reference, loaded by the port);
- a ``file://`` repo (``MXNET_GLUON_REPO``) with a registered SHA-1: the
  catalog name copied into ``root`` and verified, found again with the
  repo gone, a corrupted copy not trusted (``IOError``);
- a SHA-1 that does not match the repo's file (``IOError``, the
  temporary file gone);
- a missing model (``FileNotFoundError``) and an unknown catalog name
  (``ValueError`` from ``short_hash``);
- ``purge`` removes the ``.params`` files;
- ``http(s)://`` raises before anything is tried (the port fetches only
  ``file://``; the reference would try the network).
"""
import hashlib
import os

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon import utils as jutils
from mxnet_tpu.gluon.model_zoo import model_store as jstore
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.gluon import utils
from mxnet_tpu_torch.gluon.model_zoo import model_store, vision

NAME = "resnet18_v1"
KW = dict(classes=10, thumbnail=True)
STORES = (jstore, model_store)


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


@pytest.fixture
def catalog():
    yield
    for s in STORES:
        s._model_sha1.pop(NAME, None)


def _sha1(path):
    with open(path, "rb") as f:
        return hashlib.sha1(f.read()).hexdigest()


def _save_reference(path):
    """A reference zoo net's parameters in ``path``; the net."""
    net = jvision.get_model(NAME, **KW)
    np.random.seed(0)
    net.initialize(mx.init.Xavier())
    net(mx.nd.zeros((1, 3, 32, 32)))
    net.save_parameters(str(path))
    return net


def _both(fn):
    """``fn(store)`` for the reference's store and the port's: the
    results, or the exceptions' classes."""
    out = []
    for s in STORES:
        try:
            out.append(fn(s))
        except Exception as e:
            out.append(type(e))
    return out


def test_plain_local_file_and_pretrained(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_HOME", str(tmp_path))
    root = tmp_path / "models"
    root.mkdir()
    jnet = _save_reference(root / (NAME + ".params"))
    want = str(root / (NAME + ".params"))
    assert _both(lambda s: s.get_model_file(NAME)) == [want, want]
    assert model_store.get_model_root() == str(tmp_path)
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    net = vision.get_model(NAME, pretrained=True, ctx="cpu", **KW)
    np.testing.assert_allclose(net(nd.array(x)).asnumpy(),
                               jnet(mx.nd.array(x)).asnumpy(), rtol=1e-5,
                               atol=1e-5)
    assert {p.data().context.type for p in
            net.collect_params().values()} == {"cpu"}


def test_file_repo_with_sha1(tmp_path, monkeypatch, catalog):
    params = tmp_path / "w.params"
    _save_reference(params)
    sha1 = _sha1(params)
    for s in STORES:
        s.register_model_sha1(NAME, sha1)
    fname = "%s-%s.params" % (NAME, model_store.short_hash(NAME))
    assert jstore.short_hash(NAME) == model_store.short_hash(NAME)
    repo = tmp_path / "repo" / "gluon" / "models"
    repo.mkdir(parents=True)
    os.replace(params, repo / fname)
    monkeypatch.setenv("MXNET_GLUON_REPO",
                       "file://" + str(tmp_path / "repo") + "/")
    roots = [tmp_path / "ref", tmp_path / "port"]
    got = [s.get_model_file(NAME, root=str(r)) for s, r in zip(STORES,
                                                               roots)]
    assert got == [str(r / fname) for r in roots]
    assert {_sha1(g) for g in got} == {sha1}
    # verified copies resolve with the repo gone
    (repo / fname).unlink()
    assert [s.get_model_file(NAME, root=str(r))
            for s, r in zip(STORES, roots)] == got
    # a corrupted copy is not trusted and cannot be fetched again
    for g in got:
        with open(g, "r+b") as f:
            f.write(b"corrupt")
    assert [_both(lambda s, r=r: s.get_model_file(NAME, root=str(r)))[i]
            for i, r in enumerate(roots)] == [IOError, IOError]


def test_pretrained_through_a_file_repo(tmp_path, monkeypatch, catalog):
    params = tmp_path / "w.params"
    jnet = _save_reference(params)
    model_store.register_model_sha1(NAME, _sha1(params))
    repo = tmp_path / "repo" / "gluon" / "models"
    repo.mkdir(parents=True)
    os.replace(params, repo / ("%s-%s.params"
                               % (NAME, model_store.short_hash(NAME))))
    monkeypatch.setenv("MXNET_GLUON_REPO", (tmp_path / "repo").as_uri())
    net = vision.get_model(NAME, pretrained=True, root=str(tmp_path / "c"),
                           ctx="cpu", **KW)
    x = np.random.RandomState(1).rand(1, 3, 32, 32).astype(np.float32)
    np.testing.assert_allclose(net(nd.array(x)).asnumpy(),
                               jnet(mx.nd.array(x)).asnumpy(), rtol=1e-5,
                               atol=1e-5)


def test_sha1_mismatch_raises(tmp_path, monkeypatch, catalog):
    params = tmp_path / "w.params"
    _save_reference(params)
    for s in STORES:
        s.register_model_sha1(NAME, "0" * 40)
    repo = tmp_path / "repo" / "gluon" / "models"
    repo.mkdir(parents=True)
    os.replace(params, repo / ("%s-00000000.params" % NAME))
    monkeypatch.setenv("MXNET_GLUON_REPO",
                       "file://" + str(tmp_path / "repo"))
    roots = [tmp_path / "ref", tmp_path / "port"]
    assert [_both(lambda s, r=r: s.get_model_file(NAME, root=str(r)))[i]
            for i, r in enumerate(roots)] == [IOError, IOError]
    # no temporary file is left beside the target
    assert [p.name for p in roots[1].iterdir()] == \
        ["%s-00000000.params" % NAME]


def test_missing_model_and_unknown_catalog_name(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_HOME", str(tmp_path))
    assert _both(lambda s: s.get_model_file(NAME)) == [FileNotFoundError] * 2
    assert _both(lambda s: s.short_hash("no_such_model")) == [ValueError] * 2
    with pytest.raises(FileNotFoundError):
        vision.get_model(NAME, pretrained=True, ctx="cpu", **KW)


def test_purge(tmp_path):
    for s, d in zip(STORES, ("ref", "port")):
        root = tmp_path / d
        root.mkdir()
        (root / "a.params").write_bytes(b"x")
        (root / "keep.txt").write_bytes(b"x")
        s.purge(str(root))
        assert [p.name for p in root.iterdir()] == ["keep.txt"]
    model_store.purge(str(tmp_path / "absent"))


@pytest.mark.parametrize("url", [
    "https://example.com/gluon/models/x.params",
    "http://example.com/x.params",
    "file://otherhost/tmp/x.params"])
def test_download_refuses_anything_but_local_files(url, tmp_path):
    with pytest.raises(MXNetError, match="file://"):
        utils.download(url, str(tmp_path / "x.params"))
    assert list(tmp_path.iterdir()) == []


def test_download_of_a_file_url(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(b"abc" * 1000)
    sha1 = _sha1(src)
    url = src.as_uri()
    for d in ("ref", "port"):
        (tmp_path / d).mkdir()
    got = [m.download(url, str(tmp_path / d), sha1_hash=sha1)
           for m, d in ((jutils, "ref"), (utils, "port"))]
    assert got == [str(tmp_path / d / "src.bin") for d in ("ref", "port")]
    assert (tmp_path / "port" / "src.bin").read_bytes() == src.read_bytes()
    # present and verified: not copied again
    src.write_bytes(b"changed")
    assert utils.download(url, got[1], sha1_hash=sha1) == got[1]
    assert utils.download(url, got[1], overwrite=True) == got[1]
    assert (tmp_path / "port" / "src.bin").read_bytes() == b"changed"
    assert utils.get_repo_url() == jutils.get_repo_url()
