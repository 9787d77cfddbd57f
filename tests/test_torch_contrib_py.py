"""``contrib`` of mxnet_tpu_torch (``text``, ``io``, ``autograd``,
``tensorboard``) and the rest of ``tests/test_contrib_py.py``'s surface,
held against mxnet_tpu on the CPU.

- ``contrib.text``: every case of ``tests/test_contrib_text.py`` through
  the port (its hosted-catalog case on a local ``file://`` repo, the
  only kind ``gluon.utils.download`` copies), each also run through the
  reference with the token lists, indices and vectors held equal
  (bitwise: both parse the same text into float32).  The vectors are an
  NDArray on the caller's device.
- ``contrib.io.DataLoaderIter``, the old ``contrib.autograd`` API and
  ``contrib.tensorboard.LogMetricsCallback`` (the same scalars written
  through a stand-in writer in both packages; ``ImportError`` in both
  when no writer imports).
- The cases of ``tests/test_contrib_py.py`` no other port test holds:
  the vocabulary, the custom embedding, the old autograd API, the
  ``DataLoader`` bridge, ``name.Prefix`` / ``AttrScope``,
  ``NameManager`` and an import with a stray ``DMLC_ROLE``.
"""
import hashlib
import os
import subprocess
import sys
import types
import warnings
import zipfile

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.context import use

PKGS = {"ref": jmx, "port": tmx}


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _sha1(path):
    with open(path, "rb") as f:
        return hashlib.sha1(f.read()).hexdigest()


def _write_vec_file(path, rows, header=None, delim=" "):
    with open(path, "w") as f:
        if header:
            f.write(header + "\n")
        for tok, vec in rows:
            f.write(tok + delim + delim.join(str(v) for v in vec) + "\n")


def _state(emb):
    """What an embedding holds: tokens, indices, the vector table."""
    return (list(emb.idx_to_token), dict(emb.token_to_idx), emb.vec_len,
            emb.idx_to_vec.asnumpy())


def _same(make):
    """``make(pkg)`` for both packages: their embeddings' states equal;
    returns the port's embedding."""
    want = _state(make(jmx))
    got_emb = make(tmx)
    got = _state(got_emb)
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])
    return got_emb


# -- contrib.text: tests/test_contrib_text.py ------------------------------
def test_custom_embedding_loads_and_indexes(tmp_path):
    p = tmp_path / "emb.txt"
    _write_vec_file(p, [("hello", [1, 2]), ("world", [3, 4])])
    emb = _same(lambda mx: mx.contrib.text.CustomEmbedding(str(p)))
    assert emb.vec_len == 2 and len(emb) == 3
    assert emb.idx_to_vec._data.device.type == "cpu"
    np.testing.assert_allclose(emb.get_vecs_by_tokens("world").asnumpy(),
                               [3, 4])
    np.testing.assert_allclose(emb.get_vecs_by_tokens("nope").asnumpy(),
                               [0, 0])
    np.testing.assert_allclose(
        emb.get_vecs_by_tokens(["world", "hello"]).asnumpy(),
        [[3, 4], [1, 2]])


def test_custom_embedding_duplicate_and_header_rows(tmp_path):
    p = tmp_path / "emb.txt"
    _write_vec_file(p, [("a", [1, 1]), ("a", [9, 9]), ("b", [2, 2])],
                    header="2 2")
    with pytest.warns(UserWarning):
        emb = tmx.contrib.text.CustomEmbedding(str(p))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _same(lambda mx: mx.contrib.text.CustomEmbedding(str(p)))
    np.testing.assert_allclose(emb.get_vecs_by_tokens("a").asnumpy(), [1, 1])
    assert "2" not in emb.token_to_idx


def test_custom_embedding_unknown_token_vector_from_file(tmp_path):
    p = tmp_path / "emb.txt"
    _write_vec_file(p, [("<unk>", [7, 7]), ("a", [1, 1])])
    emb = _same(lambda mx: mx.contrib.text.CustomEmbedding(str(p)))
    np.testing.assert_allclose(emb.get_vecs_by_tokens("missing").asnumpy(),
                               [7, 7])


def test_custom_embedding_with_vocabulary(tmp_path):
    p = tmp_path / "emb.txt"
    _write_vec_file(p, [("a", [1, 1]), ("b", [2, 2]), ("c", [3, 3])])

    def make(mx):
        text = mx.contrib.text
        vocab = text.Vocabulary(text.count_tokens_from_str("a b b zzz"))
        return text.CustomEmbedding(str(p), vocabulary=vocab)
    emb = _same(make)
    assert set(emb.token_to_idx) == {"<unk>", "a", "b", "zzz"}
    vec = emb.idx_to_vec.asnumpy()
    np.testing.assert_allclose(vec[emb.token_to_idx["zzz"]], [0, 0])
    np.testing.assert_allclose(vec[emb.token_to_idx["b"]], [2, 2])


def test_update_token_vectors(tmp_path):
    p = tmp_path / "emb.txt"
    _write_vec_file(p, [("a", [1, 1]), ("b", [2, 2])])

    def make(mx):
        emb = mx.contrib.text.CustomEmbedding(str(p))
        emb.update_token_vectors("a", mx.nd.array([5.0, 6.0]))
        with pytest.raises(ValueError):
            emb.update_token_vectors("unseen", mx.nd.array([1.0, 1.0]))
        emb.update_token_vectors("<unk>", mx.nd.array([9.0, 9.0]))
        return emb
    emb = _same(make)
    np.testing.assert_allclose(emb.get_vecs_by_tokens("a").asnumpy(), [5, 6])
    np.testing.assert_allclose(emb.get_vecs_by_tokens("unseen").asnumpy(),
                               [9, 9])


def test_lower_case_backup(tmp_path):
    p = tmp_path / "emb.txt"
    _write_vec_file(p, [("hello", [1, 2])])
    emb = _same(lambda mx: mx.contrib.text.CustomEmbedding(str(p)))
    np.testing.assert_allclose(
        emb.get_vecs_by_tokens("HELLO", lower_case_backup=True).asnumpy(),
        [1, 2])
    np.testing.assert_allclose(emb.get_vecs_by_tokens("HELLO").asnumpy(),
                               [0, 0])


def test_composite_embedding_concatenates(tmp_path):
    p1, p2 = tmp_path / "e1.txt", tmp_path / "e2.txt"
    _write_vec_file(p1, [("a", [1, 1]), ("b", [2, 2])])
    _write_vec_file(p2, [("b", [30, 30, 30]), ("c", [40, 40, 40])])

    def make(mx):
        text = mx.contrib.text
        vocab = text.Vocabulary(text.count_tokens_from_str("a b c"))
        return text.CompositeEmbedding(vocab, [text.CustomEmbedding(str(p1)),
                                               text.CustomEmbedding(str(p2))])
    comp = _same(make)
    assert comp.vec_len == 5
    np.testing.assert_allclose(comp.get_vecs_by_tokens("b").asnumpy(),
                               [2, 2, 30, 30, 30])
    np.testing.assert_allclose(comp.get_vecs_by_tokens("a").asnumpy(),
                               [1, 1, 0, 0, 0])
    np.testing.assert_allclose(comp.get_vecs_by_tokens("c").asnumpy(),
                               [0, 0, 40, 40, 40])


def test_registry_create_and_catalog():
    text = tmx.contrib.text
    names = text.embedding.get_pretrained_file_names()
    assert "glove" in names and "fasttext" in names
    for kind in ("glove", "fasttext"):
        assert text.embedding.get_pretrained_file_names(kind) == \
            jmx.contrib.text.embedding.get_pretrained_file_names(kind)
    with pytest.raises(KeyError):
        text.GloVe(pretrained_file_name="not_in_catalog.txt")


def _tiny_class(pkg):
    """A catalog-driven embedding class served from a file:// repo,
    registered in ``pkg``'s registry."""
    text = pkg.contrib.text

    class TinyTestEmbedding(text.embedding.TokenEmbedding):
        pretrained_file_name_sha1 = {}
        pretrained_archive_name_sha1 = {}

        @classmethod
        def _get_download_file_name(cls, pretrained_file_name):
            return os.path.splitext(pretrained_file_name)[0] + ".zip"

        def __init__(self, pretrained_file_name="tiny.vec",
                     embedding_root="~/.mxnet_tpu/embeddings",
                     init_unknown_vec=pkg.nd.zeros, vocabulary=None, **kw):
            self._check_pretrained_file_names(pretrained_file_name)
            super().__init__(**kw)
            path = self._get_pretrained_file(embedding_root,
                                             pretrained_file_name)
            self._load_embedding(path, " ", init_unknown_vec)
            self._build_embedding_for_vocabulary(vocabulary)
    return text.embedding.register(TinyTestEmbedding)


def test_hosted_embedding_download_verify_extract(tmp_path, monkeypatch):
    repo = tmp_path / "repo" / "gluon" / "embeddings" / "tinytestembedding"
    repo.mkdir(parents=True)
    vec = tmp_path / "tiny.vec"
    _write_vec_file(vec, [("a", [1, 2, 3]), ("b", [4, 5, 6])],
                    header="2 3")
    zpath = repo / "tiny.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        zf.write(vec, "tiny.vec")
    monkeypatch.setenv("MXNET_GLUON_REPO",
                       "file://" + str(tmp_path / "repo") + "/")
    states = {}
    for key, pkg in PKGS.items():
        cls = _tiny_class(pkg)
        cls.pretrained_file_name_sha1 = {"tiny.vec": _sha1(str(vec))}
        cls.pretrained_archive_name_sha1 = {"tiny.zip": _sha1(str(zpath))}
        root = tmp_path / ("cache_" + key)
        with pytest.warns(UserWarning):
            emb = pkg.contrib.text.embedding.create(
                "tinytestembedding", pretrained_file_name="tiny.vec",
                embedding_root=str(root))
        states[key] = _state(emb)
        cached = root / "tinytestembedding" / "tiny.vec"
        assert cached.exists()
        assert pkg.gluon.utils.check_sha1(str(cached), _sha1(str(vec)))
    assert states["port"][:3] == states["ref"][:3]
    np.testing.assert_array_equal(states["port"][3], states["ref"][3])
    np.testing.assert_allclose(states["port"][3][2], [4, 5, 6])
    # the verified cache is used without the repo
    zpath.unlink()
    with pytest.warns(UserWarning):
        emb2 = cls(pretrained_file_name="tiny.vec",
                   embedding_root=str(tmp_path / "cache_port"))
    assert emb2.vec_len == 3


def test_hosted_embedding_refuses_a_network_url(tmp_path, monkeypatch):
    """With the default repo (an https URL) and no cached file, the port
    copies nothing and raises before any network access."""
    monkeypatch.delenv("MXNET_GLUON_REPO", raising=False)
    with pytest.raises(tmx.MXNetError, match="file://"):
        tmx.contrib.text.GloVe(pretrained_file_name="glove.6B.50d.txt",
                               embedding_root=str(tmp_path))
    assert not any(tmp_path.rglob("*.txt"))


def test_reserved_tokens_keep_vectors_aligned(tmp_path):
    p = tmp_path / "emb.txt"
    _write_vec_file(p, [("a", [1, 1]), ("b", [2, 2])])
    emb = _same(lambda mx: mx.contrib.text.CustomEmbedding(
        str(p), reserved_tokens=["<pad>", "<bos>"]))
    assert emb.to_indices("a") == 3
    np.testing.assert_allclose(emb.get_vecs_by_tokens("a").asnumpy(), [1, 1])
    np.testing.assert_allclose(emb.get_vecs_by_tokens("b").asnumpy(), [2, 2])
    np.testing.assert_allclose(emb.get_vecs_by_tokens("<pad>").asnumpy(),
                               [0, 0])


def test_fasttext_catalog_archives_complete():
    text = tmx.contrib.text
    for f in text.embedding.get_pretrained_file_names("fasttext"):
        archive = text.FastText._get_download_file_name(f)
        assert archive in text.FastText.pretrained_archive_name_sha1, f
    for f in text.embedding.get_pretrained_file_names("glove"):
        archive = text.GloVe._get_download_file_name(f)
        assert archive in text.GloVe.pretrained_archive_name_sha1, f
    assert text.GloVe.pretrained_file_name_sha1 == \
        jmx.contrib.text.GloVe.pretrained_file_name_sha1


def test_embedding_vectors_feed_a_gluon_embedding(tmp_path):
    """The table copied into ``gluon.nn.Embedding``: lookups bitwise."""
    rng = np.random.RandomState(0)
    toks = ["t%d" % i for i in range(50)]
    p = tmp_path / "glove.txt"
    _write_vec_file(p, [(t, rng.randn(8).astype(np.float32)) for t in toks])
    text = tmx.contrib.text
    vocab = text.Vocabulary(text.count_tokens_from_str(" ".join(toks[:30])))
    emb = text.CustomEmbedding(str(p), vocabulary=vocab)
    layer = tmx.gluon.nn.Embedding(len(vocab), 8)
    layer.initialize(ctx="cpu")
    layer.weight.set_data(emb.idx_to_vec)
    ids = vocab.to_indices(toks[:30] + ["unknown"])
    out = layer(tmx.nd.array(np.array(ids, np.float32))).asnumpy()
    np.testing.assert_array_equal(out, emb.get_vecs_by_tokens(
        toks[:30] + ["unknown"]).asnumpy())


# -- contrib.io, contrib.autograd, contrib.tensorboard ----------------------
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_dataloader_iter_bridge(pkg):
    mx = PKGS[pkg]
    ds = mx.gluon.data.ArrayDataset(
        np.arange(24, dtype=np.float32).reshape(12, 2),
        np.arange(12, dtype=np.float32))
    it = mx.contrib.io.DataLoaderIter(mx.gluon.data.DataLoader(ds,
                                                               batch_size=4))
    assert it.batch_size == 4
    assert [(d.name, d.shape) for d in it.provide_data] == [("data", (4, 2))]
    assert [(d.name, d.shape) for d in it.provide_label] == [
        ("softmax_label", (4,))]
    batches = list(it)
    assert len(batches) == 3
    assert batches[0].data[0].shape == (4, 2)
    np.testing.assert_array_equal(batches[2].label[0].asnumpy(),
                                  [8, 9, 10, 11])
    it.reset()
    assert len(list(it)) == 3


def test_dataloader_iter_feeds_module_fit():
    """One epoch of ``Module.fit`` from a DataLoader, both packages from
    the same initial weights: the same parameters after it."""
    rng = np.random.RandomState(0)
    x = rng.randn(32, 6).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    arg = {"fc_weight": rng.randn(2, 6).astype(np.float32) * 0.1,
           "fc_bias": np.zeros(2, np.float32)}
    out = {}
    for key, mx in PKGS.items():
        net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            mx.sym.Variable("data"), num_hidden=2, name="fc"),
            name="softmax")
        it = mx.contrib.io.DataLoaderIter(mx.gluon.data.DataLoader(
            mx.gluon.data.ArrayDataset(x, y), batch_size=8))
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5},
                arg_params={k: mx.nd.array(v) for k, v in arg.items()},
                aux_params={}, force_init=True)
        out[key] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k in arg:
        np.testing.assert_allclose(out["port"][k], out["ref"][k], rtol=0,
                                   atol=1e-6)
        assert not np.allclose(out["port"][k], arg[k])


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_contrib_autograd_old_api(pkg):
    mx = PKGS[pkg]

    def f(x):
        return mx.nd.sum(x * x * x)
    grads, loss = mx.contrib.autograd.grad_and_loss(f)(
        mx.nd.array([1.0, 2.0]))
    np.testing.assert_allclose(grads[0].asnumpy(), [3.0, 12.0])
    assert float(loss.asnumpy()) == 9.0
    g = mx.contrib.autograd.grad(lambda a, b: mx.nd.sum(a * b), argnum=1)(
        mx.nd.array([2.0, 3.0]), mx.nd.array([1.0, 1.0]))
    np.testing.assert_allclose(g[0].asnumpy(), [2.0, 3.0])
    prev = mx.contrib.autograd.set_is_training(True)
    assert mx.autograd.is_training()
    mx.contrib.autograd.set_is_training(prev)
    x = mx.nd.array([1.0, -2.0])
    x.attach_grad()
    with mx.contrib.autograd.train_section():
        y = x * x
        with mx.contrib.autograd.test_section():
            assert not mx.autograd.is_recording()
    mx.contrib.autograd.backward(y, mx.nd.array([1.0, 1.0]))
    np.testing.assert_allclose(x.grad.asnumpy(), [2.0, -4.0])


class _Writer:
    def __init__(self, logdir):
        self.logdir, self.scalars = logdir, []

    def add_scalar(self, name, value, step):
        self.scalars.append((name, float(value), step))


def _block_writers(monkeypatch, stand_in=None):
    """Hide both summary writers (an import of them fails), or offer
    ``stand_in`` as tensorboardX's."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    if stand_in is None:
        monkeypatch.setitem(sys.modules, "tensorboardX", None)
    else:
        monkeypatch.setitem(sys.modules, "tensorboardX",
                            types.SimpleNamespace(SummaryWriter=stand_in))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_log_metrics_callback_gate(pkg, monkeypatch, tmp_path):
    mx = PKGS[pkg]
    _block_writers(monkeypatch)
    with pytest.raises(ImportError, match="tensorboardX"):
        mx.contrib.tensorboard.LogMetricsCallback(str(tmp_path))


def test_log_metrics_callback_writes_the_same_scalars(monkeypatch,
                                                      tmp_path):
    _block_writers(monkeypatch, _Writer)
    got = {}
    for key, mx in PKGS.items():
        cb = mx.contrib.tensorboard.LogMetricsCallback(str(tmp_path),
                                                       prefix="train")
        metric = mx.metric.Accuracy()
        metric.update([mx.nd.array([0.0, 1.0, 1.0])],
                      [mx.nd.array([[0.9, 0.1], [0.2, 0.8], [0.7, 0.3]])])
        for _ in range(2):
            cb(types.SimpleNamespace(eval_metric=metric))
        cb(types.SimpleNamespace(eval_metric=None))
        got[key] = cb.summary_writer.scalars
    assert got["port"] == got["ref"]
    assert got["port"][0][0] == "train-accuracy" and len(got["port"]) == 2


# -- the rest of tests/test_contrib_py.py ---------------------------------
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_text_vocabulary(pkg):
    mx = PKGS[pkg]
    counter = mx.contrib.text.count_tokens_from_str(
        "the cat sat on the mat the end")
    vocab = mx.contrib.text.Vocabulary(counter, min_freq=1,
                                       most_freq_count=4)
    assert vocab.to_tokens(1) == "the"
    assert vocab.to_indices("nonexistent") == 0
    assert len(vocab) == 5
    assert vocab.to_tokens(vocab.to_indices(["the", "cat"])) == ["the",
                                                                  "cat"]
    assert vocab.idx_to_token == jmx.contrib.text.Vocabulary(
        counter, min_freq=1, most_freq_count=4).idx_to_token


def test_custom_embedding(tmp_path):
    path = tmp_path / "emb.txt"
    path.write_text("hello 1.0 2.0 3.0\nworld 4.0 5.0 6.0\n")
    emb = _same(lambda mx: mx.contrib.text.CustomEmbedding(str(path)))
    assert emb.vec_len == 3
    np.testing.assert_allclose(emb.get_vecs_by_tokens("world").asnumpy(),
                               [4.0, 5.0, 6.0])
    np.testing.assert_allclose(emb.get_vecs_by_tokens("missing").asnumpy(),
                               0.0)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_name_prefix_and_attrscope(pkg):
    mx = PKGS[pkg]
    with mx.name.Prefix("stage1_"):
        s = mx.sym.FullyConnected(mx.sym.Variable("d"), num_hidden=2)
    assert s.name.startswith("stage1_")
    with mx.AttrScope(ctx_group="dev1"):
        s2 = mx.sym.FullyConnected(mx.sym.Variable("d"), num_hidden=2)
    assert s2.attr("ctx_group") == "dev1"


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_name_manager_context(pkg):
    mx = PKGS[pkg]
    with mx.name.NameManager():
        s1 = mx.sym.FullyConnected(mx.sym.Variable("d"), num_hidden=2)
    with mx.name.NameManager():
        s2 = mx.sym.FullyConnected(mx.sym.Variable("d"), num_hidden=2)
    assert s1.name == s2.name


def test_kvstore_server_import_safe():
    """A stray DMLC_ROLE does not stop ``import mxnet_tpu_torch``."""
    env = dict(os.environ, DMLC_ROLE="server")
    env.pop("DMLC_PS_ROOT_URI", None)
    out = subprocess.run(
        [sys.executable, "-c", "import mxnet_tpu_torch as mx; mx.contrib; "
         "print('imported fine')"], env=env, capture_output=True, text=True,
        cwd=os.path.join(os.path.dirname(__file__), ".."))
    assert "imported fine" in out.stdout, out.stderr
