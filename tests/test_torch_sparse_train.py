"""The sparse linear classifier of mxnet_tpu_torch held against the
reference's own example on the CPU, with the CSR batches that feed it and
the Gluon embeddings marked sparse (the two Gluon examples are
``test_torch_sparse_train_gluon.py``, which imports the helpers here).

- ``io.LibSVMIter``: the port's batches are ``CSRNDArray`` s whose
  parts equal the reference's bitwise (values, int64 column indices and
  indptr; the labels and ``pad``), over the example's own file, with the
  last batch rounded and not, labels from a second file, and
  ``num_parts``.
- ``tools/train_sparse_linear.py`` against
  ``examples/sparse/linear_classification.py``, 4 batches of 16 over 100
  features with 5 nonzeros a row: the LibSVM file byte for byte (the
  example's writer), each batch's probabilities within 2e-5 and the
  stored weight after the four pushes within 5e-6 (each over the larger
  of 1 and the reference's largest magnitude).  The example's assert
  (running accuracy above 0.7) is not expected to hold after 4 batches:
  both scripts run to it, and it decides alike in both.
- ``gluon.nn.Embedding(sparse_grad=True)`` and
  ``gluon.contrib.nn.SparseEmbedding``: the same weights, one forward,
  backward and SGD step in both packages; the outputs, the (dense)
  gradients and the updated weights within 1e-5.
"""
import contextlib
import io as pyio
import os

import numpy as np
import pytest

from test_torch_detection_train import (LOSS_TOL, PARAM_TOL, _argv, _load,
                                        _within)

LIN_ARGS = ["--feat-dim", "100", "--nnz", "5", "--batch-size", "16",
            "--num-batches", "4"]
GLUON_TOL = 1e-5


@contextlib.contextmanager
def _quiet():
    with contextlib.redirect_stdout(pyio.StringIO()), \
            contextlib.redirect_stderr(pyio.StringIO()):
        yield


def _run_to_assert(run):
    """Run a script to its end; whether its own final assert held."""
    try:
        with _quiet():
            run()
    except AssertionError:
        return False
    return True


# -- LibSVMIter -----------------------------------------------------------
@pytest.fixture(scope="module")
def libsvm_files(tmp_path_factory):
    """The example's file (40 rows over 30 features) and a label file."""
    from mxnet_tpu_torch.tools import train_sparse_linear
    tmp = tmp_path_factory.mktemp("libsvm")
    path, labels = str(tmp / "d.svm"), str(tmp / "l.svm")
    train_sparse_linear.write_libsvm(path, 40, 30, 4,
                                     np.random.RandomState(3))
    with open(labels, "w") as f:
        for i in range(40):
            f.write("0:%d\n" % (i % 3))
    return path, labels


def _epoch(it):
    out = []
    for b in it:
        d = b.data[0]
        out.append([d.data.asnumpy(), d.indices.asnumpy().astype(np.int64),
                    d.indptr.asnumpy().astype(np.int64),
                    b.label[0].asnumpy(), np.array([b.pad]),
                    np.array(d.shape)])
    return out


@pytest.mark.parametrize("case", ["rounded", "keep", "label_file", "parts"])
def test_libsvm_iter_csr_batches_match_reference(libsvm_files, case):
    import mxnet_tpu as jmx
    from mxnet_tpu_torch import io
    from mxnet_tpu_torch.ndarray import sparse
    path, labels = libsvm_files
    kw = dict(data_libsvm=path, data_shape=(30,), batch_size=16)
    if case == "keep":
        kw["round_batch"] = False
    elif case == "label_file":
        kw["label_libsvm"] = labels
    elif case == "parts":
        kw.update(num_parts=2, part_index=1, batch_size=8)
    it, jt = io.LibSVMIter(**kw), jmx.io.LibSVMIter(**kw)
    first = it.next()
    assert isinstance(first.data[0], sparse.CSRNDArray)
    assert first.data[0].stype == "csr"
    assert first.data[0].context.type == "cpu"
    assert first.data[0].indices.dtype == np.int64
    it.reset()
    got, want = _epoch(it), _epoch(jt)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.tobytes() == b.astype(a.dtype).tobytes()


# -- the sparse linear classifier ---------------------------------------------
def test_linear_writer_is_the_examples(tmp_path):
    from mxnet_tpu_torch.tools import train_sparse_linear
    mod = _load("examples/sparse/linear_classification.py", "lin_writer")
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    mod.write_libsvm(a, 20, 50, 5, np.random.RandomState(0))
    train_sparse_linear.write_libsvm(b, 20, 50, 5, np.random.RandomState(0))
    assert open(a, "rb").read() == open(b, "rb").read()


def _reference_linear(monkeypatch):
    """The example's scores per batch and its store after the run."""
    import mxnet_tpu as jmx
    from mxnet_tpu import kvstore as jkv
    from mxnet_tpu.ndarray import sparse as jsp
    mod = _load("examples/sparse/linear_classification.py", "lin_example")
    scores, stores = [], []
    dot, create = jsp.dot, jkv.create

    def record_dot(lhs, rhs, transpose_a=False, transpose_b=False):
        out = dot(lhs, rhs, transpose_a=transpose_a, transpose_b=transpose_b)
        if not transpose_a:
            scores.append(out.asnumpy()[:, 0])
        return out

    def record_create(*a, **k):
        stores.append(create(*a, **k))
        return stores[-1]
    monkeypatch.setattr(jsp, "dot", record_dot)
    monkeypatch.setattr(jkv, "create", record_create)
    with _argv(LIN_ARGS):
        passed = _run_to_assert(mod.main)
    monkeypatch.undo()
    weight = jmx.nd.zeros((100, 1))
    stores[0].pull("weight", out=weight)
    return passed, [1.0 / (1.0 + np.exp(-s)) for s in scores], \
        weight.asnumpy()


def test_train_sparse_linear_matches_reference_example(monkeypatch):
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.tools import train_sparse_linear
    want_pass, want_p, want_w = _reference_linear(monkeypatch)
    probs, stores = [], []

    def record(step, p, kv):
        probs.append(p)
        stores[:] = [kv]
    passed = _run_to_assert(lambda: train_sparse_linear.main(
        LIN_ARGS + ["--ctx", "cpu"], batch_end_callback=record))
    assert passed == want_pass
    assert len(probs) == len(want_p) == 4
    for g, w in zip(probs, want_p):
        _within(g, w, LOSS_TOL)
    weight = nd.zeros((100, 1), ctx="cpu")
    stores[0].pull("weight", out=weight)
    _within(weight.asnumpy(), want_w, PARAM_TOL)
    assert np.count_nonzero(want_w) > 0


def test_train_sparse_linear_defaults_pass_the_examples_assert(tmp_path):
    """At its defaults (100 batches of 64 over 1,000 features) the tool
    passes the example's bar; the work directory it is given holds the
    data file."""
    from mxnet_tpu_torch.tools import train_sparse_linear
    with _quiet():
        acc, probs, weight = train_sparse_linear.main(
            ["--ctx", "cpu"], workdir=str(tmp_path))
    assert acc > 0.7 and len(probs) == 100 and weight.shape == (1000, 1)
    assert os.path.getsize(tmp_path / "train.libsvm") > 0


# -- the Gluon embeddings marked sparse ---------------------------------------
@pytest.mark.parametrize("kind", ["embedding_sparse_grad", "sparse_embedding"])
def test_gluon_sparse_embeddings_match_reference(kind):
    import mxnet_tpu as jmx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.context import use
    from mxnet_tpu_torch.gluon.utils import from_jax_params
    rng = np.random.RandomState(7)
    x = np.array([[1, 4], [4, 9], [0, 1]], np.float32)
    head = rng.randn(3, 2, 5).astype(np.float32)
    res = {}
    for pkg, mx in (("ref", jmx), ("port", None)):
        g = jmx.gluon if pkg == "ref" else gluon
        blk = g.nn.Embedding(10, 5, sparse_grad=True) \
            if kind == "embedding_sparse_grad" \
            else g.contrib.nn.SparseEmbedding(10, 5)
        assert blk.weight._grad_stype == "row_sparse"
        if pkg == "ref":
            np.random.seed(0)
            blk.initialize(jmx.init.Uniform(0.5))
            arr, ag, weights = jmx.nd.array, jmx.autograd, {
                n: p.data().asnumpy() for n, p in
                blk.collect_params().items()}
        else:
            from_jax_params(blk, weights, device="cpu")
            arr, ag = (lambda v: nd.array(v, ctx="cpu")), autograd
        trainer = g.Trainer(blk.collect_params(), "sgd",
                            {"learning_rate": 0.5})
        with (use("cpu") if pkg == "port" else contextlib.nullcontext()):
            with ag.record():
                out = blk(arr(x))
                loss = (out * arr(head)).sum()
            loss.backward()
            grad = blk.weight.grad().asnumpy().copy()
            trainer.step(1)
        res[pkg] = (out.asnumpy(), grad, blk.weight.data().asnumpy())
    for g, w in zip(res["port"], res["ref"]):
        assert g.shape == w.shape
        _within(g, w, GLUON_TOL)
    # the gradient is dense: untouched rows zero, row 4 twice
    grad = res["port"][1]
    assert not grad[[2, 3, 5, 6, 7, 8]].any()
    np.testing.assert_allclose(grad[4], head[0, 1] + head[1, 0], rtol=1e-6)
