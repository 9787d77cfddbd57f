"""mxnet_tpu_torch.metric held against mxnet_tpu.metric.

Every metric of the reference gets the same seeded labels and
predictions — as NDArrays of each package, over several updates — and
its ``get()`` must equal the reference's to 1e-7 (both accumulate in
numpy on the host).  ``create`` by name, alias, list and callable,
``CompositeEvalMetric``, ``CustomMetric`` / ``np_metric`` and
``update_lazy`` are held the same way.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import metric as jmetric
from mxnet_tpu_torch import metric, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import use

TOL = 1e-7


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _batches(kind, n=3, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if kind == "class":
            p = rng.rand(6, 4).astype(np.float32)
            p /= p.sum(axis=1, keepdims=True)
            out.append((rng.randint(0, 4, 6).astype(np.float32), p))
        elif kind == "binary":
            out.append((rng.randint(0, 2, 8).astype(np.float32),
                        rng.rand(8, 2).astype(np.float32)))
        else:
            out.append((rng.randn(5, 3).astype(np.float32),
                        rng.randn(5, 3).astype(np.float32)))
    return out


METRICS = [("acc", "class", {}), ("accuracy", "class", {"axis": 1}),
           ("top_k_accuracy", "class", {"top_k": 2}),
           ("top_k_acc", "class", {"top_k": 3}),
           ("ce", "class", {}), ("nll_loss", "class", {}),
           ("perplexity", "class", {}),
           ("perplexity", "class", {"ignore_label": 1}),
           ("f1", "binary", {}), ("mcc", "binary", {}),
           ("mae", "reg", {}), ("mse", "reg", {}), ("rmse", "reg", {}),
           ("pearsonr", "reg", {}), ("loss", "reg", {}), ("torch", "reg", {})]


def _run(arr, m, batches, lazy=False):
    for label, pred in batches:
        args = ([arr(label)], [arr(pred)])
        (m.update_lazy if lazy else m.update)(*args)
    return m.get()


def _same(want, got):
    assert want[0] == got[0]
    np.testing.assert_allclose(np.asarray(got[1], np.float64),
                               np.asarray(want[1], np.float64),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("name,kind,kw", METRICS,
                         ids=["%s%d" % (m[0], i)
                              for i, m in enumerate(METRICS)])
def test_metric_matches_reference(name, kind, kw, lazy):
    batches = _batches(kind)
    want = _run(mx.nd.array, jmetric.create(name, **kw), batches)
    m = metric.create(name, **kw)
    _same(want, _run(nd.array, m, batches, lazy=lazy))
    m.reset()
    assert np.isnan(m.get()[1]) or isinstance(m, metric.CompositeEvalMetric)


def test_tensor_inputs_and_single_arrays():
    (label, pred), = _batches("class", n=1)
    want = jmetric.Accuracy()
    want.update(mx.nd.array(label), mx.nd.array(pred))
    got = metric.Accuracy()
    got.update(torch.from_numpy(label), torch.from_numpy(pred))
    _same(want.get(), got.get())
    loss = metric.Loss()
    loss.update(None, nd.array(pred))
    np.testing.assert_allclose(loss.get()[1], pred.mean(), rtol=1e-6)


def test_composite_and_create_forms():
    batches = _batches("class")
    names = ["acc", "ce", ("top_k_accuracy", {"top_k": 2})]

    def build(mod):
        c = mod.CompositeEvalMetric()
        for n in names:
            c.add(mod.create(n[0], **n[1]) if isinstance(n, tuple)
                  else n)
        return c

    want = _run(mx.nd.array, build(jmetric), batches)
    got = _run(nd.array, build(metric), batches)
    assert want[0] == got[0]
    np.testing.assert_allclose(got[1], want[1], rtol=TOL, atol=TOL)
    listed = metric.create(["acc", "mse"])
    assert isinstance(listed, metric.CompositeEvalMetric)
    assert len(listed.metrics) == 2
    acc = metric.Accuracy()
    assert metric.create(acc) is acc
    assert len(build(metric).get_name_value()) == 3
    with pytest.raises(MXNetError):
        metric.create("no-such-metric")


def test_custom_metric_and_np_metric():
    batches = _batches("reg")

    def feval(label, pred):
        return float(np.abs(label - pred).max())

    def pair(label, pred):
        return label.size, float((label > pred).sum())

    for fn in (feval, pair):
        want = _run(mx.nd.array, jmetric.create(fn), batches)
        got = _run(nd.array, metric.create(fn), batches)
        _same(want, got)

    @metric.np_metric("worst")
    def worst(label, pred):
        return float(np.abs(label - pred).max())

    @jmetric.np_metric("worst")
    def jworst(label, pred):
        return float(np.abs(label - pred).max())

    _same(_run(mx.nd.array, jworst, batches),
          _run(nd.array, worst, batches))
    assert str(worst).startswith("EvalMetric: {'worst'")
