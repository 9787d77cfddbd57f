"""Evaluation metrics: the port of ``mxnet_tpu/metric.py``.

A metric reads NDArrays (or tensors, or numpy arrays) on the host with
``asnumpy`` and accumulates in numpy, as the reference's does, so the
values are the reference's to the last bit on the same inputs.
``update`` syncs the card once per batch; ``update_lazy`` parks the
device arrays and drains them, in order, when the metric is read.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray

_REG = {}


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return NDArray(x).asnumpy()
    return np.asarray(x)


def check_label_shapes(labels, preds, shape=False):
    if not shape:
        if len(labels) != len(preds):
            raise ValueError("labels/preds length mismatch: %d vs %d"
                             % (len(labels), len(preds)))


class EvalMetric:
    # lazy window bound: update_lazy keeps at most this many pending
    # batches device-resident before draining the oldest (their values
    # are long since computed by then, so the drain is ~free); bounds the
    # device memory the deferred labels/preds pin across a bulk window
    LAZY_MAX_PENDING = 64

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def update_lazy(self, labels, preds):
        """Non-blocking ``update``: park the (device-resident, lazy)
        labels/preds without fetching them — ``update`` calls ``asnumpy``
        per batch, a host sync that stalls the engine's run-ahead window
        every step.  The parked batches are drained (in order, so values
        are identical to eager updates) the next time anyone reads the
        metric — ``get``/``get_name_value``, i.e. a ``Speedometer`` tick
        or the epoch log: the flush boundaries."""
        self._lazy.append((labels, preds))
        while len(self._lazy) > self.LAZY_MAX_PENDING:
            labels, preds = self._lazy.pop(0)
            self.update(labels, preds)

    def _drain_lazy(self):
        pending, self._lazy = self._lazy, []
        for labels, preds in pending:
            self.update(labels, preds)

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self._lazy = []

    def get(self):
        self._drain_lazy()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


def register(klass):
    _REG[klass.__name__.lower()] = klass
    return klass


def alias(*aliases):
    def deco(klass):
        for n in aliases:
            _REG[n.lower()] = klass
        return klass
    return deco


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    key = metric.lower()
    if key not in _REG:
        raise MXNetError("Cannot find metric %r. Registered: %s"
                         % (metric, sorted(_REG)))
    return _REG[key](*args, **kwargs)


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = metrics if metrics is not None else []

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        self._lazy = []
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        self._drain_lazy()
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.extend(name if isinstance(name, list) else [name])
            values.extend(value if isinstance(value, list) else [value])
        return names, values


@register
@alias("acc")
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        if isinstance(labels, (NDArray, torch.Tensor)):
            labels = [labels]
        if isinstance(preds, (NDArray, torch.Tensor)):
            preds = [preds]
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _as_np(pred)
            label = _as_np(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(np.int32).ravel()
            label = label.astype(np.int32).ravel()
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


@register
@alias("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.top_k = top_k
        self.name += "_%d" % top_k

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            pred = _as_np(pred)
            label = _as_np(label).astype(np.int32)
            topk = np.argsort(-pred, axis=1)[:, :self.top_k]
            for j in range(label.shape[0]):
                self.sum_metric += int(label[j] in topk[j])
            self.num_inst += label.shape[0]


@register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self.reset_stats()

    def reset_stats(self):
        self._tp = self._fp = self._fn = 0.0

    def reset(self):
        super().reset()
        self.reset_stats()

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            pred = _as_np(pred)
            label = _as_np(label).ravel().astype(np.int32)
            if pred.ndim > 1:
                pred = pred.argmax(axis=1)
            pred = pred.ravel().astype(np.int32)
            self._tp += ((pred == 1) & (label == 1)).sum()
            self._fp += ((pred == 1) & (label == 0)).sum()
            self._fn += ((pred == 0) & (label == 1)).sum()
            prec = self._tp / max(self._tp + self._fp, 1e-12)
            rec = self._tp / max(self._tp + self._fn, 1e-12)
            f1 = 2 * prec * rec / max(prec + rec, 1e-12)
            self.sum_metric = f1
            self.num_inst = 1


@register
class MCC(EvalMetric):
    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)
        self._stats = np.zeros(4)

    def reset(self):
        super().reset()
        self._stats = np.zeros(4)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            pred = _as_np(pred)
            label = _as_np(label).ravel().astype(np.int32)
            if pred.ndim > 1:
                pred = pred.argmax(axis=1)
            pred = pred.ravel().astype(np.int32)
            tp = ((pred == 1) & (label == 1)).sum()
            fp = ((pred == 1) & (label == 0)).sum()
            fn = ((pred == 0) & (label == 1)).sum()
            tn = ((pred == 0) & (label == 0)).sum()
            self._stats += np.array([tp, fp, fn, tn])
            tp, fp, fn, tn = self._stats
            denom = math.sqrt(max((tp + fp) * (tp + fn) * (tn + fp)
                                  * (tn + fn), 1e-12))
            self.sum_metric = (tp * tn - fp * fn) / denom
            self.num_inst = 1


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_np(label).astype(np.int32).ravel()
            pred = _as_np(pred)
            pred = pred.reshape(-1, pred.shape[-1])
            probs = pred[np.arange(label.size), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                probs = np.where(ignore, 1.0, probs)
                num -= ignore.sum()
            loss -= np.log(np.maximum(1e-10, probs)).sum()
            num += label.size
        self.sum_metric += math.exp(loss / max(num, 1))
        self.num_inst += 1


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_np(label)
            pred = _as_np(pred)
            self.sum_metric += np.abs(label.reshape(pred.shape) - pred).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_np(label)
            pred = _as_np(pred)
            self.sum_metric += ((label.reshape(pred.shape) - pred) ** 2).mean()
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)

    def get(self):
        self._drain_lazy()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register
@alias("ce")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_np(label).ravel().astype(np.int32)
            pred = _as_np(pred)
            prob = pred[np.arange(label.shape[0]), label]
            self.sum_metric += (-np.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register
@alias("nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)
        self.eps = eps


@register
@alias("pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_np(label).ravel()
            pred = _as_np(pred).ravel()
            self.sum_metric += np.corrcoef(pred, label)[0, 1]
            self.num_inst += 1


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        if isinstance(preds, (NDArray, torch.Tensor)):
            preds = [preds]
        for pred in preds:
            loss = _as_np(pred).sum()
            self.sum_metric += loss
            self.num_inst += _as_np(pred).size


@register
class Torch(Loss):
    def __init__(self, name="torch", **kwargs):
        super().__init__(name, **kwargs)


class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False, **kwargs):
        if name is None:
            name = feval.__name__
        super().__init__(name, **kwargs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            reval = self._feval(_as_np(label), _as_np(pred))
            if isinstance(reval, tuple):
                num_inst, sum_metric = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np_metric(name=None, allow_extra_outputs=False):
    def deco(feval):
        return CustomMetric(feval, name, allow_extra_outputs)
    return deco
