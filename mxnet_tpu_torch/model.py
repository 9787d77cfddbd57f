"""The legacy model API: checkpoints, the kvstore choice and
``FeedForward``, the port of ``mxnet_tpu/model.py``.

``save_checkpoint`` writes ``prefix-symbol.json`` and
``prefix-%04d.params`` with ``arg:`` / ``aux:`` keys (``format="mxnet"``
the reference MXNet layout, else ``MXTPUND1``); either package loads the
other's files (``serialization.py``).  ``load_checkpoint`` and
``load_params`` return the arrays on the CPU; a module copies them to
its device.  ``_create_kvstore`` decides ``(kvstore, update_on_kvstore)``
as the reference does: a single device with ``"local"`` or ``"device"``
needs no store.  ``FeedForward`` is the pre-Module training class, a
veneer over :class:`~mxnet_tpu_torch.module.Module`.
"""
from __future__ import annotations

import logging

import numpy as _np

from .io import NDArrayIter
from .serialization import load_ndarrays, save_ndarrays
from .module.base_module import BatchEndParam

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "save_params", "FeedForward", "BatchEndParam"]


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore or None, update_on_kvstore)`` (reference: model.py:77)."""
    from . import kvstore as kvs
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(int(_np.prod(p.shape)) for p in
                               arg_params.values()) if arg_params else 0
                if max_size > 1024 * 1024:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def save_params(fname, arg_params, aux_params=None, format="mxtpu"):
    data = {"arg:%s" % k: v for k, v in (arg_params or {}).items()}
    data.update({"aux:%s" % k: v for k, v in (aux_params or {}).items()})
    save_ndarrays(fname, data, format=format)


def load_params(fname):
    """``(arg_params, aux_params)`` of a ``.params`` file, on the CPU."""
    arg_params, aux_params = {}, {}
    for k, v in load_ndarrays(fname, ctx="cpu").items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    format="mxtpu"):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params``
    (reference: model.py:384)."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_params("%s-%04d.params" % (prefix, epoch), arg_params, aux_params,
                format=format)
    logging.info("Saved checkpoint to \"%s-%04d.params\"", prefix, epoch)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` (reference: model.py:414)."""
    from . import symbol as sym
    symbol = sym.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params("%s-%04d.params" % (prefix, epoch))
    return symbol, arg_params, aux_params


class FeedForward:
    """The pre-Module training class (reference: model.py:452), kept so
    the older scripts run: ``fit`` / ``predict`` / ``score`` through a
    :class:`Module` on ``ctx``; numpy inputs go through ``NDArrayIter``
    at ``numpy_batch_size``, shuffled for ``fit``; every keyword it does
    not name is an optimizer parameter."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        if initializer is None:
            from .initializer import Uniform
            initializer = Uniform(0.01)
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch or 0
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    def _as_iter(self, X, y=None, shuffle=False):
        from .io import DataIter
        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, y, self.numpy_batch_size, shuffle=shuffle)

    def _module_for(self, data, label_names):
        from .module import Module
        return Module(self.symbol,
                      data_names=[d.name for d in data.provide_data],
                      label_names=label_names, context=self.ctx)

    @staticmethod
    def _label_names(data):
        if getattr(data, "provide_label", None):
            return [d.name for d in data.provide_label]
        return ["softmax_label"]

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        train_data = self._as_iter(X, y, shuffle=True)
        if eval_data is not None and not hasattr(eval_data, "provide_data"):
            eval_data = self._as_iter(eval_data[0], eval_data[1])
        mod = self._module_for(train_data, self._label_names(train_data))
        self._module = mod
        opt_params = dict(self.kwargs)
        opt_params.setdefault("learning_rate", 0.01)
        mod.fit(train_data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer, optimizer_params=opt_params,
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, allow_missing=True,
                begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
                monitor=monitor)
        self.arg_params, self.aux_params = mod.get_params()

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        data = self._as_iter(X)
        if self._module is None:
            # the label stays an input, inferred from the data's shape (a
            # reloaded model's label is no parameter; ROADMAP.md C6)
            mod = self._module_for(data, self._label_names(data))
            mod.bind(data.provide_data, for_training=False)
            mod.init_params(arg_params=self.arg_params,
                            aux_params=self.aux_params)
            self._module = mod
        out = self._module.predict(data, num_batch=num_batch, reset=reset)
        if isinstance(out, list):
            return [o.asnumpy() for o in out]
        return out.asnumpy()

    def score(self, X, eval_metric="acc", num_batch=None):
        data = self._as_iter(X)
        mod = self._module_for(data, self._label_names(data))
        mod.bind(data.provide_data, data.provide_label, for_training=False)
        mod.init_params(arg_params=self.arg_params, aux_params=self.aux_params)
        return mod.score(data, eval_metric, num_batch=num_batch)[0][1]
