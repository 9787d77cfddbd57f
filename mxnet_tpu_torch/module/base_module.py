"""BaseModule: the port of ``mxnet_tpu/module/base_module.py``, the
training and prediction loops over the abstract surface a module
implements (``bind``, ``init_params``, ``init_optimizer``, ``forward``,
``backward``, ``update``, ``update_metric``): ``forward_backward``,
``score``, ``predict`` (without each batch's ``pad``), ``iter_predict``
and ``fit``, the reference's epoch loop (``Uniform(0.01)`` unless an
initializer is given, the metric updated lazily, parameters read back
and written once per epoch, callbacks, a validation pass)."""
from __future__ import annotations

import logging
import time

from .. import metric as _metric
from ..base import MXNetError

__all__ = ["BaseModule", "BatchEndParam"]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- the surface a module implements -----------------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels, lazy=False):
        raise NotImplementedError

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def install_monitor(self, mon):
        raise NotImplementedError

    @property
    def data_names(self):
        raise NotImplementedError

    @property
    def output_names(self):
        raise NotImplementedError

    # -- generic functionality ---------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None,
              reset=True, epoch=0, sparse_row_id_fn=None):
        """Evaluate ``eval_metric`` over ``eval_data``; returns its
        ``get_name_value()``."""
        if not self.binded or not self.params_initialized:
            raise MXNetError("module must be binded and initialized")
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        if reset:
            eval_data.reset()
        eval_metric.reset()
        nbatch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(params)
        if score_end_callback is not None:
            params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                   eval_metric=eval_metric, locals=locals())
            for cb in _as_list(score_end_callback):
                cb(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs without the pad, nbatch, batch)``."""
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outs = [o[0:o.shape[0] - pad] for o in self.get_outputs()]
            yield (outs, nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs over ``eval_data`` without each batch's pad,
        concatenated along the batch axis (one array for one output
        unless ``always_output_list``), or a list per batch."""
        from .. import ndarray as nd
        output_list = [outs for outs, _, _ in
                       self.iter_predict(eval_data, num_batch, reset)]
        if not output_list:
            return []
        if merge_batches:
            merged = [nd.concatenate([o[i] for o in output_list], axis=0)
                      for i in range(len(output_list[0]))]
            if len(merged) == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """The training loop (reference: base_module.py fit)."""
        if num_epoch is None:
            raise ValueError("num_epoch must be specified")
        if initializer is None:
            from ..initializer import Uniform
            initializer = Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            train_data.reset()
            for data_batch in train_data:
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                # lazy: the metric parks the outputs on the device and
                # reads them at its next read (a Speedometer tick, the
                # epoch log), not once a step
                self.update_metric(eval_metric, data_batch.label, lazy=True)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals())
                    for cb in _as_list(batch_end_callback):
                        cb(params)
                nbatch += 1

            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)

            arg_p, aux_p = self.get_params()
            self.set_params(arg_p, aux_p)
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)

            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)


class BatchEndParam:
    """Callback payload (reference: model.py BatchEndParam)."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]
