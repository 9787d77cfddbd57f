"""BucketingModule: the port of ``mxnet_tpu/module/bucketing_module.py``,
variable-length inputs through one Module per bucket key.

``sym_gen(key)`` gives each bucket's ``(symbol, data_names,
label_names)``.  A new key is bound with ``shared_module`` set to the
default bucket's module, so every bucket's parameters and auxiliary
states are the default module's own NDArray objects, and it takes the
default module's optimizer, updater and kvstore: an update through any
bucket moves the one set of weights, with no copy on a switch.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise ValueError("default_bucket_key must be given")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._group2ctxs = group2ctxs
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def symbol(self):
        return self._curr_module._symbol if self._curr_module else None

    @property
    def data_names(self):
        return self._curr_module.data_names

    @property
    def output_names(self):
        return self._curr_module.output_names

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        return self._curr_module.output_shapes

    def _share_optimizer(self, module):
        default = self._buckets[self._default_bucket_key]
        module._optimizer = default._optimizer
        module._updater = default._updater
        module._kvstore = default._kvstore
        module._update_on_kvstore = default._update_on_kvstore
        module.optimizer_initialized = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` current, binding its module on first use
        with the default bucket's module as ``shared_module``."""
        if bucket_key not in self._buckets:
            sym, data_names, label_names = self._sym_gen(bucket_key)
            module = Module(sym, data_names, label_names, logger=self.logger,
                            context=self._context,
                            fixed_param_names=self._fixed_param_names,
                            state_names=self._state_names,
                            group2ctxs=self._group2ctxs)
            default = self._buckets.get(self._default_bucket_key)
            module.bind(data_shapes, label_shapes,
                        for_training=self.for_training,
                        inputs_need_grad=self.inputs_need_grad,
                        shared_module=default)
            if default is not None and default.params_initialized:
                module.params_initialized = True
                if default.optimizer_initialized:
                    self._share_optimizer(module)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.switch_bucket(self._default_bucket_key, data_shapes, label_shapes)
        self.binded = True

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        self._buckets[self._default_bucket_key].init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init, allow_extra=allow_extra)
        for mod in self._buckets.values():
            mod.params_initialized = True
        self.params_initialized = True

    def get_params(self):
        return self._buckets[self._default_bucket_key].get_params()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._buckets[self._default_bucket_key].init_optimizer(
            kvstore=kvstore, optimizer=optimizer,
            optimizer_params=optimizer_params, force_init=force_init)
        for key, mod in self._buckets.items():
            if key != self._default_bucket_key:
                self._share_optimizer(mod)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        default = self._buckets[self._default_bucket_key]
        data_shapes = data_batch.provide_data or \
            [(n, a.shape) for n, a in zip(default.data_names,
                                           data_batch.data)]
        label_shapes = data_batch.provide_label
        if label_shapes is None and data_batch.label:
            label_shapes = [(n, a.shape) for n, a in zip(
                default.label_names, data_batch.label)]
        self.switch_bucket(data_batch.bucket_key, data_shapes, label_shapes)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, lazy=False):
        self._curr_module.update_metric(eval_metric, labels, lazy=lazy)

    def install_monitor(self, mon):
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._buckets[self._default_bucket_key].save_checkpoint(
            prefix, epoch, save_optimizer_states)
