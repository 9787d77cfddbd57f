"""SequentialModule: the port of
``mxnet_tpu/module/sequential_module.py``, modules in a chain, each
module's outputs fed to the next as its data.

``add(module, take_labels=False, auto_wiring=True)``: a module with
``take_labels`` gets the batch's labels (and updates the metric);
``auto_wiring`` renames the outputs to the next module's data names at
``bind``.  Every module after the first is bound with
``inputs_need_grad``, so ``backward`` runs from the last module to the
first, each taking the next one's ``get_input_grads()`` as its head
gradients.
"""
from __future__ import annotations

import logging

from ..io import DataBatch, DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None

    def add(self, module, **kwargs):
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        if shared_module is not None:
            raise ValueError("SequentialModule takes no shared_module")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = label_shapes
        cur_shapes = data_shapes
        for i, (module, meta) in enumerate(zip(self._modules, self._metas)):
            lbl = label_shapes if meta.get(self.META_TAKE_LABELS, False) \
                else None
            module.bind(cur_shapes, lbl, for_training=for_training,
                        inputs_need_grad=True if i > 0 else inputs_need_grad,
                        force_rebind=force_rebind, grad_req=grad_req)
            if meta.get(self.META_AUTO_WIRING, True) and \
                    i + 1 < len(self._modules):
                nxt = self._modules[i + 1].data_names
                cur_shapes = [DataDesc(n, s) for n, (_, s) in
                              zip(nxt, module.output_shapes)]
        self.binded = True

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        for module in self._modules:
            module.init_params(initializer=initializer, arg_params=arg_params,
                               aux_params=aux_params, allow_missing=True,
                               force_init=force_init, allow_extra=True)
        self.params_initialized = True

    def get_params(self):
        arg_params, aux_params = {}, {}
        for module in self._modules:
            a, x = module.get_params()
            arg_params.update(a)
            aux_params.update(x)
        return arg_params, aux_params

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i + 1 == len(self._modules):
                break
            label = data_batch.label if self._metas[i + 1].get(
                self.META_TAKE_LABELS, False) else None
            batch = DataBatch(module.get_outputs(), label,
                              pad=data_batch.pad, index=data_batch.index)

    def backward(self, out_grads=None):
        for i in range(len(self._modules) - 1, -1, -1):
            module = self._modules[i]
            module.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, lazy=False):
        for module, meta in zip(self._modules, self._metas):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels, lazy=lazy)

    def install_monitor(self, mon):
        for module in self._modules:
            module.install_monitor(mon)
