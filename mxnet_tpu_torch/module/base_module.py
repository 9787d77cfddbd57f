"""BaseModule: the port of ``mxnet_tpu/module/base_module.py``, the part
an inference Module needs.  Training (``fit``, ``backward``, ``update``,
``init_optimizer``) and the metric loops (``score``, ``predict``) are
ROADMAP.md queue A, item 4: they raise, naming it."""
from __future__ import annotations

import logging


def _training(what):
    raise NotImplementedError(
        "Module.%s: training through Module is ROADMAP.md queue A, item 4"
        % what)


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False,
                    rng=None):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def backward(self, out_grads=None):
        _training("backward")

    def update(self):
        _training("update")

    def init_optimizer(self, *args, **kwargs):
        _training("init_optimizer")

    def forward_backward(self, data_batch):
        _training("forward_backward")

    def fit(self, *args, **kwargs):
        _training("fit")

    def score(self, *args, **kwargs):
        _training("score")

    def predict(self, *args, **kwargs):
        _training("predict")
