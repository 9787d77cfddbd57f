"""Module: symbol + executor, the port of ``mxnet_tpu/module/module.py``
for inference: ``bind``, ``init_params`` / ``set_params`` /
``get_params``, ``forward``, ``get_outputs`` and ``jit_cache_keys``.

One device: ``context`` (CUDA unless it names the CPU) is resolved at
``bind``.  Random initialization draws from the ``numpy.random.RandomState``
passed as ``init_params(..., rng=)``, or from numpy's global RNG (seeded
by ``mx.random.seed``) when none is, as the reference's does.  Training is ROADMAP.md queue A, item 4; device lists
and ``group2ctxs`` are items 6-7.
"""
from __future__ import annotations

import logging

import numpy as _np
import torch

from ..base import MXNetError
from ..executor import Executor
from ..initializer import InitDesc
from ..io import DataDesc
from ..ndarray import NDArray
from .base_module import BaseModule

__all__ = ["Module"]


def _desc(d):
    return d if isinstance(d, DataDesc) else DataDesc(*d)


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if group2ctxs:
            raise NotImplementedError(
                "group2ctxs placement is ROADMAP.md queue A, items 6-7")
        self._symbol = symbol
        self._data_names = list(data_names) if data_names else []
        self._label_names = list(label_names) if label_names else []
        self._context = context
        self._state_names = list(state_names or [])
        arg_names = symbol.list_arguments()
        inputs = self._data_names + self._label_names + self._state_names
        self._param_names = [n for n in arg_names if n not in inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._data_shapes = None
        self._label_shapes = None

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def context(self):
        """The bound device (None before ``bind``)."""
        return None if self._exec is None else self._exec._device

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if inputs_need_grad or shared_module is not None:
            raise NotImplementedError(
                "inputs_need_grad / shared_module: ROADMAP.md queue A, "
                "item 4")
        self.for_training = for_training
        self._data_shapes = [_desc(d) for d in data_shapes]
        self._label_shapes = [_desc(d) for d in (label_shapes or [])]
        descs = self._data_shapes + self._label_shapes
        self._exec = Executor.simple_bind(
            self._symbol, self._context,
            type_dict={d.name: d.dtype for d in descs},
            shapes={d.name: d.shape for d in descs})
        self.binded = True

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False,
                    rng=None):
        """Fill parameters and aux states from ``arg_params`` /
        ``aux_params`` (cast to the bound dtypes) or ``initializer`` drawing
        from ``rng``."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        attrs = self._symbol.attr_dict()
        for names, table, given in (
                (self._param_names, self._exec.arg_dict, arg_params),
                (self._aux_names, self._exec.aux_dict, aux_params)):
            for name in names:
                arr = table[name]
                if given is not None and name in given:
                    src = given[name]
                    src = src._data if isinstance(src, NDArray) \
                        else torch.as_tensor(_np.asarray(src))
                    arr._set_data(src.to(device=arr.context,
                                         dtype=arr._data.dtype, copy=True))
                elif initializer is not None:
                    buf = _np.zeros(arr.shape, _np.float32)
                    initializer(InitDesc(name, attrs.get(name)), buf, rng)
                    arr._set_data(torch.from_numpy(buf).to(
                        device=arr.context, dtype=arr._data.dtype))
                elif not allow_missing and given is not None \
                        and names is self._param_names:
                    raise MXNetError("missing parameter %r" % name)
        self.params_initialized = True

    def get_params(self):
        if not self.binded:
            raise MXNetError("module not bound")
        return ({n: self._exec.arg_dict[n].copy() for n in self._param_names},
                {n: self._exec.aux_dict[n].copy() for n in self._aux_names})

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        feeds = dict(zip(self._data_names, data_batch.data))
        if self._label_names and data_batch.label is not None:
            feeds.update(zip(self._label_names, data_batch.label))
        self._exec.forward(is_train=is_train, **feeds)

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def jit_cache_keys(self):
        """Executed signatures of the bound executor; the serving layer
        snapshots them after warm-up and asserts the set never grows."""
        return set() if not self.binded else self._exec.jit_cache_keys()
