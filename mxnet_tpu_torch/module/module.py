"""Module: symbol + executor + optimizer, the port of
``mxnet_tpu/module/module.py``.

One device: ``context`` (CUDA unless it names the CPU; the reference
defaults to the CPU) is resolved at ``bind``.  ``bind`` gives every
parameter outside ``fixed_param_names`` the ``grad_req`` asked for when
``for_training`` (and the data too with ``inputs_need_grad``), every
other argument ``"null"``; ``shared_module`` makes the parameter and
auxiliary arrays the other module's own NDArray objects.  Random
initialization draws from the ``numpy.random.RandomState`` passed as
``init_params(..., rng=)``, or from numpy's global RNG (seeded by
``mx.random.seed``) when none is, as the reference's does.

``init_optimizer`` creates the optimizer with ``rescale_grad`` 1/batch
unless given and ``param_idx2name`` the parameters in order, and a
kvstore through ``model._create_kvstore`` (none for ``"local"`` or
``"device"`` on one device): ``update`` then runs the optimizer's
``Updater`` per parameter, as the reference's does; an explicit
``KVStore`` runs the optimizer itself at push time (MXNet's local
store; the reference's store runs a pickled copy, ROADMAP.md section C).
Device lists and ``group2ctxs`` are ROADMAP.md queue A, items 6-7.
"""
from __future__ import annotations

import logging

import numpy as _np
import torch

from .. import optimizer as opt
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
        self._fixed_param_names = list(fixed_param_names or [])
        self._state_names = list(state_names or [])
        arg_names = symbol.list_arguments()
        inputs = self._data_names + self._label_names + self._state_names
        self._param_names = [n for n in arg_names if n not in inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._exec = None
        self._data_shapes = None
        self._label_shapes = None
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._updater = None
        self._preload_opt_states = None
        self._arg_params_cache = None
        self._monitor = None

    # -- checkpoints -------------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A module of the checkpoint ``prefix``-``epoch``: its parameters
        are set at ``bind``, its optimizer states at ``init_optimizer``."""
        from ..model import load_checkpoint
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params_cache = (args, auxs)
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        from ..model import save_checkpoint
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self.symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    # -- properties --------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        if not self.binded:
            raise MXNetError("module not bound")
        if self._exec.outputs:
            shapes = [o.shape for o in self._exec.outputs]
        else:
            descs = self._data_shapes + self._label_shapes
            shapes = self._symbol.infer_shape(
                **{d.name: d.shape for d in descs})[1]
        return list(zip(self._output_names, shapes))

    @property
    def context(self):
        """The bound device (None before ``bind``)."""
        return None if self._exec is None else self._exec._device

    # -- bind / parameters -------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = [_desc(d) for d in data_shapes]
        self._label_shapes = [_desc(d) for d in (label_shapes or [])]
        descs = self._data_shapes + self._label_shapes
        req = {}
        for n in self._symbol.list_arguments():
            if n in self._param_names and n not in self._fixed_param_names:
                req[n] = grad_req if for_training else "null"
            elif inputs_need_grad and n in self._data_names:
                req[n] = grad_req
            else:
                req[n] = "null"
        self._exec = Executor.simple_bind(
            self._symbol, self._context, grad_req=req,
            type_dict={d.name: d.dtype for d in descs},
            shapes={d.name: d.shape for d in descs},
            data_names=self._data_names + self._label_names
            + self._state_names)
        if shared_module is not None and shared_module._exec is not None:
            # the parameters and aux states are the other module's arrays
            # (BucketingModule's buckets share them)
            for names, table, other in (
                    (self._param_names, self._exec.arg_dict,
                     shared_module._exec.arg_dict),
                    (self._aux_names, self._exec.aux_dict,
                     shared_module._exec.aux_dict)):
                for n in names:
                    if n in other:
                        table[n] = other[n]
            self._exec.arg_arrays = [self._exec.arg_dict[n]
                                     for n in self._exec._arg_names]
            self._exec.aux_arrays = [self._exec.aux_dict[n]
                                     for n in self._exec._aux_names]
        self.binded = True
        if self._arg_params_cache is not None:
            self.set_params(*self._arg_params_cache)
            self._arg_params_cache = None

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
                    arr._set_data(src.detach().to(
                        device=arr.context, dtype=arr._data.dtype,
                        copy=True))
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

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        if not self.params_initialized:
            raise MXNetError("init_params before init_optimizer")
        from ..model import _create_kvstore
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, 1, {n: self._exec.arg_dict[n] for n in self._param_names})
        if isinstance(optimizer, str):
            batch = self._data_shapes[0].shape[0] if self._data_shapes else 1
            optimizer_params = dict(optimizer_params)
            # the reference's default: gradients summed over the batch
            optimizer_params.setdefault("rescale_grad", 1.0 / max(batch, 1))
            optimizer = opt.create(
                optimizer, param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore and kvstore is not None
        if kvstore is not None:
            for i, n in enumerate(self._param_names):
                kvstore.init(i, self._exec.arg_dict[n])
            if self._update_on_kvstore:
                kvstore.set_optimizer(self._optimizer)
        self._updater = None if self._update_on_kvstore \
            else opt.get_updater(optimizer)
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None
        self.optimizer_initialized = True

    def save_optimizer_states(self, fname):
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
        else:
            with open(fname, "wb") as f:
                f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())

    # -- computation -------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        feeds = dict(zip(self._data_names, data_batch.data))
        if self._label_names and data_batch.label is not None:
            feeds.update(zip(self._label_names, data_batch.label))
        self._exec.forward(is_train=is_train, **feeds)
        if self._monitor is not None:
            self._monitor.observe(self)

    def backward(self, out_grads=None):
        if not self.binded:
            raise MXNetError("module not bound")
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """Apply the gradients: through the kvstore when there is one
        (its optimizer when ``update_on_kvstore``), else the updater, per
        parameter in order (reference: module.py update)."""
        if not self.optimizer_initialized:
            raise MXNetError("init_optimizer before update")
        grads = self._exec.grad_dict
        if self._kvstore is not None:
            for i, n in enumerate(self._param_names):
                if n not in grads:
                    continue
                self._kvstore.push(i, grads[n])
                self._kvstore.pull(i, self._exec.arg_dict[n]
                                   if self._update_on_kvstore else grads[n])
            if self._update_on_kvstore:
                return
        for i, n in enumerate(self._param_names):
            if n in grads:
                self._updater(i, grads[n], self._exec.arg_dict[n])

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True")
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels, lazy=False):
        # lazy: park the device-resident outputs; the metric reads them at
        # its next read, not once a batch
        if lazy and hasattr(eval_metric, "update_lazy"):
            eval_metric.update_lazy(labels, self.get_outputs())
        else:
            eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        self._monitor = mon
        mon.install(self)

    def reshape(self, data_shapes, label_shapes=None):
        """Record new input shapes: the eager executor runs any shape fed
        to it, so nothing is rebound."""
        self._data_shapes = [_desc(d) for d in data_shapes]
        if label_shapes is not None:
            self._label_shapes = [_desc(d) for d in label_shapes]

    def jit_cache_keys(self):
        """Executed signatures of the bound executor; the serving layer
        snapshots them after warm-up and asserts the set never grows."""
        return set() if not self.binded else self._exec.jit_cache_keys()
