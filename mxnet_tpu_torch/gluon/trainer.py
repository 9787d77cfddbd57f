"""Gluon ``Trainer``: the port of ``mxnet_tpu/gluon/trainer.py``.

``step(batch_size)`` sets ``rescale_grad = scale / batch_size`` on the
optimizer and updates every parameter whose ``grad_req`` is not "null"
from its gradient buffer, one parameter at a time through the
optimizer's unfused rule (``ops/optimizer_ops.py``), as the reference's
dense update goes through ``sgd_update`` / ``sgd_mom_update`` per
parameter.  It launches none of the port's hand kernels: the fused
optimizer kernels belong to ``parallel.DataParallelTrainer``.

Two routes, as the reference's: the trainer's own updater
(``update_on_kvstore=False``, the default here as there), or the
kvstore's updater, run at ``push`` on the stored parameter
(``update_on_kvstore=True``).  The store runs this trainer's optimizer
object, as MXNet's local store does, so both routes take the same
``rescale_grad`` and learning rate and give the same parameters;
``save_states`` / ``load_states`` go through the store on its route.
(``mxnet_tpu``'s store runs a copy pickled before the first rescale, so
its kvstore route updates with ``rescale_grad`` 1 and saves no states:
ROADMAP.md section C.)

Across processes (``kvstore="dist_sync"`` or ``"dist_async"``, under
``tools/launch.py``), ``step`` first pushes every gradient to the store
and, off its route, pulls the sum back into the gradient buffer
(``trainer.py:245``).  There the store holds a copy of each parameter;
the reference's aliases it, so its push of gradients overwrites the
parameters (ROADMAP.md section C).  On the kvstore route the one push,
in the update, runs the store's optimizer (on ``dist_async``, the
server's copy) and the pull brings the parameter back; the reference's
``step`` pushes twice there, so its store applies the update twice.
``update_on_kvstore`` defaults to False, as the reference decides it.
In one process ``allreduce_grads`` has nothing to sum.
"""
from __future__ import annotations

from .. import kvstore as kvs
from .. import optimizer as opt
from .parameter import Parameter

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if hasattr(params, "values"):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("params must be a ParameterDict or list of "
                             "Parameters")
        if not params:
            raise ValueError("no parameters to optimize")
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError("invalid parameter %r" % (param,))
        self._params = list(params)
        self._compression_params = compression_params
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kv_type = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._kvstore = None
        self._kv_initialized = False

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params and set(optimizer_params) != {"rescale_grad"}:
                raise ValueError("optimizer_params must be None when "
                                 "optimizer is an instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = opt.get_updater(self._optimizer)

    def _init_kvstore(self):
        if self._kv_type is None:
            self._kvstore = None
            self._update_on_kvstore = False
        else:
            kv = kvs.create(self._kv_type) \
                if isinstance(self._kv_type, str) else self._kv_type
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            if self._update_on_kvstore is None:
                self._update_on_kvstore = False
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    # the kvstore route updates the parameter in place
                    # through the store; off it the store holds a copy,
                    # which a push of gradients replaces
                    kv.init(i, param.data() if self._update_on_kvstore
                            else param.data().copy())
            if self._update_on_kvstore:
                kv.set_optimizer(self._optimizer)
            self._kvstore = kv
        self._kv_initialized = True

    @property
    def learning_rate(self):
        o = self._optimizer
        return o.lr_scheduler(o.num_update) if o.lr_scheduler else o.lr

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale by ``1 / batch_size``, allreduce, update."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Sum the gradients across workers (nothing to sum in one
        process)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        # on the kvstore route the one push is _update's (the
        # reference's pushes here too, so its store applies twice)
        if self._kvstore is None or self._kvstore.num_workers == 1 \
                or self._update_on_kvstore:
            return
        for i, param in enumerate(self._params):
            if param.grad_req != "null":
                self._kvstore.push(i, param.grad(), priority=-i)
                if not self._update_on_kvstore:
                    self._kvstore.pull(i, param.grad(), priority=-i)

    def _on_kvstore(self):
        return self._update_on_kvstore and self._kvstore is not None

    def _update(self, ignore_stale_grad=False):
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if self._on_kvstore():
                self._kvstore.push(i, param.grad(), priority=-i)
                self._kvstore.pull(i, param.data(), priority=-i)
            else:
                self._updaters(i, param.grad(), param.data())

    def update(self, batch_size, ignore_stale_grad=False):
        """The update alone, after a custom allreduce."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def save_states(self, fname):
        if self._on_kvstore():
            self._kvstore.save_optimizer_states(fname)
            return
        with open(fname, "wb") as f:
            f.write(self._updaters.get_states(dump_optimizer=False))

    def load_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._on_kvstore():
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            self._updaters.set_states(f.read())
