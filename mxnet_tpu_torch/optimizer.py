"""Optimizers: the port of ``mxnet_tpu/optimizer.py`` — ``Optimizer``
(``:26-120``), ``SGD`` (``:149-200``), ``Adam`` (``:377-430``),
``register`` and ``create``.

``update(index, weight, grad, state)`` applies the unfused rule of
``ops/optimizer_ops.py`` and writes the result into ``weight`` and
``state`` in place.  The trainer's fused path
(``ops.fused_optimizer.fused_optimizer_update``) reads the same
attributes.  The reference's other optimizers are not ported yet
(ROADMAP.md queue A, item 1): :func:`create` names that item for them.

:class:`Updater` (``get_updater``, ``:618-666``) applies an optimizer per
index with lazily created states, as the Gluon ``Trainer`` and the
kvstore run it; its ``get_states`` pickles ``{index: numpy array or
tuple}`` as the reference's does, so a states file either package writes
loads in the other (``dump_optimizer=True`` pickles the optimizer's
class too, which only its own package can load).

``multi_precision=True`` (``:60-75``, ``:124-211``): a bfloat16 or
float16 weight gets an f32 master copy in its state,
``(master, inner_state)``; ``update_multi_precision`` runs the update on
the master with the gradient widened to f32 and writes the master,
rounded, back into the weight.  For SGD that is the reference's
``mp_sgd_update`` / ``mp_sgd_mom_update`` arithmetic.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

from .base import MXNetError
from .ops import optimizer_ops as ops

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "register", "create",
           "get_updater"]

_REG = {}

# the reference's other registered optimizers, not ported yet
_UNPORTED = ("signum", "ftml", "lbsgd", "dcasgd", "nag", "sgld", "adagrad",
             "rmsprop", "adadelta", "ftrl", "adamax", "nadam", "test")


class Optimizer:
    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, momentum=None, **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self._extra = kwargs

    def __getstate__(self):
        """Pickled with each parameter of ``param_dict`` reduced to its
        ``lr_mult`` / ``wd_mult`` (all the optimizer reads of it), so a
        pickled optimizer carries no block or tensor."""
        state = dict(self.__dict__)
        state["param_dict"] = {i: _Mults(p.lr_mult, p.wd_mult)
                               for i, p in self.param_dict.items()}
        return state

    @staticmethod
    def register(klass):
        _REG[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        key = name.lower()
        if key in _REG:
            return _REG[key](**kwargs)
        if key in _UNPORTED:
            raise NotImplementedError(
                "optimizer %r is not ported yet: ROADMAP.md queue A, item 1 "
                "(the other optimizers); ported: %s" % (name, sorted(_REG)))
        raise MXNetError("Cannot find optimizer %r. Registered: %s"
                         % (name, sorted(_REG)))

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and _is_low_precision(weight.dtype):
            master = weight.detach().to(torch.float32)
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and _is_low_precision(weight.dtype):
            master, inner = state
            self.update(index, master, grad.to(torch.float32), inner)
            _write(weight, master.to(weight.dtype))
        else:
            self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("lr_scheduler is set; use scheduler to change "
                              "lr")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _clip_arg(self):
        return -1.0 if self.clip_gradient is None else self.clip_gradient


class _Mults:
    __slots__ = ("lr_mult", "wd_mult")

    def __init__(self, lr_mult, wd_mult):
        self.lr_mult, self.wd_mult = lr_mult, wd_mult

    def __getstate__(self):
        return (self.lr_mult, self.wd_mult)

    def __setstate__(self, state):
        self.lr_mult, self.wd_mult = state


def _is_low_precision(dtype):
    """Weights of these dtypes get f32 masters under multi_precision."""
    return dtype in (torch.float16, torch.bfloat16)


register = Optimizer.register
create = Optimizer.create_optimizer


def _write(dst, src):
    with torch.no_grad():
        dst.copy_(src)


@register
class SGD(Optimizer):
    """SGD with momentum (reference: optimizer.py SGD,
    optimizer_op-inl.h sgd_update / sgd_mom_update)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight, requires_grad=False)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                  clip_gradient=self._clip_arg())
        if state is not None:
            nw, nm = ops.sgd_mom_update(weight, grad, state,
                                        momentum=self.momentum, **kw)
            _write(state, nm)
        else:
            nw = ops.sgd_update(weight, grad, **kw)
        _write(weight, nw)


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (torch.zeros_like(weight, requires_grad=False),
                torch.zeros_like(weight, requires_grad=False))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        m, v = state
        # the bias-corrected rate into the adam_update rule, as the
        # reference optimizer does (optimizer.py Adam.update)
        lr_t = lr * ((1 - self.beta2 ** t) ** 0.5) / (1 - self.beta1 ** t)
        nw, nm, nv = ops.adam_update(
            weight, grad, m, v, lr=lr_t, wd=wd, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon,
            rescale_grad=self.rescale_grad, clip_gradient=self._clip_arg())
        _write(m, nm)
        _write(v, nv)
        _write(weight, nw)


def _tensor(x):
    return getattr(x, "_data", x)


def _to_numpy(s):
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_to_numpy(x) for x in s)
    t = s.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _to_tensor(s, like):
    """A state loaded from numpy, on ``like``'s device; an f32 state of a
    low-precision weight outside multi-precision is cast back to the
    weight's dtype (bfloat16 states are pickled widened)."""
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_to_tensor(x, like) for x in s)
    if not isinstance(s, np.ndarray):
        return s
    return torch.from_numpy(np.array(s)).to(like.device)


class Updater:
    """Applies ``optimizer`` to (index, grad, weight), creating each
    index's state on first use (reference: optimizer.py:618-666)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        grad, weight = _tensor(grad), _tensor(weight)
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            state = _to_tensor(self.states[index], weight)
            mp = self.optimizer.multi_precision \
                and _is_low_precision(weight.dtype)
            if not mp and _is_low_precision(weight.dtype):
                state = _cast(state, weight.dtype)
            self.states[index] = state
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):
        states = {k: _to_numpy(v) for k, v in self.states.items()}
        if dump_optimizer:
            return pickle.dumps((states, self.optimizer))
        return pickle.dumps(states)

    def set_states(self, states):
        loaded = pickle.loads(states)
        if isinstance(loaded, tuple) and len(loaded) == 2 \
                and isinstance(loaded[1], Optimizer):
            loaded, self.optimizer = loaded
        self.states = dict(loaded)
        self.states_synced = {k: False for k in self.states}


def _cast(s, dtype):
    if isinstance(s, tuple):
        return tuple(_cast(x, dtype) for x in s)
    return s if s is None else s.to(dtype)


def get_updater(optimizer):
    return Updater(optimizer)
