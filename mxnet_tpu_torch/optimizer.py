"""Optimizers: the port of ``mxnet_tpu/optimizer.py`` — ``Optimizer``
(``:26-120``), every optimizer the reference registers (``:149-604``:
SGD, Signum, FTML, LBSGD, DCASGD, NAG, SGLD, Adam, AdaGrad, RMSProp
plain and centered, AdaDelta, Ftrl, Adamax, Nadam and Test), ``register``
and ``create``.

``update(index, weight, grad, state)`` applies the reference's rule and
writes the result into ``weight`` and ``state`` in place: through the
update ops of ``ops/optimizer_ops.py`` where the reference calls its ops
(SGD, Signum, FTML, Adam, AdaGrad, RMSProp, Ftrl), else in torch
arithmetic that follows the reference's line by line.  The trainer's
fused path (``ops.fused_optimizer.fused_optimizer_update``) reads the
same attributes, and takes SGD and Adam only, by exact type (NAG and
LBSGD subclass SGD and stay off it).  SGLD draws its noise from the
seeded generator of the weight's device (``_rng``).  Nadam's
``m_schedule`` compounds once per ``update`` call, that is once per
parameter per step, as on the reference's Gluon route.

:class:`Updater` (``get_updater``, ``:618-666``) applies an optimizer per
index with lazily created states, as the Gluon ``Trainer`` and the
kvstore run it; its ``get_states`` pickles ``{index: numpy array or
tuple}`` as the reference's does, so a states file either package writes
loads in the other (``dump_optimizer=True`` pickles the optimizer's
class too, which only its own package can load).

A row-sparse gradient (``ndarray.sparse.RowSparseNDArray``) takes the
lazy row-wise update of SGD (``:176-183``, ``:214-228``), Adam
(``:404-417``) and AdaGrad (``:443-458``): only the rows it holds of the
weight and the state are read or written.  Where it holds a row twice,
the weight takes both steps and the state the last one, as the
reference's ``.at[].add`` / ``.at[].set`` give it on the CPU; the port
writes that last value explicitly, so the card gives it too.

``multi_precision=True`` (``:60-75``, ``:124-211``): a bfloat16 or
float16 weight gets an f32 master copy in its state,
``(master, inner_state)``; ``update_multi_precision`` runs the update on
the master with the gradient widened to f32 and writes the master,
rounded, back into the weight.  SGD and its subclasses run SGD's rule
there, as the reference's ``mp_sgd_update`` / ``mp_sgd_mom_update``
do (so NAG and LBSGD under ``multi_precision`` step as SGD, as in the
reference).
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from .base import MXNetError
from .ndarray.sparse import BaseSparseNDArray, RowSparseNDArray
from .ops import optimizer_ops as ops

__all__ = ["Optimizer", "SGD", "Signum", "FTML", "LBSGD", "DCASGD", "NAG",
           "SGLD", "Adam", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl",
           "Adamax", "Nadam", "Test", "ccSGD", "Updater", "register",
           "create", "get_updater"]

_REG = {}


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

    def _prep_grad(self, grad):
        """``rescale_grad * grad`` clipped to ``clip_gradient`` (the
        reference's ``_prep_grad``: any clip that is not None applies)."""
        g = grad * self.rescale_grad if self.rescale_grad != 1.0 else grad
        if self.clip_gradient is not None:
            c = self.clip_gradient
            g = torch.minimum(torch.maximum(g, g.new_tensor(-c)),
                              g.new_tensor(c))
        return g


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


def _rows_of(grad, weight):
    """(int64 row indices, rows) of a row-sparse gradient, on the weight's
    device (raises on another)."""
    idx, rows = grad.indices._data, grad.data._data
    if idx.device != weight.device or rows.device != weight.device:
        raise MXNetError("row-sparse gradient on %s for a weight on %s"
                         % (rows.device, weight.device))
    return idx.long(), rows


def _last_occurrence(idx):
    """For each position of ``idx``, the position of the last occurrence
    of its index."""
    sorted_idx, order = torch.sort(idx, stable=True)
    return order[torch.searchsorted(sorted_idx, idx, right=True) - 1]


def _set_rows(dst, idx, rows, last):
    """``dst[idx] = rows`` where the last of a repeated index wins
    (``last`` from :func:`_last_occurrence`): every occurrence writes that
    last value, so no device leaves the choice open."""
    dst.index_copy_(0, idx, rows.index_select(0, last))


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
        if isinstance(grad, RowSparseNDArray):
            self._sparse_update(weight, grad, state, lr, wd)
            return
        kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                  clip_gradient=self._clip_arg())
        if state is not None:
            nw, nm = ops.sgd_mom_update(weight, grad, state,
                                        momentum=self.momentum, **kw)
            _write(state, nm)
        else:
            nw = ops.sgd_update(weight, grad, **kw)
        _write(weight, nw)

    def _apply(self, w, g, mom, lr, wd):
        """The reference's functional SGD core (``SGD._apply``)."""
        g = self._prep_grad(g) + wd * w
        if mom is None:
            return w - lr * g, None
        new_mom = self.momentum * mom - lr * g
        return w + new_mom, new_mom

    def _sparse_update(self, weight, grad, state, lr, wd):
        """The lazy row-wise rule (reference: ``_sparse_sgd_update``,
        optimizer_op-inl.h SGDUpdateRspRspImpl)."""
        idx, g = _rows_of(grad, weight)
        with torch.no_grad():
            upd = self._prep_grad(g) + wd * weight.index_select(0, idx)
            if state is None:
                weight.index_add_(0, idx, -lr * upd)
                return
            m_rows = self.momentum * state.index_select(0, idx) - lr * upd
            _set_rows(state, idx, m_rows, _last_occurrence(idx))
            weight.index_add_(0, idx, m_rows)

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and _is_low_precision(weight.dtype) \
                and not isinstance(grad, RowSparseNDArray):
            master, mom = state
            SGD.update(self, index, master, grad.to(torch.float32), mom)
            _write(weight, master.to(weight.dtype))
        else:
            super().update_multi_precision(index, weight, grad, state)


def _zeros(weight, dtype=None):
    return torch.zeros(weight.shape, dtype=dtype or weight.dtype,
                       device=weight.device)


@register
class Signum(Optimizer):
    """signSGD, or Signum with momentum (reference: optimizer.py Signum,
    ``signsgd_update`` / ``signum_update``)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                  clip_gradient=self._clip_arg())
        if state is not None:
            nw, nm = ops.signum_update(weight, grad, state,
                                       momentum=self.momentum,
                                       wd_lh=self.wd_lh, **kw)
            _write(state, nm)
        else:
            nw = ops.signsgd_update(weight, grad, **kw)
        _write(weight, nw)


@register
class FTML(Optimizer):
    """Follow the Moving Leader (reference: optimizer.py FTML,
    ``ftml_update``); state ``(d, v, z)``."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        d, v, z = state
        nw, nd_, nv, nz = ops.ftml_update(
            weight, grad, d, v, z, lr=lr, wd=wd, t=t, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon,
            rescale_grad=self.rescale_grad, clip_grad=self._clip_arg())
        for dst, src in ((d, nd_), (v, nv), (z, nz), (weight, nw)):
            _write(dst, src)


@register
class LBSGD(SGD):
    """Large-batch SGD: the gradient scaled by the layer's LARS ratio
    ``|w| / (|g| + wd |w|)`` clipped to [0, 10], then SGD's rule
    (reference: optimizer.py LBSGD).  Its norms run over each whole
    parameter, so ``DataParallelTrainer`` refuses it, as the
    reference's does."""

    def __init__(self, momentum=0.9, warmup_strategy="linear",
                 warmup_epochs=5, batch_scale=1, updates_per_epoch=32,
                 begin_epoch=0, num_epochs=60, **kwargs):
        super().__init__(momentum=momentum, **kwargs)

    def update(self, index, weight, grad, state):
        wnorm = torch.linalg.vector_norm(weight)
        gnorm = torch.linalg.vector_norm(grad * self.rescale_grad)
        lars = torch.where(gnorm > 0,
                           wnorm / (gnorm + self.wd * wnorm + 1e-9),
                           torch.ones_like(wnorm))
        lars = torch.clamp(lars, 0.0, 10.0)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        nw, nm = self._apply(weight, grad * lars, state, lr, wd)
        _write(weight, nw)
        if state is not None:
            _write(state, nm)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference: optimizer.py
    DCASGD); state ``(momentum or None, previous weight)``."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = weight.detach().clone()
        if self.momentum == 0.0:
            return (None, prev)
        return (_zeros(weight), prev)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prep_grad(grad) + wd * weight
        mom, prev = state
        comp = g + self.lamda * g * g * (weight - prev)
        if mom is not None:
            m = self.momentum * mom - lr * comp
            _write(mom, m)
            nw = weight + m
        else:
            nw = weight - lr * comp
        _write(prev, weight)
        _write(weight, nw)


@register
class NAG(SGD):
    """Nesterov accelerated SGD (reference: optimizer.py NAG)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prep_grad(grad) + wd * weight
        if state is not None:
            m = self.momentum * state + g
            _write(state, m)
            nw = weight - lr * (g + self.momentum * m)
        else:
            nw = weight - lr * g
        _write(weight, nw)


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics: half a gradient step plus
    Normal(0, lr) noise drawn from the seeded generator of the weight's
    device (reference: optimizer.py SGLD)."""

    def update(self, index, weight, grad, state):
        from . import _rng
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prep_grad(grad) + wd * weight
        noise = torch.randn(weight.shape, dtype=weight.dtype,
                            device=weight.device,
                            generator=_rng.next_generator(weight.device))
        _write(weight, weight - lr / 2 * g + noise * math.sqrt(lr))


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
        if isinstance(grad, RowSparseNDArray):
            idx, g = _rows_of(grad, weight)
            b1, b2 = self.beta1, self.beta2
            with torch.no_grad():
                g = self._prep_grad(g) + wd * weight.index_select(0, idx)
                m_rows = b1 * m.index_select(0, idx) + (1 - b1) * g
                v_rows = b2 * v.index_select(0, idx) + (1 - b2) * g * g
                last = _last_occurrence(idx)
                _set_rows(m, idx, m_rows, last)
                _set_rows(v, idx, v_rows, last)
                weight.index_add_(0, idx, -lr_t * m_rows
                                  / (torch.sqrt(v_rows) + self.epsilon))
            return
        nw, nm, nv = ops.adam_update(
            weight, grad, m, v, lr=lr_t, wd=wd, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon,
            rescale_grad=self.rescale_grad, clip_gradient=self._clip_arg())
        _write(m, nm)
        _write(v, nv)
        _write(weight, nw)


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference: optimizer.py AdaGrad): a dense gradient through
    the ``_sparse_adagrad_update`` op's rule, a row-sparse one row-wise."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if isinstance(grad, RowSparseNDArray):
            idx, g = _rows_of(grad, weight)
            with torch.no_grad():
                g = self._prep_grad(g)
                if wd:
                    g = g + wd * weight.index_select(0, idx)
                h_rows = state.index_select(0, idx) + g * g
                _set_rows(state, idx, h_rows, _last_occurrence(idx))
                weight.index_add_(0, idx, -lr * g / (
                    torch.sqrt(h_rows) + self.float_stable_eps))
            return
        nw, nh = ops.sparse_adagrad_update(
            weight, grad, state, lr=lr, wd=wd, epsilon=self.float_stable_eps,
            rescale_grad=self.rescale_grad, clip_gradient=self._clip_arg())
        _write(state, nh)
        _write(weight, nw)


@register
class RMSProp(Optimizer):
    """RMSProp, plain (state ``(n,)``) or centered (``(n, g, delta)``)
    (reference: optimizer.py RMSProp, ``rmsprop_update`` /
    ``rmspropalex_update``)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return (_zeros(weight),)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = dict(lr=lr, wd=wd, gamma1=self.gamma1, epsilon=self.epsilon,
                  rescale_grad=self.rescale_grad,
                  clip_gradient=self._clip_arg(),
                  clip_weights=-1.0 if not self.clip_weights
                  else self.clip_weights)
        if self.centered:
            outs = ops.rmspropalex_update(weight, grad, *state,
                                          gamma2=self.gamma2, **kw)
        else:
            outs = ops.rmsprop_update(weight, grad, *state, **kw)
        for dst, src in zip(state, outs[1:]):
            _write(dst, src)
        _write(weight, outs[0])


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference: optimizer.py AdaDelta); float32 state
    ``(acc_g, acc_delta)``; no learning rate."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        g = self._prep_grad(grad) + wd * weight
        acc_g, acc_delta = state
        ag = self.rho * acc_g + (1 - self.rho) * g * g
        delta = torch.sqrt(acc_delta + self.epsilon) \
            / torch.sqrt(ag + self.epsilon) * g
        ad = self.rho * acc_delta + (1 - self.rho) * delta * delta
        _write(acc_g, ag)
        _write(acc_delta, ad)
        _write(weight, weight - delta)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (reference: optimizer.py Ftrl, ``ftrl_update``);
    float32 state ``(z, n)``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        z, n = state
        nw, nz, nn_ = ops.ftrl_update(
            weight, grad, z, n, lr=lr, wd=wd, lamda1=self.lamda1,
            beta=self.beta, rescale_grad=self.rescale_grad,
            clip_gradient=self._clip_arg())
        _write(z, nz)
        _write(n, nn_)
        _write(weight, nw)


@register
class Adamax(Optimizer):
    """Adamax, Adam under the infinity norm (reference: optimizer.py
    Adamax); float32 state ``(m, u)``."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        g = self._prep_grad(grad) + wd * weight
        lr_t = lr / (1 - self.beta1 ** t)
        m, u = state
        m_t = self.beta1 * m + (1 - self.beta1) * g
        u_t = torch.maximum(self.beta2 * u, torch.abs(g))
        _write(m, m_t)
        _write(u, u_t)
        _write(weight, weight - lr_t * m_t / (u_t + 1e-8))


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum (reference: optimizer.py Nadam);
    float32 state ``(m, v)``.  ``m_schedule`` compounds at every
    ``update`` call (module docstring)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        g = self._prep_grad(grad) + wd * weight
        mom_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        mom_tp1 = self.beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1)
                                                     * self.schedule_decay))
        self.m_schedule = self.m_schedule * mom_t
        sched_next = self.m_schedule * mom_tp1
        m, v = state
        g_prime = g / (1.0 - self.m_schedule)
        m_t = self.beta1 * m + (1 - self.beta1) * g
        v_t = self.beta2 * v + (1 - self.beta2) * g * g
        m_prime = m_t / (1.0 - sched_next)
        v_prime = v_t / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - mom_t) * g_prime + mom_tp1 * m_prime
        _write(m, m_t)
        _write(v, v_t)
        _write(weight, weight - lr * m_bar
               / (torch.sqrt(v_prime) + self.epsilon))


@register
class Test(Optimizer):
    """The reference's test optimizer: ``w += rescale_grad * g``, and the
    state holds the new weight."""

    def create_state(self, index, weight):
        return _zeros(weight, torch.float32)

    def update(self, index, weight, grad, state):
        _write(weight, weight + grad * self.rescale_grad)
        _write(state, weight)


# the reference's alias
ccSGD = SGD


def _tensor(x):
    """The torch tensor of an NDArray; a sparse array as it is."""
    return x if isinstance(x, BaseSparseNDArray) else getattr(x, "_data", x)


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
