"""Optimizer update rules as plain torch functions: the port of
``mxnet_tpu/ops/optimizer_ops.py`` (``sgd_update``, ``sgd_mom_update``,
``adam_update``, ``:43-130``).

Each returns new tensors ``(new_weight, *new_states)`` and mutates
nothing; :class:`~mxnet_tpu_torch.optimizer.Optimizer` writes them back.
They are the numerics oracle the fused CUDA kernels of
``ops/fused_optimizer.py`` are held to, and the unfused route of the
trainer.  The clip convention is the reference's: ``clip_gradient`` None
or negative disables clipping.  The other update rules of the reference
module wait for the optimizers that use them (ROADMAP queue A, item 1).
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update"]


def _clip(g, c):
    """MXNet clip_gradient convention: negative (or None) disables."""
    if c is not None and c >= 0:
        return torch.clamp(g, -c, c)
    return g


def sgd_update(weight, grad, lr=None, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """w = (1 - lr*wd)*w - lr*clip(rescale_grad*g)."""
    g = _clip(rescale_grad * grad, clip_gradient)
    return (1.0 - lr * wd) * weight - lr * g


def sgd_mom_update(weight, grad, mom, lr=None, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """mom = momentum*mom - lr*wd*w - lr*clip(rescale_grad*g); w += mom.
    Returns ``(new_weight, new_mom)``."""
    g = _clip(rescale_grad * grad, clip_gradient)
    new_mom = momentum * mom - lr * wd * weight - lr * g
    return weight + new_mom, new_mom


def adam_update(weight, grad, mean, var, lr=None, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    """One Adam step with the bias-corrected ``lr`` computed by the caller
    (as the reference's ``Adam.update`` does).  Returns
    ``(new_weight, new_mean, new_var)``."""
    g = _clip(rescale_grad * grad + wd * weight, clip_gradient)
    new_mean = beta1 * mean + (1.0 - beta1) * g
    new_var = beta2 * var + (1.0 - beta2) * torch.square(g)
    out = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return out, new_mean, new_var
