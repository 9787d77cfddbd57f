"""Optimizer update rules as registered operators: the port of
``mxnet_tpu/ops/optimizer_ops.py`` (the 11 dense update ops and
``_sparse_adagrad_update``, ``:43-217``).

Each rule is a plain torch function returning ``(new_weight,
*new_states)`` that mutates nothing; registered under the reference's
name with its ``mutates`` map, so ``nd.sgd_mom_update(w, g, mom,
out=w)`` writes ``mom`` in place as the reference's does.  They are the
unfused route of the optimizers (``optimizer.py``) and the numerics
oracle the fused CUDA kernels of ``ops/fused_optimizer.py`` are held to.
The clip convention is the reference's: ``clip_gradient`` None or
negative disables clipping.  The ``mp_*`` rules keep the float32 master
weight as an input and return the weight rounded from it.

``_sparse_adagrad_update`` / ``sparse_adagrad_update`` is, as in the
reference, AdaGrad's rule on dense tensors (every row updated); a
row-sparse gradient takes the row-wise path of ``optimizer.AdaGrad``,
which reads and writes only the rows it holds.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "signsgd_update", "signum_update",
           "adam_update", "rmsprop_update", "rmspropalex_update",
           "ftrl_update", "ftml_update", "sparse_adagrad_update"]


def _clip(g, c):
    """MXNet clip_gradient convention: negative (or None) disables."""
    if c is not None and c >= 0:
        return torch.clamp(g, -c, c)
    return g


@register("sgd_update", arg_names=["weight", "grad"])
def sgd_update(weight, grad, lr=None, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """w = (1 - lr*wd)*w - lr*clip(rescale_grad*g)."""
    g = _clip(rescale_grad * grad, clip_gradient)
    return (1.0 - lr * wd) * weight - lr * g


@register("sgd_mom_update", arg_names=["weight", "grad", "mom"],
          mutates={2: 1})
def sgd_mom_update(weight, grad, mom, lr=None, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """mom = momentum*mom - lr*wd*w - lr*clip(rescale_grad*g); w += mom.
    Returns ``(new_weight, new_mom)``."""
    g = _clip(rescale_grad * grad, clip_gradient)
    new_mom = momentum * mom - lr * wd * weight - lr * g
    return weight + new_mom, new_mom


@register("mp_sgd_update", arg_names=["weight", "grad", "weight32"],
          mutates={2: 1})
def mp_sgd_update(weight, grad, weight32, lr=None, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """SGD on the float32 master, the weight rounded from it."""
    g = _clip(rescale_grad * grad.float(), clip_gradient)
    w32 = (1.0 - lr * wd) * weight32 - lr * g
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update",
          arg_names=["weight", "grad", "mom", "weight32"],
          mutates={2: 1, 3: 2})
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=None, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    """Momentum SGD on the float32 master, the weight rounded from it."""
    g = _clip(rescale_grad * grad.float(), clip_gradient)
    new_mom = momentum * mom - lr * wd * weight32 - lr * g
    w32 = weight32 + new_mom
    return w32.to(weight.dtype), new_mom, w32


@register("signsgd_update", arg_names=["weight", "grad"])
def signsgd_update(weight, grad, lr=None, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """w = (1 - lr*wd)*w - lr*sign(g); a clip leaves a sign as it is."""
    return (1.0 - lr * wd) * weight - lr * torch.sign(grad)


@register("signum_update", arg_names=["weight", "grad", "mom"],
          mutates={2: 1})
def signum_update(weight, grad, mom, lr=None, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """mom = momentum*mom - (1-momentum)*(wd*w + clip(rescale*g));
    w = (1 - lr*wd_lh)*w + lr*sign(mom)."""
    g = _clip(rescale_grad * grad, clip_gradient)
    new_mom = momentum * mom - (1.0 - momentum) * wd * weight \
        - (1.0 - momentum) * g
    return (1.0 - lr * wd_lh) * weight + lr * torch.sign(new_mom), new_mom


@register("adam_update", arg_names=["weight", "grad", "mean", "var"],
          mutates={2: 1, 3: 2})
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


def _clip_weights(w, cw):
    if cw is not None and cw >= 0:
        return torch.clamp(w, -cw, cw)
    return w


@register("rmsprop_update", arg_names=["weight", "grad", "n"],
          mutates={2: 1})
def rmsprop_update(weight, grad, n, lr=None, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    """RMSProp over the running mean of squared gradients (Hinton's)."""
    g = _clip(rescale_grad * grad + wd * weight, clip_gradient)
    new_n = (1.0 - gamma1) * torch.square(g) + gamma1 * n
    out = weight - lr * g / torch.sqrt(new_n + epsilon)
    return _clip_weights(out, clip_weights), new_n


@register("rmspropalex_update",
          arg_names=["weight", "grad", "n", "g", "delta"],
          mutates={2: 1, 3: 2, 4: 3})
def rmspropalex_update(weight, grad, n, g, delta, lr=None, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp (Graves 2013) over n, g and delta."""
    gr = _clip(rescale_grad * grad + wd * weight, clip_gradient)
    new_n = (1.0 - gamma1) * torch.square(gr) + gamma1 * n
    new_g = (1.0 - gamma1) * gr + gamma1 * g
    new_delta = gamma2 * delta \
        - lr * gr / torch.sqrt(new_n - torch.square(new_g) + epsilon)
    out = weight + new_delta
    return _clip_weights(out, clip_weights), new_n, new_g, new_delta


@register("ftrl_update", arg_names=["weight", "grad", "z", "n"],
          mutates={2: 1, 3: 2})
def ftrl_update(weight, grad, z, n, lr=None, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-proximal over z and n."""
    g = _clip(rescale_grad * grad, clip_gradient)
    new_z = z + g - (torch.sqrt(n + torch.square(g)) - torch.sqrt(n)) \
        * weight / lr
    new_n = n + torch.square(g)
    out = (torch.sign(new_z) * lamda1 - new_z) \
        / ((beta + torch.sqrt(new_n)) / lr + wd) \
        * (torch.abs(new_z) > lamda1)
    return out, new_z, new_n


@register("ftml_update", arg_names=["weight", "grad", "d", "v", "z"],
          mutates={2: 1, 3: 2, 4: 3})
def ftml_update(weight, grad, d, v, z, lr=None, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    """FTML over d, v and z at step ``t`` (the reference spells this op's
    clip ``clip_grad``)."""
    g = _clip(rescale_grad * grad + wd * weight, clip_grad)
    new_v = beta2 * v + (1.0 - beta2) * torch.square(g)
    d_t = (1.0 - beta1 ** t) / lr \
        * (torch.sqrt(new_v / (1.0 - beta2 ** t)) + epsilon)
    new_z = beta1 * z + (1.0 - beta1) * g - (d_t - beta1 * d) * weight
    return -new_z / d_t, d_t, new_v, new_z


@register("_sparse_adagrad_update",
          arg_names=["weight", "grad", "history"], mutates={2: 1},
          aliases=("sparse_adagrad_update",))
def sparse_adagrad_update(weight, grad, history, lr=None, epsilon=1e-7,
                          wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """AdaGrad over a dense gradient (``optimizer_ops.py:207-217``).
    Returns ``(new_weight, new_history)``."""
    g = _clip(rescale_grad * grad, clip_gradient)
    if wd:
        g = g + wd * weight
    new_hist = history + torch.square(g)
    return weight - lr * g / (torch.sqrt(new_hist) + epsilon), new_hist
