"""The old contrib autograd API (reference: python/mxnet/contrib/
autograd.py), over the port's ``autograd``."""
from __future__ import annotations

from .. import autograd as _ag

__all__ = ["set_is_training", "train_section", "test_section",
           "backward", "grad_and_loss", "grad"]


def set_is_training(is_train):
    """Set the training flag; returns the previous one."""
    prev = _ag.is_training()
    _ag.set_training(is_train)
    return prev


train_section = _ag.record
test_section = _ag.pause


def backward(outputs, out_grads=None, retain_graph=False):
    _ag.backward(outputs, head_grads=out_grads, retain_graph=retain_graph)


def grad_and_loss(func, argnum=None):
    """``func`` wrapped to return (the gradients of its output with
    respect to its arguments, or those named by ``argnum``, and the
    output)."""
    def wrapped(*args):
        variables = list(args)
        if argnum is not None:
            idx = argnum if isinstance(argnum, (list, tuple)) else [argnum]
            variables = [args[i] for i in idx]
        for x in variables:
            x.attach_grad()
        with _ag.record():
            outputs = func(*args)
        _ag.backward([outputs] if not isinstance(outputs, (list, tuple))
                     else list(outputs))
        return [x.grad for x in variables], outputs
    return wrapped


def grad(func, argnum=None):
    """``func`` wrapped to return the gradients only."""
    def wrapped(*args):
        return grad_and_loss(func, argnum)(*args)[0]
    return wrapped
