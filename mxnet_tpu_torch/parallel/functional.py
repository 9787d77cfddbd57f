"""The unfused optimizer route of the trainer: the port of
``functional_optimizer_update`` from ``mxnet_tpu/parallel/functional.py``
(``:162-195``).  The rest of that module (forward functionalization,
gradient accumulation) has no counterpart here: PyTorch runs the forward
eagerly and autograd holds the gradients.
"""
from __future__ import annotations

import torch

__all__ = ["functional_optimizer_update"]


def _clone(state):
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(_clone(s) for s in state)
    return state.detach().clone()


def functional_optimizer_update(opt, index, weight, grad, state, lr, t):
    """One ``Optimizer.update`` call as a function: returns
    ``(new_weight, new_state)`` and leaves ``weight`` and ``state`` as
    they were.

    ``lr`` (host-computed; schedulers are Python) and ``t`` (the update
    count, for Adam's bias correction) are pinned on ``opt`` for the call
    and restored after, as the reference does for its traced scalars."""
    w = weight.detach().clone()
    st = _clone(state)
    saved = (opt.lr, opt.lr_scheduler, opt._index_update_count.get(index),
             opt.num_update)
    opt.lr = lr
    opt.lr_scheduler = None
    opt._index_update_count[index] = t
    # the count is pinned: the instance attribute shadows the method
    opt._update_count = lambda _idx: None
    try:
        with torch.no_grad():
            opt.update_multi_precision(index, w, grad, st)
    finally:
        del opt._update_count
        opt.lr, opt.lr_scheduler = saved[0], saved[1]
        if saved[2] is None:
            opt._index_update_count.pop(index, None)
        else:
            opt._index_update_count[index] = saved[2]
        opt.num_update = saved[3]
    return w, st
