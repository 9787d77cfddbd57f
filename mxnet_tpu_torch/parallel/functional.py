"""The unfused optimizer route and gradient accumulation of the trainer:
the port of ``functional_optimizer_update`` (``:162-195``) and
``accumulate_grads`` (``:117-160``) from
``mxnet_tpu/parallel/functional.py``.  Forward functionalization has no
counterpart here: PyTorch runs the forward eagerly and autograd holds
the gradients.
"""
from __future__ import annotations

import torch

__all__ = ["accumulate_grads", "functional_optimizer_update"]


def _clone(state):
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(_clone(s) for s in state)
    return state.detach().clone()


def accumulate_grads(grad_of, x, y, n_acc):
    """Left-fold microbatch gradient accumulation, the one spelling behind
    ``DataParallelTrainer(grad_accum=N)`` on both tiers.

    The batch's leading dim splits into ``n_acc`` equal microbatches, run
    in order through ``grad_of(x_micro, y_micro) -> (loss, muts, grads)``.
    ``grads`` is a tuple of gradient tensors summed left to right from
    zero (``((0 + g_1) + g_2) + ...``), or ``None`` when ``grad_of`` adds
    its gradient into the caller's buffers itself (autograd's ``.grad``
    accumulation is the same fold: a zeroed buffer plus each microbatch's
    gradient in turn).  The accumulated gradient is bitwise the fold of
    the per-microbatch gradients; it is not bitwise the large-batch
    step's, whose loss mean reassociates the sum.

    Returns ``(grads_sum, loss_sum, muts_stack)``: ``grads_sum`` is
    ``None`` when ``grad_of`` accumulates in place; ``muts_stack`` holds
    each mutated state's ``(n_acc, ...)`` stack.  The caller divides by
    ``n_acc`` and averages the stacks (the reference's trainer)."""
    n = int(n_acc)
    b = x.shape[0]
    if n > 1 and b % n:
        raise ValueError(
            "grad_accum=%d does not divide the (per-replica) batch %d: "
            "microbatches must be equal-sized for the accumulated mean "
            "to equal the batch mean" % (n, b))
    n = max(n, 1)
    m = b // n
    acc, loss_sum, muts_all = None, None, []
    for i in range(n):
        loss, muts, grads = grad_of(x[i * m:(i + 1) * m],
                                    y[i * m:(i + 1) * m])
        if grads is not None:
            grads = tuple(grads)
            acc = tuple(torch.zeros_like(g) + g for g in grads) \
                if acc is None else tuple(a + g for a, g in zip(acc, grads))
        loss = loss.detach().float()
        loss_sum = torch.zeros_like(loss) + loss if loss_sum is None \
            else loss_sum + loss
        muts_all.append(tuple(muts))
    muts_stack = tuple(torch.stack(ms) for ms in zip(*muts_all))
    return acc, loss_sum, muts_stack


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
