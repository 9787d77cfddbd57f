"""DataParallelTrainer: the port of the single-device replicated tier of
``mxnet_tpu/parallel/trainer.py``.

One ``step(x, y)`` runs the block forward in training mode, the loss's
``.mean()`` backward, then ``_apply_groups``: the optimizer update of
every parameter bucket.  BatchNorm's moving statistics are written by the
forward itself, in place.

Buckets (``trainer.py:355-405``): with SGD or Adam (the fused path,
``ops.fused_optimizer.supports``) every trainable parameter goes into a
bucket keyed by ``(lr_mult, wd_mult, dtype)``, with no size cap, and each
bucket is updated by ONE launch of the fused CUDA kernel.  The bucket's
parameters are views of one flat f32 buffer, and their ``.grad``s views
of one flat gradient buffer, zeroed each step rather than set to None
(the ``gradient_as_bucket_view`` idiom): autograd accumulates into the
buffer and the kernel updates the bucket in place, with no concatenation
or split per step.  The reference concatenates instead
(``trainer.py:1265-1280``); the numbers are the same.  Another optimizer
keeps one group per parameter and the unfused route
(``parallel.functional.functional_optimizer_update``).

The mesh, kvstore, ZeRO, multi-axis, mixed-precision, gradient
accumulation and input-transform tiers of the reference raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, resolve_device
from ..ops import fused_optimizer as _fused
from .functional import functional_optimizer_update

__all__ = ["DataParallelTrainer"]


def _unported(arg, item):
    raise NotImplementedError(
        "DataParallelTrainer(%s=...) is not ported yet: ROADMAP.md queue A, "
        "item %s; the port trains one device, replicated, in f32" % (arg,
                                                                    item))


def _as_tensor(v, device):
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return t.to(device, non_blocking=True)


class DataParallelTrainer:
    """Train a Gluon block on one device.

    Parameters
    ----------
    block : gluon.Block, initialized on ``device`` (deferred shapes are
        resolved at the first step).
    loss : gluon.loss.Loss or callable(pred, label) -> per-sample loss.
    optimizer : str or Optimizer; ``optimizer_params`` go to ``create``.
    device : where the step runs; ``None`` means CUDA (raising without a
        card), ``"cpu"`` the host.
    """

    def __init__(self, block, loss, optimizer, optimizer_params=None,
                 mesh=None, param_spec_fn=None, data_axis="data",
                 kvstore=None, input_transform=None, zero=0,
                 mesh_plan=None, model_parallel=None, sequence_parallel=None,
                 dtype=None, grad_accum=1, device=None):
        from .. import optimizer as opt_mod
        for arg, val, item in (
                ("mesh", mesh, "6 (distributed data parallel)"),
                ("param_spec_fn", param_spec_fn, "6 (distributed data "
                 "parallel)"),
                ("kvstore", kvstore, "6 (distributed data parallel)"),
                ("zero", zero or None, "6 (ZeRO-1)"),
                ("mesh_plan", mesh_plan, "7 (model-axis sharding)"),
                ("model_parallel", model_parallel, "7 (model-axis "
                 "sharding)"),
                ("sequence_parallel", sequence_parallel, "8 (transformer "
                 "training)"),
                ("grad_accum", None if grad_accum in (None, 1)
                 else grad_accum, "6 (distributed data parallel)"),
                ("input_transform", input_transform, "3 (data pipeline)")):
            if val is not None:
                _unported(arg, item)
        if dtype not in (None, "float32", "f32", "fp32", np.float32,
                         torch.float32):
            _unported("dtype", "5 (mixed precision)")
        self._device = resolve_device(device)
        self._block = block
        self._loss = loss
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        self._opt = optimizer
        self._ready = False
        self._step_count = 0

    # -- setup -------------------------------------------------------------
    def _setup(self, data):
        block, dev = self._block, self._device
        if any(p._deferred_init for p in block.collect_params().values()):
            # one inference-mode forward on one sample resolves the
            # deferred shapes (the reference's autograd.pause() pass)
            was = block.training
            block.train(False)
            try:
                with torch.no_grad():
                    block(data[:1])
            finally:
                block.train(was)
        params = block.collect_params()
        self._params_by_name = dict(params.items())
        self._train_names = [n for n, p in params.items()
                             if p.grad_req != "null"]
        self._aux_names = [n for n, p in params.items()
                           if p.grad_req == "null"]
        for n, p in params.items():
            if p.data().device != dev:
                raise MXNetError(
                    "parameter %s lives on %s but the trainer runs on %s: "
                    "initialize the block with ctx=%s" % (n, p.data().device,
                                                          dev, dev))

        self._fused_on = _fused.supports(self._opt) is not None
        buckets, singles = {}, []
        for name in self._train_names:
            p = self._params_by_name[name]
            if not self._fused_on:
                singles.append([name])
                continue
            key = (float(p.lr_mult), float(p.wd_mult),
                   str(np.dtype(p.dtype) if p.dtype else "float32"))
            buckets.setdefault(key, []).append(name)
        self._groups = list(buckets.values()) + singles

        self._w_flat, self._g_flat, self._states = [], [], []
        for gi, names in enumerate(self._groups):
            wf, gf = self._make_bucket([self._params_by_name[n].data()
                                        for n in names])
            self._w_flat.append(wf)
            self._g_flat.append(gf)
            self._states.append(
                self._opt.create_state_multi_precision(gi, wf))
            p0 = self._params_by_name[names[0]]
            if p0.lr_mult != 1.0:
                self._opt.lr_mult.setdefault(gi, p0.lr_mult)
            if p0.wd_mult != 1.0:
                self._opt.wd_mult.setdefault(gi, p0.wd_mult)
        self._ready = True

    def _make_bucket(self, tensors):
        """One flat buffer for the weights and one for the gradients; each
        parameter's storage and ``.grad`` become views into them."""
        total = sum(t.numel() for t in tensors)
        dtype = tensors[0].dtype
        wf = torch.empty(total, dtype=dtype, device=self._device)
        gf = torch.zeros(total, dtype=dtype, device=self._device)
        off = 0
        with torch.no_grad():
            for t in tensors:
                n = t.numel()
                view = wf[off:off + n].view(t.shape)
                view.copy_(t)
                t.data = view
                t.grad = gf[off:off + n].view(t.shape)
                off += n
        return wf, gf

    # -- the step ------------------------------------------------------------
    def _apply_groups(self, lr, t):
        """Optimizer update of every group, in place: one fused kernel
        launch per bucket (SGD / Adam), else the unfused rule."""
        opt = self._opt
        for gi in range(len(self._groups)):
            wf, gf, state = self._w_flat[gi], self._g_flat[gi], \
                self._states[gi]
            if self._fused_on and wf.dtype == torch.float32:
                _fused.fused_optimizer_update(opt, gi, wf, gf, state, lr, t)
                continue
            nw, ns = functional_optimizer_update(opt, gi, wf, gf, state,
                                                 lr, t)
            with torch.no_grad():
                wf.copy_(nw)
                if isinstance(state, tuple):
                    for s, n in zip(state, ns):
                        s.copy_(n)
                elif state is not None:
                    state.copy_(ns)

    def step(self, data, label):
        """Run one training step; returns the 0-dim loss tensor (on the
        device, not synchronized)."""
        x = _as_tensor(data, self._device)
        y = _as_tensor(label, self._device)
        if not self._ready:
            self._setup(x)
        self._step_count += 1
        self._opt.num_update = self._step_count
        lr = (self._opt.lr_scheduler(self._step_count)
              if self._opt.lr_scheduler else self._opt.lr)
        for gf in self._g_flat:
            gf.zero_()
        block = self._block
        was = block.training
        block.train(True)
        try:
            out = block(x)
            l = self._loss(out, y)
            loss = l.mean() if hasattr(l, "mean") else l
            loss.backward()
        finally:
            block.train(was)
        self._apply_groups(lr, self._step_count)
        return loss.detach()

    def flush(self):
        """Block until every step dispatched to the device has run."""
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def set_learning_rate(self, lr):
        self._opt.set_learning_rate(lr)
