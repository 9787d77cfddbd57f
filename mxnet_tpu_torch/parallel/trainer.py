"""DataParallelTrainer: the port of the single-device replicated tier and
the mesh tier of ``mxnet_tpu/parallel/trainer.py``.

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

**The mesh tier** (``mesh_plan=``, ``sequence_parallel=``, or a block
with ``mesh_program``, as ``trainer.py:119-151``): a mesh-program block
(``transformer.TransformerLM``) trains through the step of
``transformer/step.py`` on ``(B, seq_len)`` token batches.  The plan's
``sequence`` ranks run as a leading rank dimension on the one device
(``parallel/mesh.py``), so ring attention and its flash kernels run on
every hop with the reference's chunk shapes.  Parameters are
``init_params()`` of the program, on the device; each has its own
optimizer state from ``create_state`` and is updated by
``functional_optimizer_update`` (``trainer.py:764-778``).

**Mixed precision** (``dtype="bf16"``, ``trainer.py:1211-1369``): on the
replicated tier the flat f32 bucket buffers are the master weights.  The
block runs inside ``gluon.block.compute_dtype(bfloat16)`` on the batch
cast to bfloat16, so the forward reads bf16 casts of the f32 parameters
and the gradients come back f32 through the casts into the flat gradient
buckets.  The backward runs on ``loss.float() * scale``; ``all_finite``
over the gradient buckets gives ``ok``, and each bucket's update unscales
by ``inv_scale = 1 / scale`` and select-skips on ``ok`` (both 0-dim
tensors on the device: one fused kernel pass, ``[lr, inv_scale, ok]``).
Then ``precision.loss_scale_update`` ticks the scale, and the skipped
count stays on the device too; nothing in the step reads a value back to
the host.  The step returns the unscaled f32 loss.  The mesh tier passes
``compute_dtype`` to ``transformer/step.py`` with no loss scaling, as the
reference does.

**Run-ahead** (``trainer.py:287-295``, ``:1839-1889``): after each step,
on both tiers, a ``torch.cuda.Event`` recorded on the stream that ran it
joins ``self._inflight`` (on the CPU, where the step has run when it
returns, the loss tensor stands in).  When the ring holds more than
``engine.bulk_size()`` steps, the host waits on the oldest and books the
wait in ``dispatch_stats`` (``profiler.PipelineStats``).  ``flush()``
drains the ring and, under bf16, publishes the loss scale and newly
skipped steps (``precision.record_loss_scale``); ``engine.flush()`` and
the exit of ``engine.bulk`` call it.  Dispatch order never changes, so
every window size gives bitwise-equal losses and parameters.

The data-mesh, kvstore, ZeRO, model-axis, pipeline, gradient
accumulation and input-transform tiers of the reference raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from .. import engine as _engine
from .. import precision as _precision
from ..base import MXNetError, resolve_device
from ..ops import fused_optimizer as _fused
from .functional import functional_optimizer_update
from .mesh import MeshPlan

__all__ = ["DataParallelTrainer"]


def _unported(arg, item):
    raise NotImplementedError(
        "DataParallelTrainer(%s=...) is not ported yet: ROADMAP.md queue A, "
        "item %s; the port trains on one device" % (arg, item))


def _as_tensor(v, device):
    """A batch (tensor, NDArray or numpy) on ``device``: a tensor already
    there (a prefetched batch) is used as it is."""
    v = getattr(v, "_data", v)
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return t.to(device, non_blocking=True)


def _state_leaves(state):
    """An optimizer state's tensors: none, one, or a tuple's."""
    if state is None:
        return ()
    if isinstance(state, (tuple, list)):
        return tuple(state)
    return (state,)


class DataParallelTrainer:
    """Train a Gluon block on one device.

    Parameters
    ----------
    block : gluon.Block, initialized on ``device`` (deferred shapes are
        resolved at the first step), or a mesh-program block
        (``transformer.TransformerLM``) for the mesh tier.
    loss : gluon.loss.Loss or callable(pred, label) -> per-sample loss.
    optimizer : str or Optimizer; ``optimizer_params`` go to ``create``.
    mesh_plan / sequence_parallel : the mesh tier (module docstring);
        ``model_parallel > 1`` raises (item 7).
    dtype : ``None`` / ``"float32"``, or ``"bf16"`` for bfloat16 compute
        over f32 masters (module docstring).
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
                ("grad_accum", None if grad_accum in (None, 1)
                 else grad_accum, "6 (distributed data parallel)"),
                ("input_transform", input_transform, "3 (data pipeline)")):
            if val is not None:
                _unported(arg, item)
        self._dtype = _precision.resolve_dtype(dtype)
        self._reduced = _precision.is_reduced(self._dtype)
        # the mesh tier (trainer.py:125-138): a plan routes a
        # mesh-program block through transformer/step.py
        plan = MeshPlan.coerce(mesh_plan)
        if plan is None and (model_parallel or sequence_parallel):
            plan = MeshPlan(model=model_parallel or 1,
                            sequence=sequence_parallel or 1)
        if plan is None and hasattr(block, "mesh_program"):
            plan = MeshPlan()
        if plan is not None and not hasattr(block, "mesh_program"):
            raise ValueError(
                "mesh_plan/model_parallel/sequence_parallel train a "
                "mesh-program block (mxnet_tpu_torch.transformer."
                "TransformerLM); %r does not implement mesh_program()"
                % type(block).__name__)
        self._plan = None if plan is None else plan.on_one_device()
        self._device = resolve_device(device)
        self._block = block
        self._loss = loss
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        self._opt = optimizer
        self._ready = False
        self._step_count = 0
        # run-ahead dispatch (module docstring): every dispatched step's
        # event rides this ring, bounded by engine.bulk_size()
        self._inflight = collections.deque()
        from .. import profiler as _prof
        self.dispatch_stats = _prof.PipelineStats(name="engine.dispatch")
        _engine.register_flusher(self.flush)

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
            key = (float(p.lr_mult), float(p.wd_mult), str(p.data().dtype))
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
        if self._reduced:
            self._init_loss_scale_state()
        self._ready = True

    def _init_loss_scale_state(self):
        """The device-resident loss-scale machine: scale, consecutive
        finite steps, skipped steps in all."""
        self._ls_scale, self._ls_good = _precision.init_loss_scale(
            self._device)
        self._ls_skipped = torch.zeros((), dtype=torch.int32,
                                       device=self._device)
        self._ls_reported_skipped = 0

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
    def _apply_groups(self, lr, t, inv_scale=None, ok=None):
        """Optimizer update of every group, in place: one fused kernel
        launch per bucket (SGD / Adam), else the unfused rule.  Mixed
        precision passes the loss-scale reciprocal and the finite flag
        (0-dim f32 tensors): the kernel unscales and select-skips in the
        same pass; the unfused rule runs on ``g * inv_scale`` and keeps
        the old values where ``ok`` is 0."""
        opt = self._opt
        scaled = inv_scale is not None
        for gi in range(len(self._groups)):
            wf, gf, state = self._w_flat[gi], self._g_flat[gi], \
                self._states[gi]
            if self._fused_on and wf.dtype == torch.float32:
                kw = {"inv_scale": inv_scale, "ok": ok} if scaled else {}
                _fused.fused_optimizer_update(opt, gi, wf, gf, state, lr, t,
                                              **kw)
                continue
            nw, ns = functional_optimizer_update(
                opt, gi, wf, gf * inv_scale if scaled else gf, state, lr, t)
            if scaled:
                okb = ok > 0.0
                nw = torch.where(okb, nw, wf)
                if isinstance(state, tuple):
                    ns = tuple(torch.where(okb, n, o)
                               for n, o in zip(ns, state))
                elif state is not None:
                    ns = torch.where(okb, ns, state)
            with torch.no_grad():
                wf.copy_(nw)
                if isinstance(state, tuple):
                    for s, n in zip(state, ns):
                        s.copy_(n)
                elif state is not None:
                    state.copy_(ns)

    def step(self, data, label):
        """Run one training step; returns the 0-dim f32 loss tensor (on
        the device, not synchronized).  The host blocks only when the
        run-ahead window (``engine.set_bulk_size``) is full, and then on
        the oldest in-flight step."""
        x = _as_tensor(data, self._device)
        y = _as_tensor(label, self._device)
        if self._plan is not None:
            loss = self._step_mesh_tier(x, y)
        else:
            loss = self._step_replicated(x, y)
        self._track_inflight(loss)
        return loss

    def _step_replicated(self, x, y):
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
            if self._reduced:
                return self._reduced_step(block, x, y, lr)
            out = block(x)
            l = self._loss(out, y)
            loss = l.mean() if hasattr(l, "mean") else l
            loss.backward()
        finally:
            block.train(was)
        self._apply_groups(lr, self._step_count)
        return loss.detach()

    def _reduced_step(self, block, x, y, lr):
        """The mixed-precision replicated step (module docstring): bf16
        forward over the f32 masters, scaled backward, unscaled and
        select-skipped update, one tick of the loss-scale machine."""
        from ..gluon.block import compute_dtype
        if x.is_floating_point():
            x = x.to(self._dtype)
        with compute_dtype(self._dtype):
            out = block(x)
            l = self._loss(out, y)
            loss = l.mean() if hasattr(l, "mean") else l
        raw = loss.float()
        scale = self._ls_scale
        (raw * scale).backward()
        fin = _precision.all_finite(self._g_flat)
        self._apply_groups(lr, self._step_count, inv_scale=1.0 / scale,
                           ok=fin.float())
        self._ls_scale, self._ls_good = _precision.loss_scale_update(
            scale, self._ls_good, fin)
        self._ls_skipped = self._ls_skipped + (1 - fin.int())
        return raw.detach()

    # -- run-ahead ------------------------------------------------------------
    @staticmethod
    def _wait(marker):
        if isinstance(marker, torch.cuda.Event):
            marker.synchronize()

    def _track_inflight(self, loss):
        """Ring the dispatched step and apply backpressure: wait on the
        OLDEST in-flight step while the ring holds more than
        ``engine.bulk_size()``."""
        if self._device.type == "cuda":
            marker = torch.cuda.Event()
            marker.record(torch.cuda.current_stream(self._device))
        else:
            marker = loss
        self._inflight.append(marker)
        limit = _engine.bulk_size()
        while len(self._inflight) > limit:
            t0 = time.perf_counter()
            self._wait(self._inflight.popleft())
            self.dispatch_stats.on_backpressure(time.perf_counter() - t0)
        self.dispatch_stats.on_dispatch(len(self._inflight))

    # -- the mesh tier --------------------------------------------------------
    @property
    def mesh_plan(self):
        return self._plan

    def _setup_mesh(self):
        """The program, its parameters on the device and per-parameter
        optimizer state (``trainer.py:780-866``, without ZeRO)."""
        from ..transformer import step as _tstep
        program = self._block.mesh_program(self._plan)
        self._mesh_program = program
        params = program.init_params()
        self._mesh_param_names = list(program.param_names)
        self._mesh_params = {
            name: torch.tensor(params[name], device=self._device,
                               requires_grad=True)
            for name in self._mesh_param_names}
        templates, leaf_counts, leaves = [], [], []
        for i, name in enumerate(self._mesh_param_names):
            state = self._opt.create_state_multi_precision(
                i, self._mesh_params[name].detach())
            templates.append(state)
            leaf_counts.append(len(_state_leaves(state)))
            leaves.extend(_state_leaves(state))
        self._mesh_state_leaves = tuple(leaves)
        opt = self._opt

        def apply_update(i, w, g, state_leaves, lr, t):
            state = templates[i]
            if isinstance(state, (tuple, list)):
                state = tuple(state_leaves)
            elif state is not None:
                state = state_leaves[0]
            nw, ns = functional_optimizer_update(opt, i, w, g, state, lr, t)
            return nw, _state_leaves(ns)

        self._mesh_grad_fn, self._mesh_update_fn = _tstep.build_parts(
            program, apply_update, leaf_counts,
            compute_dtype=self._dtype if self._reduced else None)
        self._ready = True

    def _step_mesh_tier(self, x, y):
        """One mesh-tier step: the (B, T) batch cut into the ``(K, B,
        T/K)`` rank chunks, the grads part, then the update written back
        into the parameters and states in place."""
        if not self._ready:
            self._setup_mesh()
        seq_len = self._mesh_program.cfg.seq_len
        if x.dim() != 2 or x.shape[1] != seq_len or y.shape != x.shape \
                or x.dtype.is_floating_point or y.dtype.is_floating_point:
            raise ValueError(
                "mesh-tier batches are (batch, tokens) int32 with "
                "tokens == cfg.seq_len (%d); got shape %r (labels %r, %s)"
                % (seq_len, tuple(x.shape), tuple(y.shape), x.dtype))
        k_ranks = self._plan.size("sequence")

        def chunks(t):
            return t.long().reshape(t.shape[0], k_ranks,
                                    seq_len // k_ranks).transpose(0, 1)

        self._step_count += 1
        self._opt.num_update = self._step_count
        lr = (self._opt.lr_scheduler(self._step_count)
              if self._opt.lr_scheduler else self._opt.lr)
        vals = tuple(self._mesh_params[n] for n in self._mesh_param_names)
        grads, loss = self._mesh_grad_fn(vals, chunks(x), chunks(y))
        new_vals, new_leaves = self._mesh_update_fn(
            vals, self._mesh_state_leaves, grads, lr, self._step_count)
        with torch.no_grad():
            for w, nw in zip(vals, new_vals):
                w.copy_(nw)
            for leaf, nl in zip(self._mesh_state_leaves, new_leaves):
                leaf.copy_(nl)
        return loss

    def mesh_params(self):
        """The trained parameters, name -> float32 ndarray in
        ``MeshProgram.param_names`` order — the layout ``init_params``
        produces and ``DecodeRunner`` consumes (``trainer.py:1129``)."""
        if getattr(self, "_mesh_params", None) is None:
            raise RuntimeError(
                "mesh_params() needs the mesh tier set up (train at "
                "least one step with mesh_plan=...)")
        return {name: self._mesh_params[name].detach().cpu().numpy().copy()
                for name in self._mesh_param_names}

    def flush(self):
        """Drain the in-flight ring: block until every dispatched step has
        run.  Under bf16 on the replicated tier, then publish the loss
        scale and any newly skipped steps (the one place they are read
        back)."""
        t0 = time.perf_counter()
        while self._inflight:
            self._wait(self._inflight.popleft())
        waited = time.perf_counter() - t0
        if waited > 0:
            self.dispatch_stats.on_backpressure(waited)
        if self._reduced and self._ready and self._plan is None:
            skipped = int(self._ls_skipped)
            _precision.record_loss_scale(
                float(self._ls_scale), skipped - self._ls_reported_skipped)
            self._ls_reported_skipped = skipped

    def loss_scale_state(self):
        """``(scale, good_steps, skipped_steps)`` of the bf16 replicated
        tier as host numbers (reads the device: call after ``flush``)."""
        if not (self._reduced and self._ready and self._plan is None):
            raise RuntimeError("no loss-scale state: dtype='bf16' on the "
                               "replicated tier, after one step")
        return (float(self._ls_scale), int(self._ls_good),
                int(self._ls_skipped))

    def set_learning_rate(self, lr):
        self._opt.set_learning_rate(lr)
