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
(``trainer.py:1265-1280``); the numbers are the same.  Another
elementwise optimizer keeps one group per parameter and the unfused
route (``parallel.functional.functional_optimizer_update``), in the
parameters' order, so Nadam's schedule and SGLD's draws (from the seeded
generator of the device, ``_rng``) follow the Gluon route's order.
LBSGD and DCASGD, which read a whole parameter, raise ``ValueError``.

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

**The input transform** (``input_transform=``, ``trainer.py:314-317,
407-412``): a callable on the batch tensor, typically
``io.make_device_tail`` (normalize, cast, layout), applied on the device
first in every step, so the first step's deferred-init probe sees its
output too; the mesh tier refuses it, as the reference does.

**Data parallelism** (``mesh=``, ``trainer.py:101-297``): a port
``Mesh`` over a ``data`` axis of K ranks (``parallel/mesh.py``), either
K in-process ranks that run in turn on one device, or one rank per
process over ``torch.distributed``; their collectives are
``parallel/comm.py``'s.

- The **replicated tier** (``zero=0``).  Under GSPMD the reference's
  BatchNorm statistics, loss and gradient are global
  (``trainer.py:1383-1390``), so with in-process ranks one forward over
  the whole batch is its exact counterpart.  With one rank per process,
  each process runs its own rows and the gradient buckets, the loss and
  the mutated state (BatchNorm's running statistics) are averaged over
  the ranks.
- The **ZeRO-1 tier** (``zero=1``, ``parallel/zero.py``; reference
  ``:509-625``): the trainable parameters are views of one flat buffer
  in the reference's layout; each rank runs forward and backward on its
  own B/K rows into its own flat gradient row (so BatchNorm uses
  per-rank batch statistics, each rank starting from the same running
  statistics, whose new values are the mean over ranks of each rank's
  update), the rows are reduce-scattered, and each rank updates its
  ``(shard,)`` slice with its own ``(shard,)`` optimizer state (one B1 /
  B3 launch per rank on a card), then the slices are all-gathered.
  Under bf16 the live parameters are bf16 and the f32 masters exist only
  as each rank's shard.
- ``grad_accum=N`` (both tiers): the (per-rank) batch splits into N
  microbatches whose gradients fold left to right
  (``parallel.functional.accumulate_grads``) before the one update; the
  loss and the mutated state are averaged over them.
- ``param_spec_fn`` changes no number with in-process ranks, as GSPMD
  placement changes none in the reference; with a process group a spec
  that is not replicated raises (parameters sharded across processes
  are ROADMAP.md queue A, item A7(b)).
- ``kvstore="dist_sync"`` (or a ``dist_sync`` store; ``trainer.py:
  169-210,430-490,2484-2517``): each process runs the replicated step on
  its own batch into flat gradient buckets that are views of ONE flat
  f32 vector, with the loss in its last slot; the vector is pushed to
  and pulled from the store under one flat key (``dpt<N>::flat``, the
  sum over the processes), scaled by ``1 / num_workers``, and the
  update launches B1-B3 once per bucket on each process's device.
  Trainable parameters stay equal on every process; BatchNorm's running
  statistics stay each process's own, as the reference's.  A signature
  round at setup catches trainers built in a different order on some
  rank (``_validate_flat_key``).  As in the reference, a store with an
  updater or compression, a ``dist_async`` store, a mesh spanning
  processes, ``zero=1``, ``grad_accum`` and bf16 are refused with it.

**Checkpoints** (``resilience/checkpoint.py``, reference
``:1984-2327``): ``save_checkpoint`` writes the monolithic ``.mxckpt``
(or, at ``zero=1``, one shard file per rank and the manifest);
``restore_checkpoint`` restores either, at any K for a sharded one, into
a fresh trainer; the files are the reference's format, so each package
restores the other's (the RNG state belongs to each package's own
generator and is not crossed).  ``fit`` (``:2328-2453``) drives the
prefetch, the run-ahead window, lazy metrics and the checkpoints.

**The mesh tier** (``mesh_plan=``, ``model_parallel=``,
``sequence_parallel=``; ``trainer.py:780-1180``): a mesh-program block
(``transformer.TransformerLM``) trains through
``transformer/step.py`` over ``MeshPlan(data=D, model=Km,
sequence=Ks)`` on one device — the model and sequence ranks as leading
dimensions of the activations, the data ranks in turn.  The parameters
are global tensors (each rank's shard a view), the optimizer state is
per parameter, or under ``zero=1`` one ``(Km * shard,)`` slice per data
rank of the reference's ``("model", "data")`` flat layout (B1 / B3
once per data rank a step).  The pipeline tier raises
``NotImplementedError`` naming the ROADMAP.md item that ports it.
"""
from __future__ import annotations

import collections
import os
import time

import numpy as np
import torch

from .. import engine as _engine
from .. import precision as _precision
from ..base import MXNetError, as_torch_device, resolve_device
from ..ndarray import NDArray
from ..ops import fused_optimizer as _fused
from ..resilience import chaos as _chaos
from .functional import accumulate_grads, functional_optimizer_update
from .mesh import MeshPlan, NamedSharding, PartitionSpec, make_mesh

__all__ = ["DataParallelTrainer", "DEFAULT_CHECKPOINT_EVERY"]

# auto-checkpoint cadence of ``fit(checkpoint_dir=...)`` without an
# explicit ``checkpoint_every`` (trainer.py:39-42)
DEFAULT_CHECKPOINT_EVERY = 50

# optimizers whose rule is per scalar (no norm or delta over a whole
# parameter), as the reference's set (trainer.py:50-53); LBSGD and DCASGD
# are not, and the reference's trainer fails on both (LBSGD reads its
# traced learning rate as a float, DCASGD donates its previous weight
# twice), so the port refuses them up front
_ELEMENTWISE_OPTIMIZERS = {
    "SGD", "NAG", "Signum", "FTML", "SGLD", "Adam", "AdaGrad", "RMSProp",
    "AdaDelta", "Ftrl", "Adamax", "Nadam",
}
_PER_PARAMETER_OPTIMIZERS = {"LBSGD", "DCASGD"}


def _np_dtype_name(t):
    """The numpy name of a tensor's dtype (``"bfloat16"`` for bf16)."""
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=t.dtype).numpy().dtype)


def _desc_of(v):
    v = getattr(v, "_data", v)
    if isinstance(v, torch.Tensor):
        return (tuple(int(d) for d in v.shape), _np_dtype_name(v))
    a = np.asarray(v)
    return (tuple(int(d) for d in a.shape), str(a.dtype))


def _rng_payload():
    """The port's RNG state as a checkpoint records it: the reference's
    keys (``numpy_state``, ``counter``) beside the port's generators."""
    from .. import _rng
    from ..resilience import checkpoint as _ckpt
    st = _rng.get_state()
    return {"package": "mxnet_tpu_torch", "numpy_state": st["numpy_state"],
            "counter": 0, "seed": st["seed"],
            "generators": {d: _ckpt.encode_array(g)
                           for d, g in st["generators"].items()}}


def _restore_rng(state):
    """Restore :func:`_rng_payload`'s state; a reference snapshot's key
    provider is not the port's generator and is left alone."""
    from .. import _rng
    from ..resilience import checkpoint as _ckpt
    if not isinstance(state, dict) or \
            state.get("package") != "mxnet_tpu_torch":
        return
    _rng.set_state({"numpy_state": state["numpy_state"],
                    "seed": state["seed"],
                    "generators": {d: _ckpt.decode_tensor(e)
                                   for d, e in state["generators"].items()}})


def _state_leaves(state):
    """An optimizer state's tensors: none, one, or a tuple's."""
    if state is None:
        return ()
    if isinstance(state, (tuple, list)):
        return tuple(state)
    return (state,)


class DataParallelTrainer:
    """Train a Gluon block data-parallel over a mesh's ``data`` axis.

    Parameters
    ----------
    block : gluon.Block, initialized on ``device`` (deferred shapes are
        resolved at the first step), or a mesh-program block
        (``transformer.TransformerLM``) for the mesh tier.
    loss : gluon.loss.Loss or callable(pred, label) -> per-sample loss.
    optimizer : str or Optimizer; ``optimizer_params`` go to ``create``.
    mesh : ``parallel.Mesh`` (``make_mesh``, ``data_parallel_mesh``);
        default one rank on ``device``.  ``data_axis`` names the batch's
        axis; ``param_spec_fn(name, shape) -> PartitionSpec`` places
        parameters (module docstring).
    zero : 0 (replicated optimizer state) or 1 (ZeRO-1 over ``data``).
    grad_accum : microbatches folded into each step's one update.
    run_id : the training run's identity in every checkpoint's
        provenance (default ``$MXTPU_RUN_ID``).
    mesh_plan / sequence_parallel : the mesh tier (module docstring);
        ``model_parallel`` the model axis (Megatron layers).
    dtype : ``None`` / ``"float32"``, or ``"bf16"`` for bfloat16 compute
        over f32 masters (module docstring).
    input_transform : callable(tensor) -> tensor applied to each batch on
        the device before the block sees it (module docstring).
    device : where the step runs; ``None`` means CUDA (raising without a
        card), ``"cpu"`` the host.
    """

    def __init__(self, block, loss, optimizer, optimizer_params=None,
                 mesh=None, param_spec_fn=None, data_axis="data",
                 kvstore=None, input_transform=None, run_id=None, zero=0,
                 mesh_plan=None, model_parallel=None, sequence_parallel=None,
                 dtype=None, grad_accum=1, device=None):
        from .. import optimizer as opt_mod
        self._input_transform = input_transform
        self._dtype = _precision.resolve_dtype(dtype)
        self._reduced = _precision.is_reduced(self._dtype)
        # the mesh tier (trainer.py:125-157): a plan routes a
        # mesh-program block through transformer/step.py
        plan = MeshPlan.coerce(mesh_plan)
        if plan is None and (model_parallel or sequence_parallel):
            plan = MeshPlan(model=model_parallel or 1,
                            sequence=sequence_parallel or 1)
        if plan is None and hasattr(block, "mesh_program"):
            plan = MeshPlan()
        if plan is not None:
            if not hasattr(block, "mesh_program"):
                raise ValueError(
                    "mesh_plan/model_parallel/sequence_parallel train a "
                    "mesh-program block (mxnet_tpu_torch.transformer."
                    "TransformerLM); %r does not implement mesh_program()"
                    % type(block).__name__)
            if mesh is not None:
                raise ValueError("pass either mesh= or mesh_plan=, not "
                                 "both: the plan builds its own mesh")
            if kvstore is not None:
                raise ValueError("the multi-axis mesh tier is "
                                 "single-process (in-process mesh "
                                 "collectives only); kvstore is not "
                                 "supported")
            if param_spec_fn is not None or input_transform is not None:
                raise ValueError(
                    "param_spec_fn/input_transform do not apply to the "
                    "mesh tier: the mesh program owns its own sharding "
                    "and feed")
        self._kv = self._check_kvstore(kvstore, mesh, zero, grad_accum)
        self.run_id = run_id if run_id is not None else \
            os.environ.get("MXTPU_RUN_ID")
        self._plan = None if plan is None else plan.on_one_device()
        if mesh is not None and device is None:
            device = mesh.local_device
        self._device = resolve_device(device)
        if mesh is not None and self._device != torch.device(
                as_torch_device(mesh.local_device)):
            raise ValueError("mesh ranks live on %s but device=%s"
                             % (mesh.local_device, self._device))
        self._block = block
        self._loss = loss
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        if type(optimizer).__name__ in _PER_PARAMETER_OPTIMIZERS:
            raise ValueError(
                "DataParallelTrainer needs a purely elementwise optimizer "
                "(%s); got %s, whose update reads a whole parameter: train "
                "it with gluon.Trainer"
                % (", ".join(sorted(_ELEMENTWISE_OPTIMIZERS)),
                   type(optimizer).__name__))
        self._opt = optimizer
        # ZeRO-1 (trainer.py:222-243)
        self._zero = int(zero or 0)
        if self._zero not in (0, 1):
            raise ValueError("zero must be 0 (replicated optimizer "
                             "state) or 1 (ZeRO-1 sharded), got %r"
                             % (zero,))
        if self._zero and type(optimizer).__name__ not in \
                _ELEMENTWISE_OPTIMIZERS:
            raise ValueError(
                "zero=1 updates a flat concatenated parameter shard "
                "and therefore needs a purely elementwise optimizer "
                "(%s); got %s"
                % (", ".join(sorted(_ELEMENTWISE_OPTIMIZERS)),
                   type(optimizer).__name__))
        # gradient accumulation (trainer.py:244-271)
        self._grad_accum = 1 if grad_accum is None else int(grad_accum)
        if self._grad_accum < 1:
            raise ValueError("grad_accum must be >= 1, got %r"
                             % (grad_accum,))
        if self._grad_accum > 1:
            if self._plan is not None:
                raise ValueError(
                    "grad_accum does not apply to the mesh tier: a "
                    "pipelined plan microbatches through the 1F1B "
                    "schedule")
            if self._reduced:
                raise ValueError(
                    "grad_accum with dtype='bf16' is not supported: "
                    "the loss-scale finite check is defined over one "
                    "backward pass (accumulate in f32)")
        self._data_axis = data_axis
        self._param_spec_fn = param_spec_fn or (
            lambda name, shape: PartitionSpec())
        if self._plan is not None:
            self._mesh = None   # built by _setup_mesh from the plan
            self._comm = None
        else:
            self._mesh = mesh if mesh is not None else make_mesh(
                (1,), (data_axis,), [self._device])
            if data_axis not in self._mesh.axis_names:
                raise ValueError("data_axis %r is not an axis of %r"
                                 % (data_axis, self._mesh))
            self._comm = self._mesh.comm(data_axis)
        self._ready = False
        self._step_count = 0
        self._setup_desc = None
        # batches step() took as they were (already on the device: the
        # prefetcher's transfer reused), and batches it moved there
        self.put_stats = {"reused": 0, "moved": 0}
        # run-ahead dispatch (module docstring): every dispatched step's
        # event rides this ring, bounded by engine.bulk_size()
        self._inflight = collections.deque()
        from .. import profiler as _prof
        self.dispatch_stats = _prof.PipelineStats(name="engine.dispatch")
        _engine.register_flusher(self.flush)

    # distinct flat-gradient key per trainer instance (the same
    # construction order on every rank, which the collectives require)
    _KV_UID = 0

    def _check_kvstore(self, kvstore, mesh, zero, grad_accum):
        """The multi-process store of the split step, or None (one
        process), with the reference's refusals (``trainer.py:175-270``)."""
        if kvstore is None:
            return None
        from .. import kvstore as kvs
        if isinstance(kvstore, str):
            kvstore = kvs.create(kvstore)
        if kvstore.num_workers <= 1:
            return None
        if self._reduced:
            raise ValueError(
                "dtype='bf16' is not supported with a multi-process "
                "kvstore: the flat-key push/pull path reduces gradients "
                "in f32 without the loss-scale/finite bookkeeping (train "
                "bf16 in-process, or f32 with the kvstore)")
        if kvstore.type not in kvs._SYNC_TYPES:
            raise ValueError(
                "DataParallelTrainer needs a synchronous kvstore "
                "(dist_sync/dist_device_sync/tpu_dist), got %r"
                % kvstore.type)
        if kvstore.has_updater:
            raise ValueError(
                "kvstore has an updater/optimizer set; the trainer "
                "applies its own optimizer — use a plain dist_sync "
                "store for gradient aggregation")
        if kvstore.compression is not None:
            raise ValueError(
                "kvstore gradient compression would quantize the "
                "trainer's fused flat gradient (and the loss scalar "
                "riding on it) — use an uncompressed store here")
        if mesh is not None and mesh.process_group:
            raise ValueError(
                "with kvstore set the mesh must span only this process's "
                "ranks (cross-process reduction rides the kvstore, not "
                "the mesh)")
        if int(zero or 0):
            raise ValueError(
                "zero=1 shards optimizer state over the mesh data axis; "
                "combining it with a multi-process kvstore is not "
                "supported (the kvstore path keeps the full flat "
                "gradient per rank)")
        if grad_accum is not None and int(grad_accum) > 1:
            raise ValueError(
                "grad_accum with a multi-process kvstore is not "
                "supported: the split-step protocol pushes one flat "
                "gradient per step")
        DataParallelTrainer._KV_UID += 1
        self._kv_prefix = "dpt%d::" % DataParallelTrainer._KV_UID
        return kvstore

    def _setup_flat_key(self):
        """Re-point every bucket's gradient (and each parameter's
        ``.grad``) into one flat f32 vector with a slot for the loss,
        init the flat key and check it (``trainer.py:430-453``)."""
        sizes = [gf.numel() for gf in self._g_flat]
        total = sum(sizes) + 1      # +1: the loss rides along
        flat = torch.zeros(total, dtype=torch.float32, device=self._device)
        off = 0
        for gi, names in enumerate(self._groups):
            gf = flat[off:off + sizes[gi]]
            o = 0
            for n in names:
                t = self._params_by_name[n].tensor()
                t.grad = gf[o:o + t.numel()].view(t.shape)
                o += t.numel()
            self._g_flat[gi] = gf
            off += sizes[gi]
        self._kv_flat = flat
        self._flat_nd = NDArray(flat, fixed=True)
        self._flat_sizes = sizes
        self._flat_key = self._kv_prefix + "flat"
        self._kv.init(self._flat_key, NDArray(torch.zeros_like(flat)))
        self._validate_flat_key(total)

    def _validate_flat_key(self, total):
        """Catch trainers built in a different order on some rank before
        any gradient mixes (``trainer.py:455-490``): every rank pushes a
        layout signature in slot 0 and the pulled sum must be
        ``num_workers * sig`` (sig < 2^16 keeps the sum exact in f32)."""
        import zlib
        sig = float(zlib.crc32(repr(
            (self._flat_key, tuple(self._flat_sizes))).encode())
            % (1 << 16) + 1)
        probe = torch.zeros(total, dtype=torch.float32, device=self._device)
        probe[0] = sig
        out = NDArray(torch.zeros_like(probe), fixed=True)
        self._kv.push(self._flat_key, NDArray(probe))
        self._kv.pull(self._flat_key, out=out)
        got = float(out._data[0])
        want = sig * self._kv.num_workers
        if abs(got - want) > 0.5:
            raise RuntimeError(
                "DataParallelTrainer flat-key desync: rank %d pushed "
                "signature %.0f for key %r sizes %r but the cross-worker "
                "sum was %.0f (expected %.0f) — trainers were constructed "
                "in a different order on some rank, which would silently "
                "sum gradients from different models"
                % (self._kv.rank, sig, self._flat_key,
                   tuple(self._flat_sizes), got, want))

    def _dist_exchange(self, loss):
        """The split step's exchange (``trainer.py:2484-2517``): the local
        gradients and loss in the flat vector are pushed, their sum over
        the processes pulled back in place and scaled to the mean;
        returns the global-batch mean loss."""
        with torch.no_grad():
            self._kv_flat[-1] = loss
        self._kv.push(self._flat_key, self._flat_nd)
        self._kv.pull(self._flat_key, out=self._flat_nd)
        with torch.no_grad():
            self._kv_flat.mul_(1.0 / self._kv.num_workers)
        return self._kv_flat[-1].clone()

    # -- setup -------------------------------------------------------------
    def _setup(self, data):
        block, dev = self._block, self._device
        if any(p._deferred_init for p in block.collect_params().values()):
            # one inference-mode forward on one sample resolves the
            # deferred shapes (the reference's autograd.pause() pass)
            was = block.training
            block.train(False)
            x0 = data[:1]
            try:
                with torch.no_grad():
                    if self._reduced:
                        # as the step runs it: a bf16 batch (an input
                        # transform's output) meets bf16 casts of the
                        # parameters
                        from ..gluon.block import compute_dtype
                        if x0.is_floating_point():
                            x0 = x0.to(self._dtype)
                        with compute_dtype(self._dtype):
                            block(x0)
                    else:
                        block(x0)
            finally:
                block.train(was)
        params = block.collect_params()
        self._params_by_name = dict(params.items())
        self._train_names = [n for n, p in params.items()
                             if p.grad_req != "null"]
        self._aux_names = [n for n, p in params.items()
                           if p.grad_req == "null"]
        for n, p in params.items():
            if p.tensor().device != dev:
                raise MXNetError(
                    "parameter %s lives on %s but the trainer runs on %s: "
                    "initialize the block with ctx=%s"
                    % (n, p.tensor().device, dev, dev))

        specs = {n: PartitionSpec(*self._param_spec_fn(n, tuple(p.shape)))
                 for n, p in params.items()}
        if self._mesh.process_group and any(specs.values()):
            raise NotImplementedError(
                "param_spec_fn placed %s off the replicated layout: one "
                "rank per process holds every parameter whole; sharded "
                "parameters across processes are ROADMAP.md queue A, item "
                "A7(b)" % sorted(n for n, sp in specs.items() if sp))
        self._fused_on = _fused.supports(self._opt) is not None
        self._aux_tensors = [params[n].tensor() for n in self._aux_names]
        if self._zero:
            if any(specs[n] for n in self._train_names):
                raise ValueError(
                    "zero=1 flattens the trainable parameters over the "
                    "data axis and needs them replicated; param %r has "
                    "a non-trivial PartitionSpec"
                    % ([n for n in self._train_names if specs[n]][0],))
            self._setup_zero()
            self._ready = True
            return
        buckets, singles = {}, []
        for name in self._train_names:
            p = self._params_by_name[name]
            if not self._fused_on or specs[name]:
                singles.append([name])
                continue
            key = (float(p.lr_mult), float(p.wd_mult),
                   str(p.tensor().dtype))
            buckets.setdefault(key, []).append(name)
        self._groups = list(buckets.values()) + singles

        self._w_flat, self._g_flat, self._states = [], [], []
        for gi, names in enumerate(self._groups):
            wf, gf = self._make_bucket([self._params_by_name[n].tensor()
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
        if self._kv is not None:
            self._setup_flat_key()
        self._ready = True

    def _init_loss_scale_state(self):
        """The device-resident loss-scale machine: scale, consecutive
        finite steps, skipped steps in all."""
        self._ls_scale, self._ls_good = _precision.init_loss_scale(
            self._device)
        self._ls_skipped = torch.zeros((), dtype=torch.int32,
                                       device=self._device)
        self._ls_reported_skipped = 0

    def _setup_zero(self):
        """The flat ZeRO-1 plan (``parallel/zero.py``), the flat live
        parameters (each trainable tensor a view of it), one flat
        gradient row per rank this process holds, and each rank's
        ``(shard,)`` optimizer state (and f32 master under bf16)
        (``trainer.py:509-572``)."""
        from . import zero as _zmod
        for name in self._train_names:
            p = self._params_by_name[name]
            if p.lr_mult != 1.0 or p.wd_mult != 1.0:
                raise ValueError(
                    "zero=1 applies one flat optimizer update and "
                    "cannot honor per-parameter lr_mult/wd_mult "
                    "(param %r)" % (name,))
        comm, dev = self._comm, self._device
        tensors = [self._params_by_name[n].tensor()
                   for n in self._train_names]
        live = self._dtype if self._reduced else torch.float32
        plan = _zmod.Zero1Plan(
            self._train_names, [tuple(t.shape) for t in tensors],
            [_np_dtype_name(torch.empty((), dtype=live))
             if self._reduced else _np_dtype_name(t) for t in tensors],
            self._data_axis, comm.k)
        self._zero_plan = plan
        masters = _zmod._flatten_pad(tensors, plan) if self._reduced \
            else None
        wf = torch.zeros(plan.padded, dtype=live, device=dev)
        rows = torch.zeros(len(comm.local_ranks), plan.padded, dtype=live,
                           device=dev)
        self._zero_grad_views = [[] for _ in comm.local_ranks]
        off = 0
        with torch.no_grad():
            for name, t in zip(self._train_names, tensors):
                n = t.numel()
                view = wf[off:off + n].view(t.shape)
                view.copy_(t)
                if self._reduced:
                    self._params_by_name[name].cast(live)
                t.data = view
                for i in range(len(comm.local_ranks)):
                    self._zero_grad_views[i].append(
                        rows[i, off:off + n].view(t.shape))
                off += n
        self._zero_flat, self._zero_rows = wf, rows
        self._zero_tensors = tensors
        sh = plan.shard
        owned = [slice(r * sh, (r + 1) * sh) for r in comm.local_ranks]
        if self._reduced:
            self._zero_master = [masters[s].clone() for s in owned]
            bases = self._zero_master
        else:
            self._zero_master = None
            bases = [wf[s] for s in owned]
        self._zero_w_shards = bases
        self._zero_states = []
        for base in bases:
            state = self._opt.create_state_multi_precision(0, base)
            for li, leaf in enumerate(_state_leaves(state)):
                if tuple(leaf.shape) != (sh,):
                    raise ValueError(
                        "zero=1 needs every optimizer-state leaf shaped "
                        "like the flat weight shard; leaf %d of %s has "
                        "shape %r (shard is (%d,))"
                        % (li, type(self._opt).__name__, tuple(leaf.shape),
                           sh))
            self._zero_states.append(state)
        self._zero_mut_idx = None
        self._zero_grads_part, self._zero_update_part = _zmod.build_parts(
            self._zero_rank_grads, rows, self._opt, plan, comm,
            compute_dtype=self._dtype if self._reduced else None,
            grad_accum=self._grad_accum)
        self._groups = [list(self._train_names)]
        if self._reduced:
            self._init_loss_scale_state()

    @property
    def zero(self):
        return self._zero

    def _zero_leaves(self, i=None):
        """The optimizer-state leaves of local rank ``i`` (default: each
        leaf's full ``(padded,)`` vector, the ranks' shards concatenated;
        this process must hold every rank)."""
        if i is not None:
            return _state_leaves(self._zero_states[i])
        if len(self._zero_states) != self._zero_plan.k:
            raise RuntimeError("this process holds %d of %d ranks"
                               % (len(self._zero_states),
                                  self._zero_plan.k))
        return tuple(torch.cat(ls) for ls in zip(
            *(_state_leaves(s) for s in self._zero_states)))

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

    # -- batches -------------------------------------------------------------
    @property
    def mesh(self):
        """The port ``Mesh`` the step runs over (the plan's, on the mesh
        tier, once set up)."""
        return self._mesh

    @property
    def batch_sharding(self):
        """The ``NamedSharding`` step inputs are laid out with: the batch
        over the data axis (under a plan, ``(batch, tokens)`` over
        ``data x sequence``).  A feeder that puts batches there
        (``io.PrefetchToDeviceIter(sharding=...)``) hits ``step``'s fast
        path: its transfer is reused, not redone."""
        if self._plan is not None:
            if self._mesh is None:
                self._mesh = self._plan.build_mesh(self._device)
            return NamedSharding(self._mesh, self._plan.batch_spec())
        return NamedSharding(self._mesh, PartitionSpec(self._data_axis))

    def _put_batch(self, v):
        """A batch (tensor, NDArray or numpy) on the step's device, with
        the fast path of ``trainer.py:1805-1838``: a tensor already there
        (a prefetched batch) is used as it is."""
        v = getattr(v, "_data", v)
        if isinstance(v, torch.Tensor) and v.device == self._device:
            self.put_stats["reused"] += 1
            return v
        self.put_stats["moved"] += 1
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        return t.to(self._device, non_blocking=True)

    def _rank_rows(self, t):
        """The rows of each rank this process holds: K equal blocks of an
        in-process batch, or the process's own batch."""
        comm = self._comm
        if comm.placement != "in_process" or comm.k == 1:
            return [t]
        if t.shape[0] % comm.k:
            raise ValueError("global batch %d must divide by the data axis "
                             "%d" % (t.shape[0], comm.k))
        return list(t.chunk(comm.k))

    def step(self, data, label):
        """Run one training step; returns the 0-dim f32 loss tensor (on
        the device, not synchronized).  The host blocks only when the
        run-ahead window (``engine.set_bulk_size``) is full, and then on
        the oldest in-flight step."""
        if self._setup_desc is None:
            self._setup_desc = {"data": _desc_of(data),
                                "label": _desc_of(label)}
        x = self._put_batch(data)
        y = self._put_batch(label)
        if self._input_transform is not None:
            # first in the step, before the deferred-init probe of the
            # first step too: the block only ever sees transformed batches
            # (the host ships the narrow uint8 batch)
            x = self._input_transform(x)
        if self._plan is not None:
            loss = self._step_mesh_tier(x, y)
        elif self._zero:
            loss = self._step_zero(x, y)
        else:
            loss = self._step_replicated(x, y)
        self._track_inflight(loss)
        return loss

    def _next_step(self):
        """Count the step, fire the chaos probe (before anything is
        dispatched, so a killed step never half-applies) and read the
        learning rate on the host."""
        self._step_count += 1
        _chaos.maybe_inject("trainer.step", self._step_count, ctx=self)
        self._opt.num_update = self._step_count
        return (self._opt.lr_scheduler(self._step_count)
                if self._opt.lr_scheduler else self._opt.lr)

    def _forward_loss(self, block, x, y):
        out = block(x)
        l = self._loss(out, y)
        return l.mean() if hasattr(l, "mean") else l

    def _mutated(self, versions):
        """Indices of the auxiliary tensors written since ``versions``."""
        return [j for j, (a, v) in enumerate(zip(self._aux_tensors,
                                                 versions))
                if a._version != v]

    def _step_replicated(self, x, y):
        if not self._ready:
            self._setup(x)
        lr = self._next_step()
        for gf in self._g_flat:
            gf.zero_()
        block = self._block
        was = block.training
        block.train(True)
        pg = self._comm.placement == "process_group"
        try:
            if self._reduced:
                return self._reduced_step(block, x, y, lr)
            if self._grad_accum > 1:
                loss, muts = self._accumulate(block, x, y)
            else:
                versions = [a._version for a in self._aux_tensors]
                loss = self._forward_loss(block, x, y)
                loss.backward()
                loss = loss.detach()
                idx = self._mutated(versions) if pg else []
                muts = [(j, self._aux_tensors[j]) for j in idx]
        finally:
            block.train(was)
        if pg:
            # one rank per process: the gradient, the loss and the
            # mutated state averaged over the ranks (trainer.py:1383-1390
            # has them global; a rank's batch statistics stay its own)
            with torch.no_grad():
                for gf in self._g_flat:
                    gf.copy_(self._comm.mean([gf]))
                loss = self._comm.mean([loss])
                for j, m in muts:
                    self._aux_tensors[j].copy_(self._comm.mean([m]))
        if self._kv is not None:
            loss = self._dist_exchange(loss)
        self._apply_groups(lr, self._step_count)
        return loss

    def _reduced_step(self, block, x, y, lr):
        """The mixed-precision replicated step (module docstring): bf16
        forward over the f32 masters, scaled backward, unscaled and
        select-skipped update, one tick of the loss-scale machine."""
        from ..gluon.block import compute_dtype
        if x.is_floating_point():
            x = x.to(self._dtype)
        with compute_dtype(self._dtype):
            loss = self._forward_loss(block, x, y)
        raw = loss.float()
        scale = self._ls_scale
        (raw * scale).backward()
        raw = raw.detach()
        if self._comm.placement == "process_group":
            with torch.no_grad():
                for gf in self._g_flat:
                    gf.copy_(self._comm.mean([gf]))
                raw = self._comm.mean([raw])
        fin = _precision.all_finite(self._g_flat)
        self._apply_groups(lr, self._step_count, inv_scale=1.0 / scale,
                           ok=fin.float())
        self._ls_scale, self._ls_good = _precision.loss_scale_update(
            scale, self._ls_good, fin)
        self._ls_skipped = self._ls_skipped + (1 - fin.int())
        return raw

    def _accumulate(self, block, x, y):
        """``grad_accum`` on the replicated tier: the batch's microbatches
        folded into the zeroed gradient buckets by autograd (the left
        fold of ``accumulate_grads``), divided by N; each microbatch
        starts from the step's auxiliary state, whose new value is the
        mean of theirs.  Returns the mean loss and the mutated state."""
        aux0 = [a.detach().clone() for a in self._aux_tensors]
        idx = []

        def grad_of(xm, ym):
            with torch.no_grad():
                for a, a0 in zip(self._aux_tensors, aux0):
                    a.copy_(a0)
            versions = [a._version for a in self._aux_tensors]
            loss = self._forward_loss(block, xm, ym)
            loss.backward()
            idx[:] = self._mutated(versions)
            return loss, tuple(self._aux_tensors[j].detach().clone()
                               for j in idx), None

        _, loss_sum, stack = accumulate_grads(grad_of, x, y,
                                              self._grad_accum)
        n = self._grad_accum
        with torch.no_grad():
            for gf in self._g_flat:
                gf.div_(n)
            muts = [(j, m.mean(dim=0)) for j, m in zip(idx, stack)]
            for j, m in muts:
                self._aux_tensors[j].copy_(m)
        return loss_sum / n, muts

    def _zero_rank_grads(self, i, x, y, scale=None):
        """Local rank ``i``'s forward and backward on its rows, adding its
        gradient into its flat gradient row; it starts from the step's
        auxiliary state and returns its new mutated state (the
        ``rank_grads`` of ``parallel/zero.py``'s parts)."""
        block = self._block
        with torch.no_grad():
            for a, a0 in zip(self._aux_tensors, self._zero_aux0):
                a.copy_(a0)
        for p, gv in zip(self._zero_tensors, self._zero_grad_views[i]):
            p.grad = gv
        versions = [a._version for a in self._aux_tensors]
        if scale is None:
            loss = self._forward_loss(block, x, y)
            loss.backward()
        else:
            from ..gluon.block import compute_dtype
            with compute_dtype(self._dtype):
                loss = self._forward_loss(block, x, y).float()
            (loss * scale).backward()
        idx = self._mutated(versions)
        if self._zero_mut_idx is None:
            self._zero_mut_idx = idx
        return loss.detach(), tuple(
            self._aux_tensors[j].detach().clone()
            for j in self._zero_mut_idx)

    def _step_zero(self, x, y):
        """One ZeRO-1 step (``trainer.py:576-625``): every rank's
        gradients reduce-scattered, each rank's shard updated, the shards
        all-gathered; the new running statistics are the mean over ranks
        of each rank's update."""
        if not self._ready:
            self._setup(x)
        lr = self._next_step()
        xs, ys = self._rank_rows(x), self._rank_rows(y)
        if self._reduced:
            xs = [v.to(self._dtype) if v.is_floating_point() else v
                  for v in xs]
        self._zero_aux0 = [a.detach().clone() for a in self._aux_tensors]
        block = self._block
        was = block.training
        block.train(True)
        try:
            if self._reduced:
                g_sh, loss, muts, fin = self._zero_grads_part(
                    xs, ys, self._ls_scale)
            else:
                g_sh, loss, muts = self._zero_grads_part(xs, ys)
        finally:
            block.train(was)
        with torch.no_grad():
            for j, m in zip(self._zero_mut_idx or (), muts):
                self._aux_tensors[j].copy_(m)
        self._zero_aux0 = None
        if self._reduced:
            self._ls_scale, self._ls_good, self._ls_skipped = \
                self._zero_update_part(
                    self._zero_master, self._zero_states, g_sh, lr,
                    self._step_count, self._ls_scale, self._ls_good,
                    self._ls_skipped, fin, self._zero_flat)
        else:
            self._zero_update_part(self._zero_w_shards, self._zero_states,
                                   g_sh, lr, self._step_count,
                                   self._zero_flat)
        return loss

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
        """The program, its parameters on the device, and per-parameter
        optimizer state, or under ``zero=1`` each data rank's flat
        ``(shard,)`` state (``trainer.py:780-866``)."""
        from ..transformer import step as _tstep
        from .comm import InProcessComm
        plan = self._plan
        if self._mesh is None:
            self._mesh = self._plan.build_mesh(self._device)
        program = self._block.mesh_program(plan)
        self._mesh_program = program
        params = program.init_params()
        self._mesh_param_names = list(program.param_names)
        self._mesh_params = {
            name: torch.tensor(params[name], device=self._device,
                               requires_grad=True)
            for name in self._mesh_param_names}
        self._comm = InProcessComm(plan.size("data"), self._device)
        opt = self._opt
        if self._zero:
            zp = _tstep.TPZeroPlan(program, plan.size("data"))
            self._mesh_zero_plan = zp
            leaves_r = []
            # data rank d owns a (shard,) slice of every model rank's
            # flat space: (Km * shard,) elements (transformer/step.py)
            owned = plan.size("model") * zp.shard
            for _ in self._comm.local_ranks:
                state = opt.create_state_multi_precision(
                    0, torch.zeros(owned, dtype=torch.float32,
                                   device=self._device))
                for li, leaf in enumerate(_state_leaves(state)):
                    if tuple(leaf.shape) != (owned,):
                        raise ValueError(
                            "zero=1 needs flat-shaped optimizer state "
                            "leaves; leaf %d of %s has shape %r"
                            % (li, type(opt).__name__, tuple(leaf.shape)))
                leaves_r.append(_state_leaves(state))
            self._mesh_zero_template = state
            self._mesh_state_leaves = leaves_r
            leaf_counts = None

            def apply_update(i, w, g, state_leaves, lr, t):
                # one flat shard: the fused kernel where it takes the
                # optimizer (B1 / B3 on a card), else the optimizer's rule
                from . import zero as _zmod
                st = self._mesh_zero_template
                st = tuple(state_leaves) if isinstance(st, (tuple, list)) \
                    else (state_leaves[0] if st is not None else None)
                _zmod._shard_update(opt, w, g, st, lr, t)
                return w, _state_leaves(st)
        else:
            self._mesh_zero_plan = None
            templates, leaf_counts, leaves = [], [], []
            for i, name in enumerate(self._mesh_param_names):
                state = opt.create_state_multi_precision(
                    i, self._mesh_params[name].detach())
                templates.append(state)
                leaf_counts.append(len(_state_leaves(state)))
                leaves.extend(_state_leaves(state))
            self._mesh_state_leaves = tuple(leaves)

            def apply_update(i, w, g, state_leaves, lr, t):
                state = templates[i]
                if isinstance(state, (tuple, list)):
                    state = tuple(state_leaves)
                elif state is not None:
                    state = state_leaves[0]
                nw, ns = functional_optimizer_update(opt, i, w, g, state,
                                                     lr, t)
                return nw, _state_leaves(ns)

        self._mesh_grad_fn, self._mesh_update_fn = _tstep.build_parts(
            program, apply_update, leaf_counts, zero=self._zero,
            zero_plan=self._mesh_zero_plan,
            compute_dtype=self._dtype if self._reduced else None,
            comm=self._comm)
        self._ready = True

    def _mesh_context_tag(self):
        """Which mesh axis to name when collective time dominates
        (``trainer.py:880-901``): the one armed axis of ``model``,
        ``sequence`` and ``pipe``; with several armed the reference reads
        its priced schedule (``mesh_report``, ROADMAP.md queue A, item
        13) and names ``model`` where that fails, as here."""
        tags = {"model": "tp_model", "sequence": "tp_sequence",
                "pipe": "pp_pipeline"}
        armed = [a for a in ("model", "sequence", "pipe")
                 if self._plan.present(a)]
        return tags[armed[0]] if len(armed) == 1 else "tp_model"

    def _step_mesh_tier(self, x, y):
        """One mesh-tier step: the (B, T) batch cut into each data rank's
        rows and those into the ``(K, b, T/K)`` sequence chunks, the
        grads part, then the update written back into the parameters and
        states in place."""
        if not self._ready:
            self._setup_mesh()
        seq_len = self._mesh_program.cfg.seq_len
        if x.dim() != 2 or x.shape[1] != seq_len or y.shape != x.shape \
                or x.dtype.is_floating_point or y.dtype.is_floating_point:
            raise ValueError(
                "mesh-tier batches are (batch, tokens) int32 with "
                "tokens == cfg.seq_len (%d); got shape %r (labels %r, %s)"
                % (seq_len, tuple(x.shape), tuple(y.shape), x.dtype))
        k_data = self._plan.size("data")
        if x.shape[0] % k_data:
            raise ValueError(
                "global batch %d must divide by the data axis %d "
                "(plan %r)" % (x.shape[0], k_data, self._plan))
        k_ranks = self._plan.size("sequence")

        def chunks(t):
            return [c.long().reshape(c.shape[0], k_ranks,
                                     seq_len // k_ranks).transpose(0, 1)
                    for c in t.chunk(k_data)]

        lr = self._next_step()
        vals = tuple(self._mesh_params[n] for n in self._mesh_param_names)
        grads, loss = self._mesh_grad_fn(vals, chunks(x), chunks(y))
        new_vals, new_leaves = self._mesh_update_fn(
            vals, self._mesh_state_leaves, grads, lr, self._step_count)
        with torch.no_grad():
            for w, nw in zip(vals, new_vals):
                w.copy_(nw)
            if not self._zero:
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

    # -- checkpoint / resume (resilience/checkpoint.py) ----------------------
    def save_checkpoint(self, directory, epoch=None, nbatch=None, keep=3):
        """Atomic snapshot of the full training state: params + optimizer
        states + RNG + iterator cursor (``epoch``/``nbatch``), in the
        reference's format (``trainer.py:1984-2124``).  The run-ahead ring
        is flushed first, so a snapshot never records run-ahead state.
        At ``zero=1`` each rank's state slice is its own shard file
        behind a manifest.  Returns the path (``None`` on the ranks of a
        process group other than 0, which write nothing)."""
        from ..resilience import checkpoint as _ckpt
        if not self._ready:
            raise RuntimeError("trainer has not stepped yet: nothing to "
                               "checkpoint")
        self.flush()
        if self._plan is not None:
            return self._save_mesh(directory, epoch=epoch, nbatch=nbatch,
                                   keep=keep)
        if self._zero:
            return self._save_sharded(directory, epoch=epoch,
                                      nbatch=nbatch, keep=keep)
        params = {name: _ckpt.encode_array(p.tensor())
                  for name, p in self._params_by_name.items()}
        states = [[_ckpt.encode_array(v) for v in _state_leaves(st)]
                  for st in self._states]
        payload = self._common_payload(params, epoch, nbatch)
        payload["states"] = states
        payload["groups"] = [list(g) for g in self._groups]
        if self._reduced:
            payload["loss_scale"] = self._loss_scale_payload()
        order = {name: "p%05d" % i for i, name in enumerate(params)}
        canon = dict(payload,
                     params={order[n]: enc for n, enc in params.items()},
                     groups=[[order[n] for n in g] for g in self._groups])
        if self._process_rank() != 0:
            return None
        return _ckpt.save_checkpoint(
            directory, payload, self._step_count, keep=keep,
            provenance={"epoch": epoch, "train_run_id": self.run_id,
                        "digest": _ckpt.payload_digest(canon)})

    def _process_rank(self):
        if self._kv is not None:
            return self._kv.rank
        comm = self._comm
        return 0 if comm is None or comm.placement == "in_process" \
            else comm.rank

    def _common_payload(self, params, epoch, nbatch):
        return {"params": params, "step_count": self._step_count,
                "rng": _rng_payload(),
                "numpy_global": np.random.get_state(),
                "cursor": {"epoch": epoch, "nbatch": nbatch},
                "setup_desc": self._setup_desc}

    def _loss_scale_payload(self):
        return {"scale": float(self._ls_scale),
                "good_steps": int(self._ls_good),
                "skipped": int(self._ls_skipped)}

    def _full_zero_vectors(self):
        """``(state leaves, master)`` as full ``(padded,)`` host arrays:
        the ranks' slices concatenated (gathered first when each process
        holds one rank)."""
        plan, comm = self._zero_plan, self._comm

        def full(shards):
            if comm.placement == "in_process":
                return torch.cat(list(shards))
            out = torch.empty(plan.padded, dtype=shards[0].dtype,
                              device=shards[0].device)
            return comm.all_gather(list(shards), out)

        leaves = [full(ls) for ls in zip(
            *(_state_leaves(s) for s in self._zero_states))]
        master = full(self._zero_master) if self._reduced else None
        return leaves, master

    def _save_sharded(self, directory, epoch=None, nbatch=None, keep=3):
        """Shard-parallel snapshot of a zero=1 trainer
        (``trainer.py:2058-2124``): the rank-agnostic payload (params,
        RNG, cursor, flat-layout plan) rides the manifest; every rank's
        1/K optimizer-state slice (and f32 master under bf16) is its own
        shard file."""
        from ..resilience import checkpoint as _ckpt
        plan = self._zero_plan
        params = {name: _ckpt.encode_array(p.tensor())
                  for name, p in self._params_by_name.items()}
        leaves, master = self._full_zero_vectors()
        leaves = [v.cpu() for v in leaves]
        payload = self._common_payload(params, epoch, nbatch)
        payload["zero_plan"] = plan.describe()
        payload["state_leaf_count"] = len(leaves)
        if master is not None:
            master = master.cpu()
            payload["has_master"] = True
            payload["loss_scale"] = self._loss_scale_payload()
        shards = []
        for r in range(plan.k):
            sl = slice(r * plan.shard, (r + 1) * plan.shard)
            rec = {"states": [_ckpt.encode_array(leaf[sl])
                              for leaf in leaves]}
            if master is not None:
                rec["master"] = _ckpt.encode_array(master[sl])
            shards.append(rec)
        order = {name: "p%05d" % i for i, name in enumerate(params)}
        canon = dict(payload,
                     params={order[n]: enc for n, enc in params.items()},
                     zero_plan=dict(plan.describe(),
                                    names=[order[n] for n in plan.names]))
        canon.pop("state_leaf_count", None)
        canon["full_state"] = [_ckpt.encode_array(leaf[:plan.total])
                               for leaf in leaves]
        if master is not None:
            canon["full_master"] = _ckpt.encode_array(master[:plan.total])
        for key in ("k", "padded", "shard"):
            canon["zero_plan"].pop(key, None)
        if self._process_rank() != 0:
            return None
        return _ckpt.save_sharded_checkpoint(
            directory, payload, shards, self._step_count, keep=keep,
            provenance={"epoch": epoch, "train_run_id": self.run_id,
                        "digest": _ckpt.payload_digest(canon)})

    def _setup_from_desc(self, payload):
        """Re-run setup from zeros of the recorded batch geometry, so a
        fresh trainer restores standalone."""
        if self._ready:
            return
        (dshape, ddt) = payload["setup_desc"]["data"]
        self._setup_desc = payload["setup_desc"]
        tdt = torch.bfloat16 if ddt == "bfloat16" else \
            torch.from_numpy(np.zeros(0, np.dtype(ddt))).dtype
        x0 = torch.zeros(tuple(dshape), dtype=tdt, device=self._device)
        if self._plan is not None:
            self._setup_mesh()
            return
        if self._input_transform is not None:
            x0 = self._input_transform(x0)
        self._setup(x0)

    def _restore_params(self, payload):
        from ..resilience import checkpoint as _ckpt
        mapping = self._map_checkpoint_params(payload["params"])
        with torch.no_grad():
            for cn, enc in payload["params"].items():
                t = self._params_by_name[mapping[cn]].tensor()
                t.copy_(_ckpt.decode_tensor(enc).to(t.device).view(t.shape))
        return mapping

    def _restore_common(self, payload):
        if self._reduced and "loss_scale" in payload:
            ls = payload["loss_scale"]
            dev = self._device
            self._ls_scale = torch.tensor(float(ls["scale"]),
                                          dtype=torch.float32, device=dev)
            self._ls_good = torch.tensor(int(ls["good_steps"]),
                                         dtype=torch.int32, device=dev)
            self._ls_skipped = torch.tensor(int(ls["skipped"]),
                                            dtype=torch.int32, device=dev)
            self._ls_reported_skipped = int(ls["skipped"])
        self._step_count = int(payload["step_count"])
        self._opt.num_update = self._step_count
        _restore_rng(payload["rng"])
        np.random.set_state(payload["numpy_global"])
        self._inflight.clear()
        return dict(payload["cursor"], step=self._step_count)

    def _restore_sharded(self, rec):
        """Restore a sharded record into this (zero=1) trainer at the
        CURRENT axis size (``trainer.py:2125-2225``): the shards
        concatenated in rank order, the zero tail truncated at the
        recorded ``total``, re-padded for this K and sliced per rank."""
        from ..resilience import checkpoint as _ckpt
        from . import zero as _zmod
        payload = rec["payload"]
        self._setup_from_desc(payload)
        if not self._zero:
            raise RuntimeError(
                "sharded checkpoint (ZeRO-1 optimizer shards) cannot "
                "restore into a zero=0 trainer — construct with zero=1")
        plan_old, plan = payload["zero_plan"], self._zero_plan
        if int(plan_old["total"]) != plan.total:
            raise RuntimeError(
                "sharded checkpoint's flat parameter space has %d "
                "elements, this trainer's has %d — different model"
                % (int(plan_old["total"]), plan.total))
        n_leaves = int(payload["state_leaf_count"])
        cur = [_state_leaves(s) for s in self._zero_states]
        if n_leaves != len(cur[0]):
            raise RuntimeError(
                "optimizer state leaf count mismatch (%d vs %d): "
                "different optimizer?" % (n_leaves, len(cur[0])))
        if bool(payload.get("has_master")) != bool(self._reduced):
            raise RuntimeError(
                "mixed-precision mismatch: checkpoint %s f32 masters "
                "but this trainer was constructed with dtype=%r"
                % ("has" if payload.get("has_master") else "has no",
                   str(self._dtype)))
        self._restore_params(payload)

        def padded(key, li=None):
            parts = [_ckpt.decode_array(sh[key] if li is None
                                        else sh[key][li])
                     for sh in rec["shards"]]
            full = _zmod.reassemble_state(parts, plan.total)
            arr = np.zeros((plan.padded,), np.float32)
            arr[:plan.total] = full
            return torch.from_numpy(arr).to(self._device)

        sh = plan.shard
        owned = [slice(r * sh, (r + 1) * sh)
                 for r in self._comm.local_ranks]
        with torch.no_grad():
            for li in range(n_leaves):
                full = padded("states", li)
                for leaves, s in zip(cur, owned):
                    leaves[li].copy_(full[s])
            if self._reduced:
                full = padded("master")
                for m, s in zip(self._zero_master, owned):
                    m.copy_(full[s])
                # live params re-derived by exact cast from the masters
                self._zero_flat.copy_(full.to(self._zero_flat.dtype))
        return self._restore_common(payload)

    def _map_checkpoint_params(self, params_ckpt):
        """checkpoint-name -> live-name mapping: exact names when they
        match, else positional (Gluon's name counters shift per process,
        and the two packages count apart) with a per-param shape check —
        a genuinely different model fails (``trainer.py:2227-2250``)."""
        names_ckpt = list(params_ckpt)
        names_cur = list(self._params_by_name)
        if set(names_ckpt) == set(names_cur):
            return {n: n for n in names_ckpt}
        if len(names_ckpt) == len(names_cur):
            mapping = dict(zip(names_ckpt, names_cur))
            for cn, name in mapping.items():
                shape = tuple(params_ckpt[cn][2])
                cur = tuple(int(d) for d in
                            self._params_by_name[name].tensor().shape)
                if shape != cur:
                    raise RuntimeError(
                        "checkpoint param %r %r does not match model "
                        "param %r %r (different architecture)"
                        % (cn, shape, name, cur))
            return mapping
        raise RuntimeError(
            "checkpoint has %d params, model has %d — different "
            "architecture" % (len(names_ckpt), len(names_cur)))

    def restore_checkpoint(self, path_or_dir):
        """Restore a :meth:`save_checkpoint` snapshot (a file, a manifest,
        or a directory whose newest loadable one is taken) into this
        trainer, setting it up from the recorded batch geometry if it has
        not stepped (``trainer.py:2252-2327``).  With a deterministic
        iterator the continued run is bitwise the uninterrupted one.
        Returns the cursor dict (``epoch``/``nbatch``/``step``)."""
        from ..resilience import checkpoint as _ckpt
        if os.path.isdir(path_or_dir):
            if self._zero and self._plan is None:
                found = _ckpt.latest_sharded_checkpoint(path_or_dir)
                if found is None:
                    raise FileNotFoundError(
                        "no loadable sharded checkpoint (manifest) "
                        "under %r" % (path_or_dir,))
                return self._restore_sharded(found[1])
            found = _ckpt.latest_checkpoint(path_or_dir)
            if found is None:
                raise FileNotFoundError(
                    "no loadable checkpoint under %r" % (path_or_dir,))
            rec = found[1]
        elif str(path_or_dir).endswith(_ckpt.MANIFEST_SUFFIX):
            return self._restore_sharded(
                _ckpt.load_sharded_checkpoint(path_or_dir))
        else:
            rec = _ckpt.load_checkpoint(path_or_dir)
        if self._plan is not None:
            return self._restore_mesh(rec)
        payload = rec["payload"]
        self._setup_from_desc(payload)
        if self._zero:
            raise RuntimeError("a monolithic checkpoint cannot restore into "
                               "a zero=1 trainer: restore a manifest")
        mapping = self._map_checkpoint_params(payload["params"])
        groups_ckpt = [[mapping[n] for n in g] for g in payload["groups"]]
        if groups_ckpt != [list(g) for g in self._groups]:
            raise RuntimeError(
                "checkpoint was taken from a trainer with different "
                "parameter groups (optimizer/grouping mismatch): %r vs %r"
                % (groups_ckpt, self._groups))
        self._restore_params(payload)
        with torch.no_grad():
            for gi, (st, encs) in enumerate(zip(self._states,
                                                payload["states"])):
                leaves = _state_leaves(st)
                if len(leaves) != len(encs):
                    raise RuntimeError(
                        "optimizer state leaf count mismatch for group %d "
                        "(%d vs %d): different optimizer?"
                        % (gi, len(leaves), len(encs)))
                for leaf, e in zip(leaves, encs):
                    leaf.copy_(_ckpt.decode_tensor(e).to(
                        leaf.device).view(leaf.shape))
        return self._restore_common(payload)

    # -- mesh-tier checkpointing ---------------------------------------------
    def _mesh_state_vectors(self):
        """The state leaves in the reference's global layout: per
        parameter, or under ``zero=1`` each leaf's flat ``(Km * padded,)``
        vector in ``("model", "data")`` order."""
        if not self._zero:
            return list(self._mesh_state_leaves)
        km, kd = self._plan.size("model"), self._plan.size("data")
        return [torch.stack(ls).view(kd, km, -1).transpose(0, 1).reshape(-1)
                for ls in zip(*self._mesh_state_leaves)]

    def _save_mesh(self, directory, epoch=None, nbatch=None, keep=3):
        """Monolithic snapshot of the mesh tier (``trainer.py:1143-1170``):
        program parameters by name, the state leaves (under ``zero=1``
        each leaf's data ranks concatenated: the flat global leaf)."""
        from ..resilience import checkpoint as _ckpt
        payload = {
            "mesh_params": {
                name: _ckpt.encode_array(self._mesh_params[name])
                for name in self._mesh_param_names},
            "mesh_states": [_ckpt.encode_array(v)
                            for v in self._mesh_state_vectors()],
            "step_count": self._step_count,
            "rng": _rng_payload(),
            "numpy_global": np.random.get_state(),
            "cursor": {"epoch": epoch, "nbatch": nbatch},
            "setup_desc": self._setup_desc,
            "plan": self._plan.describe(),
            "program": self._mesh_program.describe(),
        }
        return _ckpt.save_checkpoint(
            directory, payload, self._step_count, keep=keep,
            provenance={"epoch": epoch, "train_run_id": self.run_id,
                        "digest": _ckpt.payload_digest(payload)})

    def _restore_mesh(self, rec):
        from ..resilience import checkpoint as _ckpt
        payload = rec["payload"]
        if "mesh_params" not in payload:
            raise RuntimeError(
                "checkpoint is not a mesh-tier snapshot (trained by a "
                "different trainer tier?)")
        self._setup_from_desc(payload)
        if payload["program"] != self._mesh_program.describe():
            raise RuntimeError(
                "checkpoint program %r does not match this trainer's "
                "%r (different config/plan)"
                % (payload["program"], self._mesh_program.describe()))
        encs = payload["mesh_states"]
        cur = self._mesh_state_vectors()
        if len(encs) != len(cur):
            raise RuntimeError(
                "optimizer state leaf count mismatch (%d vs %d): "
                "different optimizer?" % (len(encs), len(cur)))
        with torch.no_grad():
            for name in self._mesh_param_names:
                self._mesh_params[name].copy_(_ckpt.decode_tensor(
                    payload["mesh_params"][name]))
            vals = [_ckpt.decode_tensor(e).to(self._device) for e in encs]
            if self._zero:
                km, kd = self._plan.size("model"), self._plan.size("data")
                for li, full in enumerate(vals):
                    for r, leaves in enumerate(self._mesh_state_leaves):
                        leaves[li].copy_(
                            full.view(km, kd, -1)[:, r].reshape(-1))
            else:
                for leaf, v in zip(self._mesh_state_leaves, vals):
                    leaf.copy_(v.view(leaf.shape))
        self._step_count = int(payload["step_count"])
        self._opt.num_update = self._step_count
        _restore_rng(payload["rng"])
        np.random.set_state(payload["numpy_global"])
        self._inflight.clear()
        return dict(payload["cursor"], step=self._step_count)

    # -- the training loop ---------------------------------------------------
    def fit(self, train_data, num_epoch=1, eval_metric="loss",
            batch_end_callback=None, epoch_end_callback=None,
            prefetch_depth=2, bulk_size=None, logger=None,
            checkpoint_dir=None, checkpoint_every=None, resume=False,
            checkpoint_keep=3, metrics_path=None):
        """Overlapped training loop over a ``DataIter``
        (``trainer.py:2328-2453``): ``train_data`` is wrapped in a
        ``PrefetchToDeviceIter`` on ``batch_sharding`` (so ``step``'s fast
        path reuses its transfer) unless it already is a
        ``DeviceFeedIter``; ``bulk_size`` scopes ``engine.bulk`` around
        each epoch; the loss goes to the metric by ``update_lazy``.  With
        ``checkpoint_dir`` the full state is snapshotted every
        ``checkpoint_every`` steps (default ``DEFAULT_CHECKPOINT_EVERY``)
        and at each epoch end; ``resume=True`` restores the newest
        loadable snapshot and continues from its cursor.  ``metrics_path``
        writes the metrics registry's JSON at the end.  Returns the
        metric."""
        import logging

        from .. import metric as _metric
        from ..io import DeviceFeedIter, PrefetchToDeviceIter
        from ..module.base_module import BatchEndParam, _as_list

        log = logger or logging
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        if checkpoint_dir and checkpoint_every is None:
            checkpoint_every = DEFAULT_CHECKPOINT_EVERY
        start_epoch, skip_batches = 0, 0
        if checkpoint_dir and resume:
            from ..resilience import checkpoint as _ckpt
            if (_ckpt.latest_sharded_checkpoint(checkpoint_dir)
                    if (self._zero and self._plan is None) else
                    _ckpt.latest_checkpoint(checkpoint_dir)) is not None:
                cursor = self.restore_checkpoint(checkpoint_dir)
                if cursor.get("epoch") is not None:
                    start_epoch = int(cursor["epoch"])
                    nb = cursor.get("nbatch")
                    skip_batches = (int(nb) + 1) if nb is not None else 0
                log.info("resumed from %s at step %d (epoch %d, skipping "
                         "%d replayed batches)", checkpoint_dir,
                         self._step_count, start_epoch, skip_batches)
        it = train_data
        if not isinstance(it, DeviceFeedIter):
            it = PrefetchToDeviceIter(train_data,
                                      sharding=self.batch_sharding,
                                      depth=prefetch_depth)
        for epoch in range(start_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            if epoch > start_epoch:
                it.reset()
            with _engine.bulk(bulk_size or _engine.bulk_size()):
                nbatch = -1
                for batch in it:
                    nbatch += 1
                    if epoch == start_epoch and nbatch < skip_batches:
                        # replayed batch: consumed (keeps any iterator
                        # RNG in phase) but already trained pre-crash
                        continue
                    loss = self.step(batch.data[0], batch.label[0])
                    eval_metric.update_lazy(batch.label, [loss])
                    if batch_end_callback is not None:
                        params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                               eval_metric=eval_metric,
                                               locals=None)
                        for cb in _as_list(batch_end_callback):
                            cb(params)
                    if checkpoint_dir and checkpoint_every and \
                            self._step_count % checkpoint_every == 0:
                        self.save_checkpoint(checkpoint_dir, epoch=epoch,
                                             nbatch=nbatch,
                                             keep=checkpoint_keep)
            for name, val in eval_metric.get_name_value():
                log.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            log.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)
            if checkpoint_dir and self._ready:
                # epoch boundary: the cursor points at the next epoch
                self.save_checkpoint(checkpoint_dir, epoch=epoch + 1,
                                     nbatch=None, keep=checkpoint_keep)
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, None, None, None)
        self._dump_metrics(metrics_path, log)
        return eval_metric

    def _dump_metrics(self, metrics_path, log):
        """The metrics registry's versioned JSON at the end of ``fit``,
        with the step count and the dispatch statistics
        (``trainer.py:2454``)."""
        if not metrics_path:
            return
        from ..telemetry import registry
        try:
            registry().dump_json(metrics_path, source="trainer.fit", extra={
                "step_count": self._step_count,
                "dispatch_stats": self.dispatch_stats.snapshot()})
        except OSError:
            log.exception("metrics dump to %s failed", metrics_path)
