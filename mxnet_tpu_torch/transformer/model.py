"""Transformer LM of the port: ``mxnet_tpu/transformer/model.py``.

:class:`TransformerLMConfig`; :class:`TransformerLM`, the config carrier
``DataParallelTrainer(mesh_plan=...)`` trains; and :class:`MeshProgram`:
parameter names, shapes, partition specs, the deterministic initializer
and the per-replica training loss.  ``init_params`` draws from
``numpy.random.RandomState`` in the reference's exact order
(``model.py:233-281``), so the same seed gives bitwise-equal arrays in
both packages.  :func:`from_jax_params` turns the JAX package's
parameters (numpy arrays in ``MeshProgram`` layout — what its
``init_params`` or a decode checkpoint holds) into the port's tensors.

The per-replica program runs every rank of the plan's ``model`` and
``sequence`` axes at once, as two leading rank dimensions of the
activations, ``(Km, Ks, B, T/Ks, ...)`` (``parallel/mesh.py``):
:meth:`MeshProgram.loss_replica` takes ``(Ks, B, T/Ks)`` token chunks
and returns the ``(Km, Ks)`` per-rank losses.  Positions are global
(sequence rank r starts at ``r * T/Ks``), attention crosses sequence
ranks through ring or Ulysses attention
(``parallel/ring_attention.py``), and the model ranks meet in the
collectives of ``layers.py``.

**Parameters stay global tensors** (``init_params``, ``from_jax_params``
and checkpoints keep the reference's layout).  Each rank's shard is a
view, :meth:`MeshProgram.rank_view`: a parameter split over ``model`` on
dim ``i`` by ``partition_spec`` (the reference's table, ``:172-205``)
is viewed with that dim cut into ``(Km, size/Km)`` and the Km moved to
the front — ``wq (d, h, e)`` is ``(Km, d, h/Km, e)``, ``wo (h, e, d)``
``(Km, h/Km, e, d)``, ``w1`` / ``b1`` / ``w2`` split on ``f``,
``embed`` / ``w_out`` on ``v``; a replicated parameter is read as it is
by every rank, through ``layers.replicated``.  The stage-stacked
``blk_*`` pipeline layout is not ported (item 8): ``MeshPlan`` refuses
the axis.
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import resolve_device
from ..parallel.mesh import PartitionSpec

__all__ = ["TransformerLMConfig", "TransformerLM", "MeshProgram",
           "from_jax_params"]


class TransformerLMConfig:
    """Pinned-geometry transformer-LM hyperparameters (the reference's
    fields, so one config dict builds either package's model)."""

    def __init__(self, vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                 d_ff=64, seq_len=64, attention="ring", init_seed=0,
                 init_scale=0.02, microbatches=None):
        self.vocab_size = int(vocab_size)
        self.d_model = int(d_model)
        self.n_heads = int(n_heads)
        self.n_layers = int(n_layers)
        self.d_ff = int(d_ff)
        self.seq_len = int(seq_len)
        self.attention = str(attention)
        self.init_seed = int(init_seed)
        self.init_scale = float(init_scale)
        self.microbatches = (None if microbatches is None
                             else int(microbatches))
        if self.d_model % self.n_heads:
            raise ValueError("d_model %d must divide into n_heads %d"
                             % (self.d_model, self.n_heads))
        if self.attention not in ("ring", "ulysses", "auto"):
            raise ValueError("attention must be ring/ulysses/auto, got %r"
                             % (attention,))
        if self.microbatches is not None and self.microbatches < 1:
            raise ValueError("microbatches must be >= 1, got %r"
                             % (microbatches,))

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    def describe(self):
        return {k: getattr(self, k) for k in
                ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff",
                 "seq_len", "attention", "init_seed", "microbatches")}


class TransformerLM:
    """The block handed to ``DataParallelTrainer(mesh_plan=...)`` — a
    thin config carrier implementing the mesh-program protocol the
    trainer's mesh tier consumes (``mesh_program(plan)``)."""

    def __init__(self, cfg):
        if not isinstance(cfg, TransformerLMConfig):
            cfg = TransformerLMConfig(**cfg)
        self.cfg = cfg

    def mesh_program(self, plan):
        return MeshProgram(self.cfg, plan)


def _attention_mode(cfg, plan):
    """The ring-vs-Ulysses decision rule (reference ``model.py:94-113``):
    Ulysses needs the head count to divide by the sequence-axis size;
    ``auto`` prefers it when legal, ring otherwise; ``local`` with the
    axis collapsed."""
    if not plan.present("sequence"):
        return "local"
    h_local = cfg.n_heads // plan.size("model")
    divides = h_local % plan.size("sequence") == 0
    if cfg.attention == "ulysses":
        if not divides:
            raise ValueError(
                "ulysses attention needs local heads (%d) divisible by "
                "the sequence axis (%d); use attention='ring'"
                % (h_local, plan.size("sequence")))
        return "ulysses"
    if cfg.attention == "auto" and divides:
        return "ulysses"
    return "ring"


# one transformer block's parameter kinds, in declaration order — the
# order init_params draws them in (the bitwise same-seed contract)
_LAYER_KINDS = ("ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo",
                "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")


class MeshProgram:
    """One (config, plan) pair's parameter layout, initializer and
    per-replica loss, for plans with ``model`` and ``sequence`` axes of
    any size and the ``pipe`` axis collapsed."""

    def __init__(self, cfg, plan):
        km, ks = plan.size("model"), plan.size("sequence")
        if cfg.n_heads % km:
            raise ValueError("n_heads %d must divide by the model axis %d"
                             % (cfg.n_heads, km))
        if cfg.d_ff % km:
            raise ValueError("d_ff %d must divide by the model axis %d"
                             % (cfg.d_ff, km))
        if cfg.vocab_size % km:
            raise ValueError("vocab_size %d must divide by the model "
                             "axis %d" % (cfg.vocab_size, km))
        if cfg.seq_len % ks:
            raise ValueError("seq_len %d must divide by the sequence "
                             "axis %d" % (cfg.seq_len, ks))
        self.cfg = cfg
        self.plan = plan
        self.attention_mode = _attention_mode(cfg, plan)
        model = "model"
        d, h, e, f, v = (cfg.d_model, cfg.n_heads, cfg.head_dim,
                         cfg.d_ff, cfg.vocab_size)
        # kind -> (per-layer global shape, the dims split over model),
        # the reference's table
        layer = [("ln1_scale", (d,), (None,)),
                 ("ln1_bias", (d,), (None,)),
                 ("wq", (d, h, e), (None, model, None)),
                 ("wk", (d, h, e), (None, model, None)),
                 ("wv", (d, h, e), (None, model, None)),
                 ("wo", (h, e, d), (model, None, None)),
                 ("ln2_scale", (d,), (None,)),
                 ("ln2_bias", (d,), (None,)),
                 ("w1", (d, f), (None, model)),
                 ("b1", (f,), (model,)),
                 ("w2", (f, d), (model, None)),
                 ("b2", (d,), (None,))]
        assert tuple(k for k, _, _ in layer) == _LAYER_KINDS
        specs = [("embed", (v, d), (model, None)),
                 ("pos_embed", (cfg.seq_len, d), ())]
        for i in range(cfg.n_layers):
            specs += [("l%d_%s" % (i, kind), shape, entries)
                      for kind, shape, entries in layer]
        specs += [("lnf_scale", (d,), ()), ("lnf_bias", (d,), ()),
                  ("w_out", (d, v), (None, model))]
        self.param_names = [n for n, _, _ in specs]
        self._shapes = {n: s for n, s, _ in specs}
        # the split dim of each parameter (None: replicated); its spec
        # names the axis only where the plan keeps it
        self._split = {n: (p.index(model) if model in p else None)
                       for n, _, p in specs}
        keep = plan.present(model)
        self._specs = {n: PartitionSpec(*(a if keep else None for a in p))
                       for n, _, p in specs}

    @staticmethod
    def _init_leaf(rng, cfg, name, shape):
        """One leaf, by naming rule: scaled-normal weights, ones/zeros
        norms, zero biases (reference ``model.py:234-251``)."""
        if name.endswith("_scale"):
            return _np.ones(shape, _np.float32)
        if name.endswith(("_bias", "b1", "b2")):
            return _np.zeros(shape, _np.float32)
        if name in ("embed", "pos_embed"):
            return (rng.randn(*shape) * cfg.init_scale
                    ).astype(_np.float32)
        # fan-in scaled: wo contracts (heads, head_dim), the rest dim 0
        fan_in = shape[0] * shape[1] if name.endswith("wo") \
            else shape[0]
        return (rng.randn(*shape) / _np.sqrt(max(fan_in, 1))
                ).astype(_np.float32)

    def init_params(self, seed=None):
        """Deterministic GLOBAL parameter arrays, name -> float32 ndarray,
        bitwise equal to the reference's ``init_params`` for the same
        seed at any plan."""
        cfg = self.cfg
        rng = _np.random.RandomState(
            cfg.init_seed if seed is None else int(seed))
        out = {}
        for name in ("embed", "pos_embed"):
            out[name] = self._init_leaf(rng, cfg, name, self._shapes[name])
        for i in range(cfg.n_layers):
            for kind in _LAYER_KINDS:
                name = "l%d_%s" % (i, kind)
                out[name] = self._init_leaf(rng, cfg, kind,
                                            self._shapes[name])
        for name in ("lnf_scale", "lnf_bias", "w_out"):
            out[name] = self._init_leaf(rng, cfg, name, self._shapes[name])
        return out

    # -- layout -----------------------------------------------------------
    def partition_spec(self, name):
        return self._specs[name]

    def global_shape(self, name):
        return self._shapes[name]

    def local_shape(self, name):
        """One rank's shard shape (the reference's ``local_shape``)."""
        shape = list(self._shapes[name])
        dim = self._split[name]
        if dim is not None:
            shape[dim] //= self.plan.size("model")
        return tuple(shape)

    def local_batch_shape(self, global_batch):
        """``(batch, tokens)`` of one replica's chunk."""
        return (global_batch // self.plan.size("data"),
                self.cfg.seq_len // self.plan.size("sequence"))

    def rank_view(self, name, w):
        """Every model rank's shard of the global ``w``, stacked on a
        leading rank dimension: a view, ``(Km, *local_shape)``; a
        replicated parameter is broadcast (no copy)."""
        km = self.plan.size("model")
        dim = self._split[name]
        if dim is None:
            return w.unsqueeze(0).expand((km,) + tuple(w.shape))
        shape = tuple(w.shape)
        return w.reshape(shape[:dim] + (km, shape[dim] // km)
                         + shape[dim + 1:]).movedim(dim, 0)

    def rank_unview(self, name, stacked):
        """The inverse of :meth:`rank_view`: the global tensor from the
        ranks' ``(Km, *local_shape)`` shards (rank 0's copy of a
        replicated parameter)."""
        dim = self._split[name]
        if dim is None:
            return stacked[0]
        return stacked.movedim(0, dim).reshape(self._shapes[name])

    def _rank_params(self, p):
        """What each rank reads, by name: the stacked shards of the split
        parameters, the replicated ones through ``layers.replicated``."""
        from . import layers as L
        return {n: (L.replicated(w, self.plan)
                    if self._split[n] is None else self.rank_view(n, w))
                for n, w in p.items()}

    # -- the per-replica forward + loss ---------------------------------------
    def _attend(self, q, k, v):
        from ..parallel.ring_attention import (local_attention,
                                               ring_attention,
                                               ulysses_attention)
        if self.attention_mode in ("ring", "ulysses"):
            # the model ranks fold into the batch of the (Ks, B, Tl, H/Km,
            # e) chunks: a ring hop stays ONE launch over Km*B*H/Km heads,
            # and Ulysses swaps each model rank's local heads (a view at
            # Km = 1)
            attend = ring_attention if self.attention_mode == "ring" \
                else ulysses_attention
            km, ks, b = q.shape[:3]
            o = attend(*(a.transpose(0, 1).reshape((ks, km * b)
                                                   + a.shape[3:])
                         for a in (q, k, v)), self.plan, causal=True)
            return o.reshape((ks, km, b) + o.shape[2:]).transpose(0, 1)
        lead, (t, hl, e) = q.shape[:-3], q.shape[-3:]
        o = local_attention(*(a.reshape(-1, t, hl, e) for a in (q, k, v)),
                            causal=True)
        return o.view(q.shape)

    def _embed_in(self, p, x):
        """Token + position embedding of the ``(Ks, b, t)`` chunks onto the
        ``(Km, Ks, b, t, d)`` residual stream, each sequence rank's
        positions offset by its global start."""
        from . import layers as L

        plan, t_local = self.plan, x.shape[-1]
        h = L.vocab_parallel_embedding(p["embed"], x, plan)
        start = L.sequence_offset(plan, t_local, device=x.device)
        pos = p["pos_embed"][start[:, None]
                             + torch.arange(t_local, device=x.device)]
        return h + pos[:, None].to(h.dtype)

    def _layer(self, p, i):
        """Layer ``i``'s leaves, kind -> what each rank reads."""
        return {kind: p["l%d_%s" % (i, kind)] for kind in _LAYER_KINDS}

    def _qkv(self, lp, h):
        """LayerNorm and the column-parallel Q, K, V projections of the
        ``(Km, ..., d)`` residual stream: ``(Km, ..., H/Km, e)`` each."""
        from . import layers as L

        km = h.shape[0]
        hl, e = lp["wq"].shape[-2:]
        a = L.layer_norm(h, lp["ln1_scale"], lp["ln1_bias"])
        # Megatron f-op: every replicated activation entering a
        # column-parallel region needs its cotangent summed back
        a = L.copy_to_model(a, self.plan)
        return tuple(L.column_parallel_dense(
            a, lp[w].reshape(km, -1, hl * e)).view(a.shape[:-1] + (hl, e))
            for w in ("wq", "wk", "wv"))

    def _block_tail(self, lp, h, o):
        """The row-parallel attention-out projection, the residual, and
        the MLP half of a block (shared with ``decode.py``)."""
        from . import layers as L

        plan = self.plan
        km, (hl, e) = h.shape[0], o.shape[-2:]
        o = L.column_parallel_dense(o.reshape(o.shape[:-2] + (hl * e,)),
                                    lp["wo"].reshape(km, hl * e, -1))
        h = h + L.row_parallel_out(o, plan)
        m = L.layer_norm(h, lp["ln2_scale"], lp["ln2_bias"])
        m = L.copy_to_model(m, plan)
        f = L.column_parallel_dense(m, lp["w1"], lp["b1"])
        # jax.nn.gelu defaults to the tanh approximation
        f = F.gelu(f, approximate="tanh")
        f = L.column_parallel_dense(f, lp["w2"])
        return h + L.row_parallel_out(f, plan, bias=lp["b2"])

    def _block(self, lp, h):
        """One transformer block over per-layer leaves ``lp``."""
        return self._block_tail(lp, h, self._attend(*self._qkv(lp, h)))

    def _logits(self, p, h):
        """Final norm and the vocab-parallel head: ``(Km, ..., V/Km)``."""
        from . import layers as L

        hf = L.layer_norm(h, p["lnf_scale"], p["lnf_bias"])
        hf = L.copy_to_model(hf, self.plan)
        return L.column_parallel_dense(hf, p["w_out"])

    def _head_loss(self, p, h, y):
        """Each rank's mean token loss, ``(Km, Ks)``."""
        from . import layers as L
        return L.vocab_parallel_cross_entropy(
            self._logits(p, h), y, self.plan).mean(dim=(-2, -1))

    def loss_replica(self, train_vals, x, y, key=None):
        """Each (model, sequence) rank's mean causal-LM loss of its LOCAL
        token chunk, ``(Km, Ks)`` (the Km entries of a sequence rank are
        equal: the losses are completed over ``model``).  ``train_vals``
        are the GLOBAL parameters in ``param_names`` order; ``x``/``y``
        are the ``(Ks, B, T/Ks)`` token/label chunks (labels already
        globally shifted by the feeder).  The model collectives, and the
        ring or all-to-all of attention, are inside; the reduction over
        ranks is the step's (``transformer/step.py``).  ``key`` is
        unused, as in the reference (no dropout)."""
        cfg = self.cfg
        p = self._rank_params(dict(zip(self.param_names, train_vals)))
        h = self._embed_in(p, x)
        for i in range(cfg.n_layers):
            h = self._block(self._layer(p, i), h)
        return self._head_loss(p, h, y)

    def describe(self):
        return {"config": self.cfg.describe(),
                "plan": self.plan.describe(),
                "attention_mode": self.attention_mode,
                "n_params": len(self.param_names)}


def from_jax_params(params, device=None):
    """``{name: float32 torch.Tensor}`` on ``device`` from the JAX
    package's ``MeshProgram`` parameters (``{name: numpy array}``, same
    names and layouts).  ``device`` follows :func:`~..base.resolve_device`
    (``None`` is CUDA)."""
    dev = resolve_device(device)
    return {name: torch.tensor(_np.asarray(arr, _np.float32), device=dev)
            for name, arr in params.items()}
