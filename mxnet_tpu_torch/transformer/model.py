"""Transformer LM of the port: ``mxnet_tpu/transformer/model.py``.

:class:`TransformerLMConfig`; :class:`TransformerLM`, the config carrier
``DataParallelTrainer(mesh_plan=...)`` trains; and :class:`MeshProgram`:
parameter names, shapes, the deterministic initializer and the
per-replica training loss.  ``init_params`` draws from
``numpy.random.RandomState`` in the reference's exact order
(``model.py:233-281``), so the same seed gives bitwise-equal arrays in
both packages.  :func:`from_jax_params` turns the JAX package's
parameters (numpy arrays in ``MeshProgram`` layout — what its
``init_params`` or a decode checkpoint holds) into the port's tensors.

The per-replica program runs every rank of the plan's ``sequence`` axis
at once, as a leading rank dimension of size K (``parallel/mesh.py``):
:meth:`MeshProgram.loss_replica` takes ``(K, B, T/K)`` token chunks and
returns the K per-rank losses.  Positions are global (rank r starts at
``r * T/K``), and attention crosses ranks through ring or Ulysses
attention (``parallel/ring_attention.py``).  The ``model`` axis is
collapsed (item 7) and the stage-stacked ``blk_*`` pipeline layout is
not ported (item 8): ``MeshPlan`` refuses either axis.
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import resolve_device

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
    per-replica loss, for plans with a ``sequence`` axis of any size and
    the ``model`` and ``pipe`` axes collapsed."""

    def __init__(self, cfg, plan):
        if cfg.seq_len % plan.size("sequence"):
            raise ValueError("seq_len %d must divide by the sequence "
                             "axis %d" % (cfg.seq_len, plan.size("sequence")))
        self.cfg = cfg
        self.plan = plan
        self.attention_mode = _attention_mode(cfg, plan)
        d, h, e, f, v = (cfg.d_model, cfg.n_heads, cfg.head_dim,
                         cfg.d_ff, cfg.vocab_size)
        layer = [("ln1_scale", (d,)), ("ln1_bias", (d,)),
                 ("wq", (d, h, e)), ("wk", (d, h, e)), ("wv", (d, h, e)),
                 ("wo", (h, e, d)),
                 ("ln2_scale", (d,)), ("ln2_bias", (d,)),
                 ("w1", (d, f)), ("b1", (f,)), ("w2", (f, d)),
                 ("b2", (d,))]
        assert tuple(k for k, _ in layer) == _LAYER_KINDS
        specs = [("embed", (v, d)), ("pos_embed", (cfg.seq_len, d))]
        for i in range(cfg.n_layers):
            specs += [("l%d_%s" % (i, kind), shape) for kind, shape in layer]
        specs += [("lnf_scale", (d,)), ("lnf_bias", (d,)),
                  ("w_out", (d, v))]
        self.param_names = [n for n, _ in specs]
        self._shapes = dict(specs)

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
        """Deterministic parameter arrays, name -> float32 ndarray, bitwise
        equal to the reference's ``init_params`` for the same seed."""
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
    def global_shape(self, name):
        return self._shapes[name]

    def local_shape(self, name):
        """The per-replica shape: every parameter is replicated over the
        axes the port runs, so it is the global shape."""
        return self._shapes[name]

    def local_batch_shape(self, global_batch):
        """``(batch, tokens)`` of one replica's chunk."""
        return (global_batch // self.plan.size("data"),
                self.cfg.seq_len // self.plan.size("sequence"))

    # -- the per-replica forward + loss ---------------------------------------
    def _attend(self, q, k, v):
        from ..parallel.ring_attention import (local_attention,
                                               ring_attention,
                                               ulysses_attention)
        if self.attention_mode == "ring":
            return ring_attention(q, k, v, self.plan, causal=True)
        if self.attention_mode == "ulysses":
            return ulysses_attention(q, k, v, self.plan, causal=True)
        return local_attention(q[0], k[0], v[0], causal=True)[None]

    def _embed_in(self, p, x):
        """Token + position embedding of the ``(K, b, t)`` chunks onto the
        residual stream, each rank's positions offset by its global
        start."""
        from . import layers as L

        plan, t_local = self.plan, x.shape[-1]
        h = L.vocab_parallel_embedding(p["embed"], x, plan)
        start = L.sequence_offset(plan, t_local, device=x.device)
        pos = p["pos_embed"][start[:, None]
                             + torch.arange(t_local, device=x.device)]
        return h + pos[:, None].to(h.dtype)

    def _block(self, lp, h):
        """One transformer block over per-layer param leaves ``lp``."""
        from . import layers as L

        plan = self.plan
        a = L.layer_norm(h, lp["ln1_scale"], lp["ln1_bias"])
        a = L.copy_to_model(a, plan)
        q = torch.einsum("...d,dhe->...he", a, lp["wq"])
        k = torch.einsum("...d,dhe->...he", a, lp["wk"])
        v = torch.einsum("...d,dhe->...he", a, lp["wv"])
        o = self._attend(q, k, v)
        o = torch.einsum("...he,hed->...d", o, lp["wo"])
        h = h + L.row_parallel_out(o, plan)
        m = L.layer_norm(h, lp["ln2_scale"], lp["ln2_bias"])
        m = L.copy_to_model(m, plan)
        f = L.column_parallel_dense(m, lp["w1"], lp["b1"])
        # jax.nn.gelu defaults to the tanh approximation
        f = F.gelu(f, approximate="tanh")
        f = f @ lp["w2"]
        return h + L.row_parallel_out(f, plan, bias=lp["b2"])

    def _head_loss(self, p, h, y):
        """Final norm + head + each rank's mean token loss, ``(K,)``."""
        from . import layers as L

        plan = self.plan
        hf = L.layer_norm(h, p["lnf_scale"], p["lnf_bias"])
        hf = L.copy_to_model(hf, plan)
        logits = hf @ p["w_out"]
        return L.vocab_parallel_cross_entropy(logits, y, plan).mean(
            dim=(-2, -1))

    def loss_replica(self, train_vals, x, y, key=None):
        """Each sequence rank's mean causal-LM loss of its LOCAL token
        chunk, ``(K,)``.  ``train_vals`` follow ``param_names`` order;
        ``x``/``y`` are the ``(K, B, T/K)`` token/label chunks (labels
        already globally shifted by the feeder).  The ring or all-to-all
        of attention is inside; the mean over ranks (the reference's
        ``pmean``) is the step's (``transformer/step.py``).  ``key`` is
        unused, as in the reference (no dropout)."""
        cfg = self.cfg
        p = dict(zip(self.param_names, train_vals))
        h = self._embed_in(p, x)
        for i in range(cfg.n_layers):
            h = self._block({kind: p["l%d_%s" % (i, kind)]
                             for kind in _LAYER_KINDS}, h)
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
