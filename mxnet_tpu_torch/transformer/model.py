"""Transformer LM configuration and parameter layout of the port.

The counterpart of ``mxnet_tpu/transformer/model.py``:
:class:`TransformerLMConfig`, and :class:`MeshProgram`'s parameter
names, shapes and deterministic initializer.  ``init_params`` draws from
``numpy.random.RandomState`` in the reference's exact order
(``model.py:233-281``), so the same seed gives bitwise-equal arrays in
both packages.  :func:`from_jax_params` turns the JAX package's
parameters (numpy arrays in ``MeshProgram`` layout — what its
``init_params`` or a decode checkpoint holds) into the port's tensors.

The per-replica training loss (``loss_replica``) and the stacked
pipeline layout belong to the training slice and are not ported yet.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import resolve_device

__all__ = ["TransformerLMConfig", "MeshProgram", "from_jax_params"]


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


# one transformer block's parameter kinds, in declaration order — the
# order init_params draws them in (the bitwise same-seed contract)
_LAYER_KINDS = ("ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo",
                "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")


class MeshProgram:
    """One (config, plan) pair's parameter layout and initializer, for the
    collapsed plan (no model, sequence or pipe axis)."""

    def __init__(self, cfg, plan):
        for axis in ("model", "sequence", "pipe"):
            if plan.present(axis):
                raise NotImplementedError(
                    "MeshProgram: the %r axis is not ported yet "
                    "(ROADMAP queue A)" % axis)
        self.cfg = cfg
        self.plan = plan
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

    def describe(self):
        return {"config": self.cfg.describe(),
                "plan": self.plan.describe(),
                "n_params": len(self.param_names)}


def from_jax_params(params, device=None):
    """``{name: float32 torch.Tensor}`` on ``device`` from the JAX
    package's ``MeshProgram`` parameters (``{name: numpy array}``, same
    names and layouts).  ``device`` follows :func:`~..base.resolve_device`
    (``None`` is CUDA)."""
    dev = resolve_device(device)
    return {name: torch.tensor(_np.asarray(arr, _np.float32), device=dev)
            for name, arr in params.items()}
