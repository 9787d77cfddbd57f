"""KV-cached autoregressive decode: the port of
``mxnet_tpu/transformer/decode.py``.

The same parameter layout and per-layer math as the reference, in the
two phases an autoregressive server runs:

- :meth:`DecodeProgram.prefill_replica`: one full causal forward over a
  length-bucketed prompt, writing every position's K/V into the paged
  cache and returning the last real position's next-token logits.
- :meth:`DecodeProgram.decode_replica`: one token step for a fixed batch
  of sequence slots — embed the last token, write its K/V at
  ``page_table[b, length // page_size], length % page_size``, attend over
  the gathered per-sequence pages with a ``position <= length`` mask, and
  emit full-vocab logits.

**Paged cache layout** (the reference's): one pool per K and V,
``(n_layers, n_pages, page_size, heads, head_dim)`` float32 — the
reference's global pool, :meth:`DecodeProgram.global_cache_shape`.  Page
0 is the reserved scratch page: idle slots carry all-zero page tables,
so their writes land there (several slots may write the same scratch row
in one step; the order is undefined on CUDA and harmless, because
nothing live reads scratch).  The pools are zero-initialised by the
owner: decode gathers every page of a table, scratch included, and
masked positions get probability exactly 0 — but ``0 × NaN`` from
uninitialised memory would be NaN.

**The model axis** (``plan=MeshPlan(data=1, model=Km)``): the model
ranks are a leading dimension of the activations, as in training
(``transformer/model.py``): rank m holds heads ``m*H/Km ..`` and a
``V/Km`` slice of the vocab, every LayerNorm runs on ``(Km, B, t, d)``,
and the row-parallel psums complete the partial sums.  Each rank's KV
pool is its head slice of the global pool (``cache_shape`` is the local
shape, ``heads_local`` heads), so the pool's layout is the collapsed
program's; ``_full_logits`` is the concatenation of the ranks' vocab
slices (the reference's tiled all-gather).

Where JAX donates the pools through a jitted call, the port updates them
**in place** (index assignment into the tensors passed in) and returns
them, so the call signature stays the reference's.  Every LayerNorm goes
through ``layers.layer_norm``, i.e. the fused CUDA kernel on the card.

``kv_dtype="int8"`` waits (ROADMAP queue A, int8 KV).
"""
from __future__ import annotations

import torch

from ..parallel.mesh import MeshPlan
from ..parallel.ring_attention import local_attention
from . import layers as L
from .model import MeshProgram, TransformerLMConfig

__all__ = ["DecodeProgram"]

_NEG_INF = -1e30


def _full_logits(logits_local):
    """The ranks' ``(Km, B, V/Km)`` vocab slices concatenated into the
    replicated ``(B, V)`` row (the tiled all-gather over ``model``)."""
    km, b, v_local = logits_local.shape
    return logits_local.transpose(0, 1).reshape(b, km * v_local)


def _global_heads(x):
    """``(Km, ..., H/Km, e)`` per-rank heads → ``(..., H, e)`` in the
    global head order (rank m holds heads ``m*H/Km ..``)."""
    return x.movedim(0, -3).flatten(-3, -2)


def _rank_heads(x, km):
    """The inverse of :func:`_global_heads`."""
    return x.unflatten(-2, (km, -1)).movedim(-3, 0)


class DecodeProgram:
    """One ``(config, plan)`` pair's concrete KV-cached decode program.

    ``plan`` may keep only the ``model`` axis: data and sequence are
    host concerns here, as in the reference.  ``page_size`` fixes the
    token-block granularity; the per-sequence page-table width is
    ``seq_len / page_size``."""

    def __init__(self, cfg, plan=None, page_size=8, kv_dtype=None):
        if not isinstance(cfg, TransformerLMConfig):
            cfg = TransformerLMConfig(**cfg)
        plan = MeshPlan.coerce(plan) or MeshPlan(data=1)
        plan = plan.resolve(1) if plan.data is None else plan
        if plan.size("data") != 1 or plan.size("sequence") != 1:
            raise ValueError(
                "DecodeProgram serves over the model axis only (batch is "
                "the host's continuous-batching concern, sequence lives "
                "in the cache); got %r" % (plan,))
        if cfg.seq_len % int(page_size):
            raise ValueError(
                "page_size %d must divide seq_len %d"
                % (page_size, cfg.seq_len))
        if kv_dtype not in (None, "f32", "float32"):
            raise NotImplementedError(
                "kv_dtype=%r: only the float32 KV pool is ported (int8 KV "
                "is queued in ROADMAP queue A)" % (kv_dtype,))
        self.cfg = cfg
        self.plan = plan
        self.program = MeshProgram(cfg, plan)
        self.page_size = int(page_size)
        self.pages_per_seq = cfg.seq_len // self.page_size
        self.heads_local = cfg.n_heads // plan.size("model")
        self.kv_dtype = "float32"
        self._rank_cache = None

    # -- geometry ----------------------------------------------------------
    def cache_shape(self, n_pages):
        """One model rank's K or V pool shape (its heads)."""
        return (self.cfg.n_layers, int(n_pages), self.page_size,
                self.heads_local, self.cfg.head_dim)

    def global_cache_shape(self, n_pages):
        """The K or V pool of every model rank: what a runner allocates."""
        return (self.cfg.n_layers, int(n_pages), self.page_size,
                self.cfg.n_heads, self.cfg.head_dim)

    def bytes_per_page(self):
        """Bytes one page pins across all model ranks: K+V for
        ``page_size`` tokens through every layer — the unit the page
        allocator and fleet admission count."""
        cfg = self.cfg
        return 2 * cfg.n_layers * self.page_size * cfg.n_heads \
            * cfg.head_dim * 4

    def _rank_params(self, params):
        """``MeshProgram._rank_params`` of ``params`` and each layer's
        leaves, kept while the dict holds the same tensors: a decode step
        is host-bound, and the shards are views, so an in-place update of
        a parameter shows through.  Built anew under autograd, or where a
        shard is a copy."""
        vals = tuple(params.values())
        c = self._rank_cache
        if c is not None and c[0] is params and len(c[1]) == len(vals) \
                and all(a is b for a, b in zip(c[1], vals)):
            return c[2]
        prog = self.program
        p = prog._rank_params(params)
        out = p, [prog._layer(p, i) for i in range(self.cfg.n_layers)]
        if not torch.is_grad_enabled() and all(
                p[n].untyped_storage().data_ptr()
                == w.untyped_storage().data_ptr() for n, w in params.items()):
            self._rank_cache = (params, vals, out)
        return out

    # -- the phases ----------------------------------------------------------
    def prefill_replica(self, params, cache_k, cache_v, page_table,
                        tokens, lengths):
        """Full causal forward over a ``(B, Tb)`` padded prompt bucket:
        returns ``(logits, cache_k, cache_v)`` with the last *real*
        position's full-vocab next-token logits, every position's K/V
        written into ``page_table``'s pages in place (page-table tails of
        0 land in scratch).  ``params`` is the name -> GLOBAL tensor dict;
        the pools are the global ones (``global_cache_shape``);
        ``page_table`` ``(B, pages_per_seq)``, ``tokens`` ``(B, Tb)`` and
        ``lengths`` ``(B,)`` are int64 tensors on the pools' device."""
        cfg, plan, prog = self.cfg, self.plan, self.program
        p, layers = self._rank_params(params)
        B, Tb = tokens.shape
        ps = self.page_size
        h = L.vocab_parallel_embedding(p["embed"], tokens, plan)
        h = h + p["pos_embed"][:Tb][None]
        ks, vs = [], []
        for i in range(cfg.n_layers):
            lp = layers[i]
            q, k, v = prog._qkv(lp, h)
            ks.append(_global_heads(k))
            vs.append(_global_heads(v))
            hl, e = q.shape[-2:]
            o = local_attention(*(a.reshape(-1, Tb, hl, e)
                                  for a in (q, k, v)), causal=True)
            h = prog._block_tail(lp, h, o.view(q.shape))
        # logits of the last real position only: slice the hidden state
        # BEFORE the vocab projection so the bucket tail never pays it
        last = h[:, torch.arange(B, device=h.device),
                 (lengths - 1).clamp(min=0)][:, :, None]
        logits = _full_logits(prog._logits(p, last)[:, :, 0])
        # bucket position t lands at (page_table[b, t // ps], t % ps)
        npg = Tb // ps
        pages = page_table[:, :npg]
        shape = (cfg.n_layers, B, npg, ps, cfg.n_heads, cfg.head_dim)
        cache_k[:, pages] = torch.stack(ks).reshape(shape)
        cache_v[:, pages] = torch.stack(vs).reshape(shape)
        return logits, cache_k, cache_v

    def decode_replica(self, params, cache_k, cache_v, page_table,
                       lengths, tokens):
        """One token step for every batch slot: ``tokens (B,)`` are the
        slots' last tokens, ``lengths (B,)`` the cached token counts (=
        the new token's position).  Writes the new K/V in place at
        ``(page_table[b, length // ps], length % ps)``, attends over the
        gathered pages under a ``position <= length`` mask, and returns
        ``(logits, cache_k, cache_v)``.  Idle slots (zero table, length
        0) compute scratch garbage the host ignores."""
        cfg, plan, prog = self.cfg, self.plan, self.program
        km = plan.size("model")
        p, layers = self._rank_params(params)
        ps = self.page_size
        B = tokens.shape[0]
        h = L.vocab_parallel_embedding(p["embed"], tokens[:, None], plan)
        h = h + p["pos_embed"][lengths][:, None]
        page_ids = page_table.gather(1, (lengths // ps)[:, None])[:, 0]
        offs = lengths % ps
        kpos = torch.arange(self.pages_per_seq * ps, device=tokens.device)
        seen = kpos[None, :] <= lengths[:, None]          # (B, T_max)
        scale = cfg.head_dim ** -0.5
        for i in range(cfg.n_layers):
            lp = layers[i]
            q, k, v = prog._qkv(lp, h)
            cache_k[i, page_ids, offs] = _global_heads(k[:, :, 0])
            cache_v[i, page_ids, offs] = _global_heads(v[:, :, 0])
            kseq, vseq = (_rank_heads(c[i][page_table].reshape(
                B, -1, cfg.n_heads, cfg.head_dim), km)
                for c in (cache_k, cache_v))
            s = torch.einsum("mbqhd,mbkhd->mbhqk", q, kseq) * scale
            s = torch.where(seen[None, :, None, None, :], s, _NEG_INF)
            o = torch.einsum("mbhqk,mbkhd->mbqhd", torch.softmax(s, dim=-1),
                             vseq)
            h = prog._block_tail(lp, h, o)
        return _full_logits(prog._logits(p, h)[:, :, 0]), cache_k, cache_v

    def describe(self):
        return {"config": self.cfg.describe(),
                "plan": self.plan.describe(),
                "page_size": self.page_size,
                "pages_per_seq": self.pages_per_seq,
                "kv_dtype": self.kv_dtype,
                "bytes_per_page": self.bytes_per_page()}
