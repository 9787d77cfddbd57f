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
``(n_layers, n_pages, page_size, heads, head_dim)`` float32.  Page 0 is
the reserved scratch page: idle slots carry all-zero page tables, so
their writes land there (several slots may write the same scratch row in
one step; the order is undefined on CUDA and harmless, because nothing
live reads scratch).  The pools are zero-initialised by the owner: decode
gathers every page of a table, scratch included, and masked positions
get probability exactly 0 — but ``0 × NaN`` from uninitialised memory
would be NaN.

Where JAX donates the pools through a jitted call, the port updates them
**in place** (index assignment into the tensors passed in) and returns
them, so the call signature stays the reference's.  Every LayerNorm goes
through ``layers.layer_norm``, i.e. the fused CUDA kernel on the card.

``kv_dtype="int8"`` waits (ROADMAP queue A, int8 KV).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.mesh import MeshPlan
from ..parallel.ring_attention import local_attention
from . import layers as L
from .model import MeshProgram, TransformerLMConfig

__all__ = ["DecodeProgram"]

_NEG_INF = -1e30


class DecodeProgram:
    """One ``(config, plan)`` pair's concrete KV-cached decode program.

    ``plan`` must be collapsed on every axis the port runs (data and
    sequence are host concerns here, as in the reference, and ``model``
    is not ported).  ``page_size`` fixes the token-block granularity; the
    per-sequence page-table width is ``seq_len / page_size``."""

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
        self.heads_local = cfg.n_heads
        self.kv_dtype = "float32"

    # -- geometry ----------------------------------------------------------
    def cache_shape(self, n_pages):
        """K or V pool shape."""
        return (self.cfg.n_layers, int(n_pages), self.page_size,
                self.heads_local, self.cfg.head_dim)

    def bytes_per_page(self):
        """Bytes one page pins: K+V for ``page_size`` tokens through every
        layer — the unit the page allocator and fleet admission count."""
        cfg = self.cfg
        return 2 * cfg.n_layers * self.page_size * cfg.n_heads \
            * cfg.head_dim * 4

    # -- the phases ----------------------------------------------------------
    def _block_tail(self, p, pre, h, o):
        """Attention-out projection, residual, and the MLP half of a
        block (shared by both phases)."""
        plan = self.plan
        o = torch.einsum("bthe,hed->btd", o, p[pre + "wo"])
        h = h + L.row_parallel_out(o, plan)
        m = L.layer_norm(h, p[pre + "ln2_scale"], p[pre + "ln2_bias"])
        m = L.copy_to_model(m, plan)
        f = L.column_parallel_dense(m, p[pre + "w1"], p[pre + "b1"])
        # jax.nn.gelu defaults to the tanh approximation
        f = F.gelu(f, approximate="tanh")
        f = f @ p[pre + "w2"]
        return h + L.row_parallel_out(f, plan, bias=p[pre + "b2"])

    def _qkv(self, p, pre, h):
        a = L.layer_norm(h, p[pre + "ln1_scale"], p[pre + "ln1_bias"])
        a = L.copy_to_model(a, self.plan)
        return tuple(torch.einsum("btd,dhe->bthe", a, p[pre + w])
                     for w in ("wq", "wk", "wv"))

    def _logits(self, p, h):
        hf = L.layer_norm(h, p["lnf_scale"], p["lnf_bias"])
        hf = L.copy_to_model(hf, self.plan)
        return (hf @ p["w_out"])[:, 0]

    def prefill_replica(self, params, cache_k, cache_v, page_table,
                        tokens, lengths):
        """Full causal forward over a ``(B, Tb)`` padded prompt bucket:
        returns ``(logits, cache_k, cache_v)`` with the last *real*
        position's full-vocab next-token logits, every position's K/V
        written into ``page_table``'s pages in place (page-table tails of
        0 land in scratch).  ``params`` is the name -> tensor dict;
        ``page_table`` ``(B, pages_per_seq)``, ``tokens`` ``(B, Tb)`` and
        ``lengths`` ``(B,)`` are int64 tensors on the pools' device."""
        cfg, plan = self.cfg, self.plan
        p = params
        B, Tb = tokens.shape
        ps = self.page_size
        h = L.vocab_parallel_embedding(p["embed"], tokens, plan)
        h = h + p["pos_embed"][:Tb][None]
        ks, vs = [], []
        for i in range(cfg.n_layers):
            pre = "l%d_" % i
            q, k, v = self._qkv(p, pre, h)
            ks.append(k)
            vs.append(v)
            o = local_attention(q, k, v, causal=True)
            h = self._block_tail(p, pre, h, o)
        # logits of the last real position only: slice the hidden state
        # BEFORE the vocab projection so the bucket tail never pays it
        last = h[torch.arange(B, device=h.device),
                 (lengths - 1).clamp(min=0)][:, None]
        logits = self._logits(p, last)
        # bucket position t lands at (page_table[b, t // ps], t % ps)
        npg = Tb // ps
        pages = page_table[:, :npg]
        shape = (cfg.n_layers, B, npg, ps, self.heads_local, cfg.head_dim)
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
        cfg, plan = self.cfg, self.plan
        p = params
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
            pre = "l%d_" % i
            q, k, v = self._qkv(p, pre, h)
            cache_k[i, page_ids, offs] = k[:, 0]
            cache_v[i, page_ids, offs] = v[:, 0]
            kseq = cache_k[i][page_table].reshape(
                B, -1, self.heads_local, cfg.head_dim)
            vseq = cache_v[i][page_table].reshape(
                B, -1, self.heads_local, cfg.head_dim)
            s = torch.einsum("bqhd,bkhd->bhqk", q, kseq) * scale
            s = torch.where(seen[:, None, None, :], s, _NEG_INF)
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                             vseq)
            h = self._block_tail(p, pre, h, o)
        return self._logits(p, h), cache_k, cache_v

    def describe(self):
        return {"config": self.cfg.describe(),
                "plan": self.plan.describe(),
                "page_size": self.page_size,
                "pages_per_seq": self.pages_per_seq,
                "kv_dtype": self.kv_dtype,
                "bytes_per_page": self.bytes_per_page()}
