"""Long-context attention: the port of
``mxnet_tpu/parallel/ring_attention.py``.

:func:`local_attention` is plain torch, as the reference leaves it to
XLA.  Ring and Ulysses attention run over the plan's ``sequence`` axis,
which the port spells as a leading rank dimension of size K on one
device (``parallel/mesh.py``): q/k/v are ``(K, B, Tl, H, D)``, entry
``r`` being rank r's local chunk of a global ``(B, K*Tl, H, D)``.

- :func:`ring_attention` is a ``torch.autograd.Function``, the
  counterpart of ``_ring_core`` / ``_ring_fwd_impl`` / ``_ring_bwd_impl``
  (``:104-211``).  At hop h rank r holds chunk ``(r - h) % K`` — the
  reference's ``ppermute`` ring is ``torch.roll`` by h along the rank
  dimension.  The forward runs the flash kernel on each hop and folds
  the hop's ``(out, lse)`` in through ``logaddexp`` with the reference's
  ``_NEG_INF / 2`` guards; the backward is the second ring, ``dq``
  accumulating on its rank and ``(dk, dv)`` accumulated straight into
  the chunk's owner (where the reference's travelling accumulators end
  after K hops, added in the same order).  On bfloat16 chunks the
  reference's rounding order holds (``:118-143``, ``:160-192``): each
  hop's kernel writes bfloat16 (q's dtype), which is widened to f32 for
  the online merge; the merged output is rounded to bfloat16 once at the
  end, and is what the backward's ``delta`` reads.  Each hop's dq / dk /
  dv come back bfloat16 and accumulate in f32, rounded once at the end;
  lse and delta stay f32.
- Causal trichotomy (``_hop_cases``, ``:91-101``): hop 0 is the diagonal
  for every rank (the causal kernel), at hop h >= 1 ranks r >= h see an
  earlier chunk (the full kernel) and ranks r < h a later one, which
  contributes nothing and is skipped.  Each case's ranks are one slice of
  the rank dimension, so each hop is ONE launch per kernel: K forward
  launches per layer, K each of dq and dk/dv in the backward.
- :func:`ulysses_attention`: the two all-to-alls become reshapes and
  permutes of the rank dimension around :func:`local_attention` (no
  kernel), keeping the reference's head order (``:246-258``).
"""
from __future__ import annotations

import torch

from ..ops import pallas_kernels as _pk

__all__ = ["local_attention", "ring_attention", "ring_attention_sharded",
           "ulysses_attention", "ulysses_attention_sharded"]

# masked scores take this finite value, not -inf, so that the softmax of
# a fully masked row stays finite, as in the reference
_NEG_INF = -1e30


def local_attention(q, k, v, causal=False, scale=None, q_offset=0,
                    k_offset=0):
    """Plain attention on local chunks.  q: (B, Tq, H, D), k/v: (B, Tk, H, D).
    Offsets give the chunks' global positions for causal masking."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _ranks(plan_or_k):
    """The sequence-axis size of a MeshPlan, or an int K."""
    if hasattr(plan_or_k, "size"):
        return plan_or_k.size("sequence")
    return int(plan_or_k)


def _at_hop(x, hop, causal):
    """The chunks the query ranks see at hop ``hop``: rank r holds chunk
    ``(r - hop) % K``.  Causal hops keep only ranks ``hop..K-1`` (their
    chunks ``0..K-1-hop`` are earlier; the other ranks' are later and
    skip), a full ring every rank."""
    if causal:
        return x[:x.shape[0] - hop]
    return torch.roll(x, hop, 0)


def _send_home(acc, grad, hop, causal):
    """Add a hop's chunk gradients into the chunks' owners: the inverse
    of :func:`_at_hop`."""
    if causal:
        acc[:acc.shape[0] - hop] += grad
    else:
        acc += torch.roll(grad, -hop, 0)


def _flat(x):
    return x.reshape(-1, x.shape[-2], x.shape[-1])


class _RingCore(torch.autograd.Function):
    """Ring attention over ``(K, BH, Tl, D)`` f32 or bf16 chunks."""

    @staticmethod
    def forward(ctx, qf, kf, vf, causal, scale):
        k_ranks = qf.shape[0]
        o = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
        lse = torch.full(qf.shape[:-1], _NEG_INF, dtype=torch.float32,
                         device=qf.device)
        for hop in range(k_ranks):
            lo = hop if causal else 0
            kc, vc = _at_hop(kf, hop, causal), _at_hop(vf, hop, causal)
            qs = qf[lo:]
            out, l_h = _pk.flash_forward_with_lse(
                _flat(qs), _flat(kc), _flat(vc), causal and hop == 0, scale)
            out, l_h = out.view(qs.shape).float(), l_h.view(qs.shape[:-1])
            # combine normalized chunk outputs through their logsumexps
            o_r, lse_r = o[lo:], lse[lo:]
            lse_new = torch.logaddexp(lse_r, l_h)
            safe = torch.where(lse_new <= _NEG_INF / 2, 0.0, lse_new)
            c_old = torch.where(lse_r <= _NEG_INF / 2, 0.0,
                                torch.exp(lse_r - safe))
            c_hop = torch.where(l_h <= _NEG_INF / 2, 0.0,
                                torch.exp(l_h - safe))
            o_r.copy_(o_r * c_old[..., None] + out * c_hop[..., None])
            lse_r.copy_(lse_new)
        o = o.to(qf.dtype)
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, o, lse = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        k_ranks = qf.shape[0]
        do = do.contiguous()
        delta = _pk.flash_delta(o, do)
        dq, dk, dv = (torch.zeros(t.shape, dtype=torch.float32,
                                  device=t.device) for t in (qf, kf, vf))
        for hop in range(k_ranks):
            lo = hop if causal else 0
            kc, vc = _at_hop(kf, hop, causal), _at_hop(vf, hop, causal)
            qs = qf[lo:]
            args = (_flat(qs), _flat(kc), _flat(vc), _flat(do[lo:]),
                    lse[lo:].reshape(-1, lse.shape[-1]),
                    delta[lo:].reshape(-1, delta.shape[-1]),
                    causal and hop == 0, scale)
            dq_h = _pk.flash_dq(*args)
            dk_h, dv_h = _pk.flash_dkv(*args)
            dq[lo:] += dq_h.view(qs.shape)
            _send_home(dk, dk_h.view(kc.shape), hop, causal)
            _send_home(dv, dv_h.view(vc.shape), hop, causal)
        return (dq.to(qf.dtype), dk.to(kf.dtype), dv.to(vf.dtype), None,
                None)


def _to_bhtd(x):
    """(K, B, T, H, D) → (K, B*H, T, D) — the flash kernels' layout."""
    k_ranks, B, T, H, D = x.shape
    return x.permute(0, 1, 3, 2, 4).reshape(k_ranks, B * H, T, D)


def _from_bhtd(x, B, H):
    k_ranks, _, T, D = x.shape
    return x.reshape(k_ranks, B, H, T, D).permute(0, 1, 3, 2, 4)


def _check_ranks(q, k_ranks):
    if q.dim() != 5 or q.shape[0] != k_ranks:
        raise ValueError("sequence-parallel attention takes (K=%d, B, Tl, H, "
                         "D) chunks, got %s" % (k_ranks, tuple(q.shape)))


def ring_attention(q, k, v, plan_or_k, causal=False, scale=None):
    """Ring attention over the rank dimension of ``(K, B, Tl, H, D)``
    chunks (``plan_or_k``: a MeshPlan's ``sequence`` size, or K).  Returns
    the ``(K, B, Tl, H, D)`` output chunks: full softmax attention over
    the global sequence, differentiable, with the flash kernels on every
    hop in both directions."""
    k_ranks = _ranks(plan_or_k)
    _check_ranks(q, k_ranks)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, H = q.shape[1], q.shape[3]
    o = _RingCore.apply(_to_bhtd(q), _to_bhtd(k), _to_bhtd(v), bool(causal),
                        float(scale))
    return _from_bhtd(o, B, H)


def _split(x, k_ranks):
    """Global (B, T, H, D) → stacked (K, B, T/K, H, D) chunks."""
    B, T, H, D = x.shape
    if T % k_ranks:
        raise ValueError("sequence length %d must divide by the sequence "
                         "axis %d" % (T, k_ranks))
    return x.reshape(B, k_ranks, T // k_ranks, H, D).transpose(0, 1)


def _join(x):
    k_ranks, B, Tl, H, D = x.shape
    return x.transpose(0, 1).reshape(B, k_ranks * Tl, H, D)


def ring_attention_sharded(q, k, v, k_ranks, causal=False):
    """Global entry: q/k/v are ``(B, T, H, D)``; the sequence is cut into
    ``k_ranks`` chunks and run through :func:`ring_attention` (the
    reference's ``ring_attention_sharded`` takes a mesh where this takes
    the axis size)."""
    return _join(ring_attention(_split(q, k_ranks), _split(k, k_ranks),
                                _split(v, k_ranks), k_ranks, causal=causal))


def _seq2head(x, n):
    """(K, B, Tl, H, D) → (n, B, K*Tl, H/n, D): rank g gathers head group g
    (heads ``g*H/n .. (g+1)*H/n - 1``) over the whole sequence."""
    k_ranks, B, Tl, H, D = x.shape
    x = x.reshape(k_ranks, B, Tl, n, H // n, D)
    return x.permute(3, 1, 0, 2, 4, 5).reshape(n, B, k_ranks * Tl, H // n, D)


def _head2seq(x, k_ranks):
    """The exact inverse of :func:`_seq2head`: head group g goes back to
    heads ``g*H/n + i``, the order the reference restores at ``:246-258``."""
    n, B, T, Hn, D = x.shape
    x = x.reshape(n, B, k_ranks, T // k_ranks, Hn, D)
    return x.permute(2, 1, 3, 0, 4, 5).reshape(k_ranks, B, T // k_ranks,
                                               n * Hn, D)


def ulysses_attention(q, k, v, plan_or_k, causal=False, scale=None):
    """All-to-all (Ulysses) sequence parallelism over ``(K, B, Tl, H, D)``
    chunks: sequence sharding swapped for head sharding, full attention
    per head group, swapped back.  Needs ``H % K == 0``."""
    n = _ranks(plan_or_k)
    _check_ranks(q, n)
    if q.shape[3] % n:
        raise ValueError("ulysses attention needs heads (%d) divisible by "
                         "the sequence axis (%d)" % (q.shape[3], n))
    qg, kg, vg = (_seq2head(x, n) for x in (q, k, v))
    _, B, T, Hn, D = qg.shape
    o = local_attention(qg.reshape(n * B, T, Hn, D),
                        kg.reshape(n * B, T, Hn, D),
                        vg.reshape(n * B, T, Hn, D), causal=causal,
                        scale=scale)
    return _head2seq(o.reshape(n, B, T, Hn, D), n)


def ulysses_attention_sharded(q, k, v, k_ranks, causal=False):
    """Global ``(B, T, H, D)`` entry of :func:`ulysses_attention`."""
    return _join(ulysses_attention(_split(q, k_ranks), _split(k, k_ranks),
                                   _split(v, k_ranks), k_ranks,
                                   causal=causal))
