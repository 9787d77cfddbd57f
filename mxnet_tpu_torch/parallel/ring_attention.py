"""Attention on local chunks: ``local_attention`` of
``mxnet_tpu/parallel/ring_attention.py``.

The JAX package leaves this function to XLA, so the port spells it in
plain torch matmuls and a softmax.  Ring and Ulysses attention (the
sequence-parallel paths, which run the flash-attention kernels) belong
to the training slice and are not ported yet (ROADMAP queues A11, B5-B7).
"""
from __future__ import annotations

import torch

__all__ = ["local_attention"]

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
