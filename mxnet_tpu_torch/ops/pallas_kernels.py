"""Flash attention: the port of the flash part of
``mxnet_tpu/ops/pallas_kernels.py`` (``:51-426``).

Three hand-written CUDA kernels (``csrc/flash_attention.cu``), each the
Hopper port of a Pallas kernel of that module:

- :func:`flash_forward_with_lse` → ``mxtt_flash_fwd`` (``_fa_kernel``,
  ``:62``): the attention output and the per-row logsumexp;
- :func:`flash_dq` → ``mxtt_flash_dq`` (``_fa_dq_kernel``, ``:171``);
- :func:`flash_dkv` → ``mxtt_flash_dkv`` (``_fa_dkv_kernel``, ``:226``).

:func:`flash_delta` is plain torch, as it is jnp in the reference, and
:func:`flash_attention` over ``(B, T, H, D)`` is a
``torch.autograd.Function`` whose forward is the first kernel and whose
backward is ``flash_delta`` followed by the other two (``_flash_core``,
``:381-406``).

Layout: ``q``/``k``/``v`` are ``(BH, T, D)`` (what ``_to_bhtd`` gives),
``lse`` and ``delta`` plain ``(BH, T)`` float32 — the reference's
``(BH, 8, T)`` sublane broadcast is a TPU tile artifact and is dropped.
``Tq`` and ``Tk`` may differ; in causal mode both are aligned at
position 0.  Float32 only: another dtype raises (mixed precision is
ROADMAP.md queue A, item 5).  Head dims up to 128.

Each wrapper runs its kernel for a CUDA tensor and its plain torch
version (the ``*_reference`` function beside it, the Pallas body's
arithmetic on whole matrices) for a CPU tensor; a CUDA tensor launches
the kernel or raises.  Every launch adds one to ``LAUNCHES[<wrapper>]``
(:func:`launch_counts` / :func:`reset_launch_counts`).  The op registry
entry (``_contrib_flash_attention``) waits for the registry (item 1).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError

__all__ = ["flash_forward_with_lse", "flash_forward_with_lse_reference",
           "flash_delta", "flash_dq", "flash_dq_reference", "flash_dkv",
           "flash_dkv_reference", "flash_attention", "launch_counts",
           "reset_launch_counts", "LAUNCHES", "MAX_HEAD_DIM"]

_NEG_INF = -1e30
MAX_HEAD_DIM = 128

LAUNCHES = {"flash_forward_with_lse": 0, "flash_dq": 0, "flash_dkv": 0}
_count_lock = threading.Lock()


def launch_counts():
    """``{kernel wrapper name: launches}`` since the last reset."""
    with _count_lock:
        return dict(LAUNCHES)


def reset_launch_counts():
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name):
    with _count_lock:
        LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# plain versions: the Pallas bodies' arithmetic over whole (T, T) blocks
# ---------------------------------------------------------------------------
def _valid(tq, tk, causal, device):
    """(Tq, Tk) mask of the positions a query may see, or None."""
    if not causal:
        return None
    qpos = torch.arange(tq, device=device)
    kpos = torch.arange(tk, device=device)
    return qpos[:, None] >= kpos[None, :]


def flash_forward_with_lse_reference(q, k, v, causal, scale):
    """Plain ``_fa_kernel``: ``(out, lse)`` with the online softmax's
    guards (masked scores -1e30, ``m_safe``, ``p = 0`` at the mask,
    ``denom = max(l, 1e-30)``) taken over the whole row at once."""
    s = torch.einsum("btd,bsd->bts", q, k) * scale
    valid = _valid(q.shape[1], k.shape[1], causal, q.device)
    if valid is not None:
        s = torch.where(valid[None], s, _NEG_INF)
    m = s.max(dim=-1, keepdim=True).values
    m_safe = torch.where(m <= _NEG_INF / 2, 0.0, m)
    p = torch.where(s <= _NEG_INF / 2, 0.0, torch.exp(s - m_safe))
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bts,bsd->btd", p, v) / denom
    return out, (m + torch.log(denom))[..., 0]


def _recompute(q, k, v, do, lse, delta, causal, scale):
    """``(p, ds)`` of the backward kernels, recomputed from (q, k, lse)."""
    s = torch.einsum("btd,bsd->bts", q, k) * scale
    valid = _valid(q.shape[1], k.shape[1], causal, q.device)
    p = torch.exp(s - lse[..., None])
    if valid is not None:
        p = torch.where(valid[None], p, 0.0)
    dp = torch.einsum("btd,bsd->bts", do, v)
    ds = p * (dp - delta[..., None])
    if valid is not None:
        ds = torch.where(valid[None], ds, 0.0)
    return p, ds


def flash_dq_reference(q, k, v, do, lse, delta, causal, scale):
    """Plain ``_fa_dq_kernel``: ``dq = (p (dp - delta)) k * scale``."""
    _, ds = _recompute(q, k, v, do, lse, delta, causal, scale)
    return torch.einsum("bts,bsd->btd", ds, k) * scale


def flash_dkv_reference(q, k, v, do, lse, delta, causal, scale):
    """Plain ``_fa_dkv_kernel``: ``(dk, dv) = (ds^T q * scale, p^T dO)``."""
    p, ds = _recompute(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bts,btd->bsd", p, do)
    dk = torch.einsum("bts,btd->bsd", ds, q) * scale
    return dk, dv


def flash_delta(o, do):
    """The softmax-normalization gradient ``delta = rowsum(dO * O)``,
    ``(BH, T)`` float32."""
    return (do.float() * o.float()).sum(dim=-1)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # (q, k, v, o, lse, bh, tq, tk, d, scale, causal, stream)
    "mxtt_flash_fwd": [_P] * 5 + [_I] * 4 + [_F, _I, _P],
    # (q, k, v, do, lse, delta, dq, bh, tq, tk, d, scale, causal, stream)
    "mxtt_flash_dq": [_P] * 7 + [_I] * 4 + [_F, _I, _P],
    # (q, k, v, do, lse, delta, dk, dv, bh, tq, tk, d, scale, causal, stream)
    "mxtt_flash_dkv": [_P] * 8 + [_I] * 4 + [_F, _I, _P],
}


def _fn(name):
    from .build import load
    fn = getattr(load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(wrapper, q, k, v, rows=()):
    """Validate ``(BH, T, D)`` q/k/v and ``(BH, Tq, ...)`` row operands;
    True when they live on the card."""
    for t in (q, k, v) + tuple(rows):
        if t.dtype != torch.float32:
            raise NotImplementedError(
                "%s takes float32, got %s: other dtypes are ROADMAP.md "
                "queue A, item 5 (mixed precision)" % (wrapper, t.dtype))
        if t.device != q.device:
            raise MXNetError("%s: every tensor must be on %s, got %s"
                             % (wrapper, q.device, t.device))
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise MXNetError("%s takes (BH, T, D) q/k/v, got %s/%s/%s"
                         % (wrapper, tuple(q.shape), tuple(k.shape),
                            tuple(v.shape)))
    bh, tq, d = q.shape
    if k.shape != (bh, k.shape[1], d) or v.shape != k.shape:
        raise MXNetError("%s: k/v %s/%s do not match q %s"
                         % (wrapper, tuple(k.shape), tuple(v.shape),
                            tuple(q.shape)))
    for t in rows:
        if t.shape[:2] != (bh, tq):
            raise MXNetError("%s: row operand %s does not match q %s"
                             % (wrapper, tuple(t.shape), tuple(q.shape)))
    if q.device.type not in ("cuda", "cpu"):
        raise MXNetError("%s: unsupported device %s" % (wrapper, q.device))
    if q.device.type != "cuda":
        return False
    if not 1 <= d <= MAX_HEAD_DIM:
        raise MXNetError("%s: head dim %d outside the kernel's 1..%d"
                         % (wrapper, d, MAX_HEAD_DIM))
    if bh * max(tq, k.shape[1]) * d >= 2 ** 31:
        raise MXNetError("%s: %s exceeds the kernel's int32 sizes"
                         % (wrapper, tuple(q.shape)))
    return True


def _launch(wrapper, kernel, tensors, dims, scale, causal):
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn(kernel)(*(t.data_ptr() for t in tensors), *dims,
                          float(scale), int(bool(causal)), stream)
    if err != 0:
        raise MXNetError("%s kernel launch failed: cudaError %d"
                         % (kernel, err))
    _count(wrapper)


def flash_forward_with_lse(q, k, v, causal, scale):
    """``(out, lse)``: attention of ``(BH, Tq, D)`` queries over
    ``(BH, Tk, D)`` keys/values, with ``lse`` ``(BH, Tq)`` float32 — the
    building block of ring attention."""
    if not _check("flash_forward_with_lse", q, k, v):
        return flash_forward_with_lse_reference(q, k, v, causal, scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bh, tq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    _launch("flash_forward_with_lse", "mxtt_flash_fwd", (q, k, v, out, lse),
            (bh, tq, k.shape[1], d), scale, causal)
    return out, lse


def flash_dq(q, k, v, do, lse, delta, causal, scale):
    """dq for one (q-chunk × k-chunk) pairing; ``lse``/``delta`` are
    ``(BH, Tq)`` float32."""
    if not _check("flash_dq", q, k, v, (do, lse, delta)):
        return flash_dq_reference(q, k, v, do, lse, delta, causal, scale)
    q, k, v, do, lse, delta = (t.contiguous()
                               for t in (q, k, v, do, lse, delta))
    bh, tq, d = q.shape
    dq = torch.empty_like(q)
    _launch("flash_dq", "mxtt_flash_dq", (q, k, v, do, lse, delta, dq),
            (bh, tq, k.shape[1], d), scale, causal)
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal, scale):
    """``(dk, dv)`` for one (q-chunk × k-chunk) pairing, k-major: each
    k row's gradient is summed over the queries by one thread."""
    if not _check("flash_dkv", q, k, v, (do, lse, delta)):
        return flash_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    q, k, v, do, lse, delta = (t.contiguous()
                               for t in (q, k, v, do, lse, delta))
    bh, tq, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_dkv", "mxtt_flash_dkv", (q, k, v, do, lse, delta, dk, dv),
            (bh, tq, k.shape[1], d), scale, causal)
    return dk, dv


class _FlashCore(torch.autograd.Function):
    """``_flash_core`` of the reference: forward ``_fa_kernel``, backward
    ``flash_delta`` + ``_fa_dq_kernel`` + ``_fa_dkv_kernel``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_forward_with_lse(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        delta = flash_delta(out, g)
        dq = flash_dq(q, k, v, g, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_dkv(q, k, v, g, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(query, key, value, causal=False, scale=None):
    """Flash attention over ``(B, T, H, D)`` tensors, differentiable;
    ``scale`` defaults to ``D ** -0.5``."""
    B, T, H, D = query.shape
    Tk = key.shape[1]
    if scale is None:
        scale = D ** -0.5

    def to_bh(x, t):
        return x.transpose(1, 2).reshape(B * H, t, x.shape[-1])

    out = _FlashCore.apply(to_bh(query, T), to_bh(key, Tk),
                           to_bh(value, Tk), bool(causal), float(scale))
    return out.reshape(B, H, T, D).transpose(1, 2)
