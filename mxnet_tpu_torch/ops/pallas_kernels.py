"""The port of ``mxnet_tpu/ops/pallas_kernels.py``: flash attention
(``:51-426``), the int8 matmul with the requantize epilogue
(``:429-584``) and the implicit-GEMM 3×3 convolution with a fused
epilogue (``:587-751``).

Hand-written CUDA kernels, each the Hopper port of a Pallas kernel of
that module:

- :func:`flash_forward_with_lse` (``_fa_kernel``, ``:62``: the attention
  output and the per-row logsumexp), :func:`flash_dq` (``_fa_dq_kernel``,
  ``:171``) and :func:`flash_dkv` (``_fa_dkv_kernel``, ``:226``), each in
  two designs chosen by head dim (:func:`flash_design`): the split-TF32
  ``wgmma`` design (bulk copies, mbarriers; ``mxtt_flash_fwd_wgmma`` in
  ``csrc/flash_fwd_wgmma.cu``, ``mxtt_flash_dq_wgmma`` /
  ``mxtt_flash_dkv_wgmma`` in ``csrc/flash_bwd_wgmma.cu``) for ``D % 4
  == 0``, ``D <= 32`` (dk/dv from D = 12), and the CUDA-core design
  (``mxtt_flash_fwd`` / ``mxtt_flash_dq`` / ``mxtt_flash_dkv``,
  ``csrc/flash_attention.cu``: FMAs, one thread per row) for the rest;
  on bfloat16 operands the bf16 ``wgmma`` design of all three
  (``mxtt_flash_fwd_wgmma_bf16`` / ``mxtt_flash_dq_wgmma_bf16`` /
  ``mxtt_flash_dkv_wgmma_bf16``, ``csrc/flash_bf16_wgmma.cu``: TMA, bf16
  ``wgmma`` with p or ds split into two bf16 parts) for ``D % 8 == 0`` up
  to 32, and the bf16 route of the CUDA-core design
  (``mxtt_flash_fwd_bf16`` / ``mxtt_flash_dq_bf16`` /
  ``mxtt_flash_dkv_bf16``, ``csrc/flash_attention.cu``'s kernels on
  ``__nv_bfloat16``) for the rest;
- :func:`qmm_requant` (``_qmm_requant_kernel``, ``:436``), which the op
  ``_contrib_quantized_conv_requant`` (:func:`quantized_conv_requant`)
  runs for channels-last 1×1 convolutions when ``MXTPU_PALLAS_QMM=1``,
  in two designs chosen by shape (:func:`qmm_design`):
  ``mxtt_qmm_wgmma`` (``csrc/qmm_wgmma.cu``: TMA, mbarriers, ``wgmma``)
  where a TMA tensor map describes the operands, and
  ``mxtt_qmm_requant`` (``csrc/qmm_requant.cu``: ``mma.sync``) for the
  rest;
- :func:`conv3x3_epilogue` (``_conv3x3_kernel``, ``:596``): a 3×3
  stride-1 same-pad NHWC convolution with a per-channel affine epilogue,
  in int8 (requantize), bf16 (folded inference BatchNorm) and float32,
  in two designs chosen by shape (:func:`conv3x3_design`):
  ``mxtt_conv3x3_wgmma`` (``csrc/conv3x3_wgmma.cu``: TMA, mbarriers,
  ``wgmma``) for int8 and bf16 at ``Cin·itemsize % 64 == 0``, and
  ``mxtt_conv3x3_epilogue`` (``csrc/conv3x3_epilogue.cu``: ``mma.sync``
  and FFMA) for the rest.  As in the reference, its entry points are the
  A/B harness (:mod:`mxnet_tpu_torch.tools.conv_ab`) and the tests; no
  op calls it.

:func:`flash_delta` is plain torch, as it is jnp in the reference, and
:func:`flash_attention` over ``(B, T, H, D)`` is a
``torch.autograd.Function`` whose forward is the first kernel and whose
backward is ``flash_delta`` followed by the other two (``_flash_core``,
``:381-406``).

Layout: ``q``/``k``/``v`` are ``(BH, T, D)`` (what ``_to_bhtd`` gives),
``lse`` and ``delta`` plain ``(BH, T)`` float32 — the reference's
``(BH, 8, T)`` sublane broadcast is a TPU tile artifact and is dropped.
``Tq`` and ``Tk`` may differ; in causal mode both are aligned at
position 0.  q, k, v and dO are float32 or bfloat16, all one dtype; the
outputs (out, dq, dk, dv) take that dtype, as the reference's take q's
(``:148``, ``:223``, ``:281-282``), and lse and delta are float32 on
either route.  On bfloat16 each kernel widens its operands to f32 as it
loads them, computes in f32 and rounds each output once; the plain
version is the f32 plain version on the widened inputs, its outputs
rounded the same way; the bf16 ``wgmma`` design keeps the products
exact in f32 by splitting p or ds into bf16 parts.  Any head dim and any
size: the CUDA-core
design takes D above 256 in chunks of 256 (:func:`simt_launch_shape`)
and indexes in 64 bits.

Each wrapper runs its kernel for a CUDA tensor and its plain torch
version (the ``*_reference`` function beside it, the Pallas body's
arithmetic on whole matrices) for a CPU (or shape-only ``meta``) tensor;
a CUDA tensor launches the kernel or raises.  Every launch adds one to
``LAUNCHES[<wrapper>]`` (:func:`launch_counts` /
:func:`reset_launch_counts`).  The op registry entry
``_contrib_flash_attention`` is ROADMAP.md queue A, item 8.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from ..base import MXNetError
from .nn import _CHANNELS_LAST, _tup
from .quantization import _c, int8_conv, int8_dot
from .registry import register

__all__ = ["flash_forward_with_lse", "flash_forward_with_lse_reference",
           "flash_delta", "flash_dq", "flash_dq_reference", "flash_dkv",
           "flash_dkv_reference", "flash_attention", "qmm_requant",
           "qmm_requant_reference", "qmm_design", "quantized_conv_requant",
           "conv3x3_epilogue", "conv3x3_epilogue_reference",
           "conv3x3_design", "flash_design", "wgmma_takes",
           "wgmma_bf16_takes", "FLASH_WGMMA_DIMS",
           "simt_launch_shape", "launch_counts", "reset_launch_counts",
           "LAUNCHES"]

_NEG_INF = -1e30

# the flash kernels count every launch under their own name and under
# their design's ("flash_dq/wgmma", "flash_dq/simt" or, on bfloat16,
# "flash_dq/bf16" or "flash_dq/wgmma_bf16", the same for
# flash_forward_with_lse and flash_dkv);
# qmm_requant under its own name and under its design's
# ("qmm_requant/wgmma" or "qmm_requant/mma");
# conv3x3_epilogue under its own name, under its input route's (e.g.
# "conv3x3_epilogue[int8]") and under its design's
# ("conv3x3_epilogue/wgmma" or "conv3x3_epilogue/mma")
LAUNCHES = {"flash_forward_with_lse": 0, "flash_dq": 0, "flash_dkv": 0,
            "flash_forward_with_lse/wgmma": 0,
            "flash_forward_with_lse/simt": 0,
            "flash_forward_with_lse/bf16": 0, "flash_dq/wgmma": 0,
            "flash_dq/simt": 0, "flash_dq/bf16": 0, "flash_dkv/wgmma": 0,
            "flash_dkv/simt": 0, "flash_dkv/bf16": 0,
            "flash_forward_with_lse/wgmma_bf16": 0,
            "flash_dq/wgmma_bf16": 0, "flash_dkv/wgmma_bf16": 0,
            "qmm_requant": 0, "qmm_requant/wgmma": 0, "qmm_requant/mma": 0,
            "conv3x3_epilogue": 0,
            "conv3x3_epilogue[int8]": 0, "conv3x3_epilogue[bf16]": 0,
            "conv3x3_epilogue[float32]": 0, "conv3x3_epilogue/wgmma": 0,
            "conv3x3_epilogue/mma": 0}
_count_lock = threading.Lock()


def launch_counts():
    """``{kernel wrapper name: launches}`` since the last reset."""
    with _count_lock:
        return dict(LAUNCHES)


def reset_launch_counts():
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(*names):
    with _count_lock:
        for name in names:
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
    ``denom = max(l, 1e-30)``) taken over the whole row at once.  On
    bfloat16 inputs: the same on the widened inputs, ``out`` rounded to
    bfloat16, ``lse`` float32."""
    if q.dtype == torch.bfloat16:
        out, lse = flash_forward_with_lse_reference(
            *(t.float() for t in (q, k, v)), causal, scale)
        return out.to(q.dtype), lse
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
    """Plain ``_fa_dq_kernel``: ``dq = (p (dp - delta)) k * scale``
    (bfloat16 inputs widened, ``dq`` rounded to bfloat16)."""
    if q.dtype == torch.bfloat16:
        return flash_dq_reference(*(t.float() for t in (q, k, v, do)),
                                  lse, delta,
                                  causal, scale).to(q.dtype)
    _, ds = _recompute(q, k, v, do, lse, delta, causal, scale)
    return torch.einsum("bts,bsd->btd", ds, k) * scale


def flash_dkv_reference(q, k, v, do, lse, delta, causal, scale):
    """Plain ``_fa_dkv_kernel``: ``(dk, dv) = (ds^T q * scale, p^T dO)``
    (bfloat16 inputs widened, ``dk``/``dv`` rounded to bfloat16)."""
    if q.dtype == torch.bfloat16:
        dk, dv = flash_dkv_reference(*(t.float() for t in (q, k, v, do)),
                                     lse, delta,
                                     causal, scale)
        return dk.to(k.dtype), dv.to(v.dtype)
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
_ARGTYPES["mxtt_flash_simt_shape"] = [_I, _P]
_ARGTYPES["mxtt_flash_fwd_wgmma"] = _ARGTYPES["mxtt_flash_fwd"]
_ARGTYPES["mxtt_flash_dq_wgmma"] = _ARGTYPES["mxtt_flash_dq"]
_ARGTYPES["mxtt_flash_dkv_wgmma"] = _ARGTYPES["mxtt_flash_dkv"]
for _k in ("fwd", "dq", "dkv"):
    _ARGTYPES["mxtt_flash_%s_bf16" % _k] = _ARGTYPES["mxtt_flash_%s" % _k]
_ARGTYPES["mxtt_flash_fwd_wgmma_bf16"] = _ARGTYPES["mxtt_flash_fwd"]
_ARGTYPES["mxtt_flash_dq_wgmma_bf16"] = _ARGTYPES["mxtt_flash_dq"]
_ARGTYPES["mxtt_flash_dkv_wgmma_bf16"] = _ARGTYPES["mxtt_flash_dkv"]

# wrapper -> the head dims flash_design sends to the wgmma design: those
# where chip_smoke.py's phase 7 timed it faster than the CUDA-core design at
# the ring path's pairings (dk/dv at D = 4 and 8 is faster on CUDA cores,
# which then do a quarter or half of D = 16's work while the wgmma design
# pads to 16; the forward and dq are faster on wgmma at every such D)
FLASH_WGMMA_DIMS = {"flash_forward_with_lse": frozenset(range(4, 33, 4)),
                    "flash_dq": frozenset(range(4, 33, 4)),
                    "flash_dkv": frozenset(range(12, 33, 4))}

# the designs of B5-B7 (two on float32, two on bfloat16): design ->
# wrapper -> (source, C entry point)
_FLASH_DESIGNS = {
    "wgmma": {"flash_forward_with_lse": ("flash_fwd_wgmma",
                                         "mxtt_flash_fwd_wgmma"),
              "flash_dq": ("flash_bwd_wgmma", "mxtt_flash_dq_wgmma"),
              "flash_dkv": ("flash_bwd_wgmma", "mxtt_flash_dkv_wgmma")},
    "simt": {"flash_forward_with_lse": ("flash_attention", "mxtt_flash_fwd"),
             "flash_dq": ("flash_attention", "mxtt_flash_dq"),
             "flash_dkv": ("flash_attention", "mxtt_flash_dkv")},
    "bf16": {"flash_forward_with_lse": ("flash_attention",
                                        "mxtt_flash_fwd_bf16"),
             "flash_dq": ("flash_attention", "mxtt_flash_dq_bf16"),
             "flash_dkv": ("flash_attention", "mxtt_flash_dkv_bf16")},
    "wgmma_bf16": {"flash_forward_with_lse": ("flash_bf16_wgmma",
                                              "mxtt_flash_fwd_wgmma_bf16"),
                   "flash_dq": ("flash_bf16_wgmma",
                                "mxtt_flash_dq_wgmma_bf16"),
                   "flash_dkv": ("flash_bf16_wgmma",
                                 "mxtt_flash_dkv_wgmma_bf16")},
}
_BF16_DESIGNS = ("bf16", "wgmma_bf16")


def _fn(name, source="flash_attention"):
    from .build import load
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def wgmma_takes(d, aligned=True):
    """Whether the wgmma design (``csrc/flash_fwd_wgmma.cu``,
    ``csrc/flash_bwd_wgmma.cu``) takes head dim ``d``: ``D % 4 == 0`` up
    to 32 (a row is whole 16-byte units for the bulk copies; at D = 64 the
    two warpgroups' accumulators and split operands outgrow the
    registers), with 16-byte aligned q, k, v (and dO) (``aligned``)."""
    return 4 <= d <= 32 and d % 4 == 0 and aligned


def wgmma_bf16_takes(d, aligned=True):
    """Whether the bf16 wgmma design (``csrc/flash_bf16_wgmma.cu``) takes
    head dim ``d``: ``D % 8 == 0`` from 8 to 32 (rows of whole 16-byte
    chunks for the TMA boxes; wider rows outgrow the registers), with
    16-byte aligned q, k, v (and dO) (``aligned``: TMA's global
    addresses)."""
    return 8 <= d <= 32 and d % 8 == 0 and aligned


def flash_design(d, wrapper, aligned=True, dtype=torch.float32):
    """The design a card call of ``wrapper`` (``"flash_forward_with_lse"``,
    ``"flash_dq"`` or ``"flash_dkv"``) takes, chosen by operand dtype,
    head dim and alignment before any launch:

    for bfloat16 operands:

    - ``"wgmma_bf16"`` (``csrc/flash_bf16_wgmma.cu``: TMA into an mbarrier
      ring, bf16 ``wgmma`` with p or ds split into two bf16 parts) for all
      three wherever it takes the shape (:func:`wgmma_bf16_takes`):
      chip_smoke.py's phase 17 timed it faster than the CUDA-core bf16
      route at every such head dim (D = 8, 16 — the ring path's —, 24, 32)
      and fails if that stops holding;
    - ``"bf16"`` otherwise: the bf16 route of the CUDA-core design
      (``csrc/flash_attention.cu``'s kernels on ``__nv_bfloat16``,
      ``mxtt_flash_*_bf16``);

    and for float32:

    - ``"wgmma"`` (``csrc/flash_fwd_wgmma.cu``, ``csrc/flash_bwd_wgmma.cu``:
      bulk copies into an mbarrier ring, a producer warpgroup that splits
      each tile into TF32 hi / lo copies, ``wgmma`` .tf32 in three passes)
      where it takes the shape (:func:`wgmma_takes`) and ``d`` is in the
      wrapper's :data:`FLASH_WGMMA_DIMS`, the head dims where it was timed
      faster than the CUDA-core design — the ring path's D = 16 among
      them;
    - ``"simt"`` (``csrc/flash_attention.cu``: CUDA-core FMAs, ``G``
      lanes per row, :func:`simt_launch_shape`) otherwise, among them D =
      64 and 128 and every D above 32."""
    if dtype == torch.bfloat16:
        return "wgmma_bf16" if wgmma_bf16_takes(d, aligned) else "bf16"
    ok = d in FLASH_WGMMA_DIMS[wrapper] and wgmma_takes(d, aligned)
    return "wgmma" if ok else "simt"


# the CUDA-core design's launch shape by head dim (csrc/flash_attention.cu
# shape_of, which mxtt_flash_simt_shape reports): (largest D, padded width,
# lanes per row, rows per shared-memory tile)
_SIMT_SHAPES = ((8, 8, 1, 32), (16, 16, 1, 32), (32, 32, 1, 32),
                (64, 64, 2, 32), (128, 128, 4, 32), (192, 192, 8, 16),
                (256, 256, 8, 16))
_SIMT_THREADS = 128
_SIMT_WIDE = 256


def simt_launch_shape(d):
    """``(padded width, lanes per row, tile rows, chunks, rows per
    block)`` of the CUDA-core design (``csrc/flash_attention.cu``) at head
    dim ``d``: up to 256 one chunk, D padded to the next of 8, 16, 32, 64,
    128, 192, 256 and ``G`` lanes holding a row's ``width / G`` columns;
    above 256 the wide kernels, ``ceil(d / 256)`` chunks of 256, 8 lanes
    a row.  Rows per block are ``128 / G``."""
    if d < 1:
        raise ValueError("head dim %d" % d)
    for top, width, lanes, tile in _SIMT_SHAPES:
        if d <= top:
            return width, lanes, tile, 1, _SIMT_THREADS // lanes
    return _SIMT_WIDE, 8, 16, -(-d // _SIMT_WIDE), _SIMT_THREADS // 8


def _simt_shape_built(d):
    """What the built ``csrc/flash_attention.cu`` reports for head dim
    ``d`` (``mxtt_flash_simt_shape``): ``simt_launch_shape(d)[:4]``."""
    out = (ctypes.c_int * 4)()
    if _fn("mxtt_flash_simt_shape")(int(d), out) != 0:
        raise MXNetError("mxtt_flash_simt_shape refused head dim %d" % d)
    return tuple(out)


def _check(wrapper, q, k, v, rows=()):
    """Validate ``(BH, T, D)`` q/k/v and ``(BH, Tq, ...)`` row operands
    (dO, then lse and delta); True when they live on the card."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise MXNetError("%s takes float32 or bfloat16 q/k/v, got %s"
                         % (wrapper, q.dtype))
    rows = tuple(rows)
    for i, t in enumerate((q, k, v) + rows):
        # dO has q's dtype; lse and delta are float32 on either route
        want = torch.float32 if i >= 4 else q.dtype
        if t.dtype != want:
            raise MXNetError("%s: operand %d is %s, want %s (q is %s)"
                             % (wrapper, i, t.dtype, want, q.dtype))
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
    if d < 1 or max(bh, tq, k.shape[1], d) >= 2 ** 31:
        raise MXNetError("%s: %s / %s: every extent must fit a C int"
                         % (wrapper, tuple(q.shape), tuple(k.shape)))
    return True


def _launch(wrapper, kernel, tensors, dims, scale, causal,
            source="flash_attention", counts=()):
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn(kernel, source)(*(t.data_ptr() for t in tensors), *dims,
                                  float(scale), int(bool(causal)), stream)
    if err != 0:
        raise MXNetError("%s kernel launch failed: cudaError %d"
                         % (kernel, err))
    _count(wrapper, *counts)


def _design_entry(wrapper, tensors, d, design):
    """``(source, C entry point, design)`` of a card call of ``wrapper``:
    :func:`flash_design` of its dtype and head dim, or ``design`` forced
    (raises where the shape or dtype is not the design's)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    dtype = tensors[0].dtype
    if design is None:
        design = flash_design(d, wrapper, aligned, dtype)
    if wrapper not in _FLASH_DESIGNS.get(design, ()) \
            or (design == "wgmma" and not wgmma_takes(d, aligned)) \
            or (design == "wgmma_bf16"
                and not wgmma_bf16_takes(d, aligned)) \
            or (design in _BF16_DESIGNS) != (dtype == torch.bfloat16):
        raise MXNetError("%s: the %r design does not take head dim %d on "
                         "%s (or unaligned operands)"
                         % (wrapper, design, d, dtype))
    return _FLASH_DESIGNS[design][wrapper] + (design,)


def flash_forward_with_lse(q, k, v, causal, scale):
    """``(out, lse)``: attention of ``(BH, Tq, D)`` queries over
    ``(BH, Tk, D)`` keys/values, with ``lse`` ``(BH, Tq)`` float32 — the
    building block of ring attention.  On the card the call goes to one of
    two kernels, :func:`flash_design` of its head dim; both compute the
    same function."""
    return _flash_forward_with_lse(q, k, v, causal, scale)


def _flash_forward_with_lse(q, k, v, causal, scale, design=None):
    """:func:`flash_forward_with_lse`, with ``design`` ("wgmma" or
    "simt" on float32, "wgmma_bf16" or "bf16" on bfloat16) forced instead
    of chosen by head dim, so both designs can be timed on the same
    inputs."""
    if not _check("flash_forward_with_lse", q, k, v):
        return flash_forward_with_lse_reference(q, k, v, causal, scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bh, tq, d = q.shape
    source, entry, design = _design_entry("flash_forward_with_lse",
                                          (q, k, v), d, design)
    out = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    _launch("flash_forward_with_lse", entry, (q, k, v, out, lse),
            (bh, tq, k.shape[1], d), scale, causal, source,
            ("flash_forward_with_lse/" + design,))
    return out, lse


def flash_dq(q, k, v, do, lse, delta, causal, scale):
    """dq for one (q-chunk × k-chunk) pairing; ``lse``/``delta`` are
    ``(BH, Tq)`` float32.  On the card the call goes to one of two
    kernels, :func:`flash_design` of its head dim; both compute the same
    function."""
    return _flash_dq(q, k, v, do, lse, delta, causal, scale)


def _flash_dq(q, k, v, do, lse, delta, causal, scale, design=None):
    """:func:`flash_dq`, with ``design`` ("wgmma" or "simt" on float32,
    "wgmma_bf16" or "bf16" on bfloat16) forced instead of chosen by head
    dim, so both designs can be timed on the same inputs."""
    if not _check("flash_dq", q, k, v, (do, lse, delta)):
        return flash_dq_reference(q, k, v, do, lse, delta, causal, scale)
    q, k, v, do, lse, delta = (t.contiguous()
                               for t in (q, k, v, do, lse, delta))
    bh, tq, d = q.shape
    source, entry, design = _design_entry("flash_dq", (q, k, v, do), d,
                                          design)
    dq = torch.empty_like(q)
    _launch("flash_dq", entry, (q, k, v, do, lse, delta, dq),
            (bh, tq, k.shape[1], d), scale, causal, source,
            ("flash_dq/" + design,))
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal, scale):
    """``(dk, dv)`` for one (q-chunk × k-chunk) pairing, k-major: each
    k row's gradient is summed over the queries in one block, in a fixed
    order.  On the card the call goes to one of two kernels,
    :func:`flash_design` of its head dim."""
    return _flash_dkv(q, k, v, do, lse, delta, causal, scale)


def _flash_dkv(q, k, v, do, lse, delta, causal, scale, design=None):
    """:func:`flash_dkv`, with ``design`` ("wgmma" or "simt" on float32,
    "wgmma_bf16" or "bf16" on bfloat16) forced."""
    if not _check("flash_dkv", q, k, v, (do, lse, delta)):
        return flash_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    q, k, v, do, lse, delta = (t.contiguous()
                               for t in (q, k, v, do, lse, delta))
    bh, tq, d = q.shape
    source, entry, design = _design_entry("flash_dkv", (q, k, v, do), d,
                                          design)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_dkv", entry, (q, k, v, do, lse, delta, dk, dv),
            (bh, tq, k.shape[1], d), scale, causal, source,
            ("flash_dkv/" + design,))
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


# ---------------------------------------------------------------------------
# int8 matmul with the requantize epilogue fused (B8)
# ---------------------------------------------------------------------------
def _requant(acc, scale, bias, relu, out_dtype=torch.int8):
    """The reference's epilogue ``clip(round(relu(f32(acc) * scale +
    bias)), -127, 127)`` -> int8, rounded twice (no FMA) and half to even;
    ``scale`` a Python float taken as float32 or a float32 tensor that
    broadcasts against ``acc`` (per output channel), ``bias`` float32.
    Another ``out_dtype`` is a plain cast of ``relu(f32(acc) * scale +
    bias)``, with no rounding or clipping."""
    if not isinstance(scale, torch.Tensor):
        scale = _c(scale, acc)
    real = acc.to(torch.float32) * scale + bias
    if relu:
        real = torch.clamp_min(real, 0.0)
    if out_dtype != torch.int8:
        return real.to(out_dtype)
    return torch.round(real).clamp(-127, 127).to(torch.int8)


def qmm_requant_reference(x, w, bias, out_scale, relu=True):
    """Plain ``_qmm_requant_kernel``: the int32 sum as an exact float64
    matmul (|acc| <= K * 127**2 < 2**53), converted to float32 as an
    int32 would be, then :func:`_requant`."""
    acc = x.to(torch.float64) @ w.to(torch.float64).t()
    return _requant(acc, out_scale, bias.to(torch.float32), relu)


def _check_qmm(x, w, bias):
    """Validate int8 ``x`` (M, K), int8 ``w`` (N, K) and float32 ``bias``
    (N,); True when they live on the card."""
    if x.dtype != torch.int8 or w.dtype != torch.int8 \
            or bias.dtype != torch.float32:
        raise MXNetError("qmm_requant takes int8 x and w and a float32 bias, "
                         "got %s/%s/%s" % (x.dtype, w.dtype, bias.dtype))
    if x.dim() != 2 or w.dim() != 2 or w.shape[1] != x.shape[1] \
            or tuple(bias.shape) != (w.shape[0],):
        raise MXNetError("qmm_requant takes x (M, K), w (N, K), bias (N,); "
                         "got %s/%s/%s" % (tuple(x.shape), tuple(w.shape),
                                           tuple(bias.shape)))
    for t in (w, bias):
        if t.device != x.device:
            raise MXNetError("qmm_requant: every tensor must be on %s, got "
                             "%s" % (x.device, t.device))
    if x.device.type in ("cpu", "meta"):
        return False
    if x.device.type != "cuda":
        raise MXNetError("qmm_requant: unsupported device %s" % x.device)
    return True


# the two designs of B8: their sources, C entry points and whether the
# entry point takes the vec16 flag
_QMM_DESIGNS = {"wgmma": ("qmm_wgmma", "mxtt_qmm_wgmma", False),
                "mma": ("qmm_requant", "mxtt_qmm_requant", True)}


def qmm_design(k, ldx, aligned=True):
    """The design a card call of :func:`qmm_requant` takes, chosen by
    shape and alignment before any launch:

    - ``"wgmma"`` (``csrc/qmm_wgmma.cu``: TMA boxes of x and w, an
      mbarrier ring, ``wgmma``) where a TMA tensor map can describe the
      operands: ``K % 16 == 0`` (w's row stride), ``ldx % 16 == 0`` (x's)
      and 16-byte aligned ``x`` and ``w`` (``aligned``) — every 1×1
      convolution of ResNet-50;
    - ``"mma"`` (``csrc/qmm_requant.cu``: synchronous staging,
      ``mma.sync``) otherwise, among them K = 70 and 520."""
    ok = k > 0 and k % 16 == 0 and ldx % 16 == 0 and aligned
    return "wgmma" if ok else "mma"


def _qmm_argtypes(vec16):
    """ctypes of (x, ldx, w, bias, out, M, N, K, scale, relu[, vec16],
    stream)."""
    return [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 3 + [ctypes.c_float] \
        + [ctypes.c_int] * (2 if vec16 else 1) + [ctypes.c_void_p]


def _qmm_fn(design):
    from .build import load
    source, symbol, vec16 = _QMM_DESIGNS[design]
    fn = getattr(load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = _qmm_argtypes(vec16)
        fn.restype = ctypes.c_int
    return fn


def qmm_requant(x, w, bias, out_scale, relu=True):
    """int8 ``x`` (M, K) times int8 ``w`` (N, K) transposed -> int8
    (M, N) with the requantize epilogue fused:
    ``clip(round(relu(acc * out_scale + bias)), -127, 127)``.

    ``out_scale`` folds ``s_x * s_w / s_out``; ``bias`` is float32 in the
    output-quantized domain (already divided by ``s_out``).  ``w`` is the
    port's ``(N, K)`` — an ``OHWI`` 1×1 weight reshaped, K contiguous —
    where the reference takes ``(K, N)``.  ``x`` may be a view with a row
    stride (its rows must be contiguous).  On the card the call goes to
    one of two kernels, :func:`qmm_design` of its shape; both compute the
    same function with the same roundings."""
    return _qmm_requant(x, w, bias, out_scale, relu)


def _qmm_requant(x, w, bias, out_scale, relu=True, design=None):
    """:func:`qmm_requant`, with ``design`` ("wgmma" or "mma") forced
    instead of chosen by shape, so both designs can be timed on the same
    inputs; raises where the shape is not the design's."""
    if not _check_qmm(x, w, bias):
        return qmm_requant_reference(x, w, bias, out_scale, relu)
    if x.stride(1) != 1 or x.stride(0) < x.shape[1]:
        x = x.contiguous()
    w, bias = w.contiguous(), bias.contiguous()
    m, k = x.shape
    n = w.shape[0]
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    chosen = qmm_design(k, x.stride(0), aligned)
    design = chosen if design is None else design
    if design not in _QMM_DESIGNS or (design == "wgmma"
                                      and chosen != "wgmma"):
        raise MXNetError("qmm_requant: the %r design does not take x %s "
                         "(row stride %d)" % (design, tuple(x.shape),
                                              x.stride(0)))
    out = torch.empty((m, n), dtype=torch.int8, device=x.device)
    args = [x.data_ptr(), x.stride(0), w.data_ptr(), bias.data_ptr(),
            out.data_ptr(), m, n, k, float(out_scale), int(bool(relu))]
    if design == "mma":
        args.append(int(k % 16 == 0 and x.stride(0) % 16 == 0 and aligned))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _qmm_fn(design)(*args, stream)
    if err != 0:
        raise MXNetError("%s kernel launch failed: cudaError %d"
                         % (_QMM_DESIGNS[design][1], err))
    _count("qmm_requant", "qmm_requant/" + design)
    return out


def _qcr_range(out_scale, lo, hi, like):
    """(min, max) companion outputs so downstream quantized consumers can
    keep reading the (data, min, max) triple ABI."""
    if lo is None:
        hi = float(out_scale) * 127.0
        lo = -hi
    return tuple(torch.full((1,), float(v), dtype=torch.float32,
                            device=like.device) for v in (lo, hi))


@register("_contrib_quantized_conv_requant",
          arg_names=["data", "weight", "bias"], num_outputs=3,
          optional_args=("bias",))
def quantized_conv_requant(data, weight, bias=None, kernel=(), stride=(),
                           dilate=(), pad=(), num_filter=0, num_group=1,
                           layout=None, in_scale=1.0, w_scale=1.0,
                           out_scale=1.0, relu=True,
                           min_calib_range=None, max_calib_range=None):
    """Fused int8 conv + bias + [relu] + requantize -> int8 (the target of
    ``_fuse_conv_requant``).  Scales are real-domain: ``x_real = x_int *
    in_scale`` etc.; output codes are ``round(real / out_scale)``.

    A channels-last 1×1 convolution (strided ones sliced first) is a
    matmul: with ``MXTPU_PALLAS_QMM=1`` it runs :func:`qmm_requant` (B8),
    otherwise :func:`~mxnet_tpu_torch.ops.quantization.int8_dot` and the
    same epilogue in torch.  Every other convolution takes
    :func:`~mxnet_tpu_torch.ops.quantization.int8_conv` and that
    epilogue.  The switch is read on every call (the reference reads it
    when it traces the graph)."""
    nsp = len(kernel) if kernel else data.dim() - 2
    stride = _tup(stride, nsp) if stride else (1,) * nsp
    pad = _tup(pad, nsp) if pad else (0,) * nsp
    x = data.to(torch.int8)
    w = weight.to(torch.int8)
    scale = float(in_scale) * float(w_scale) / float(out_scale)
    if bias is None:
        bias_q = torch.zeros((int(num_filter),), dtype=torch.float32,
                             device=x.device)
    else:
        bias_q = torch.div(bias.to(torch.float32), _c(out_scale, bias))
    rng = _qcr_range(out_scale, min_calib_range, max_calib_range, x)
    channels_last = layout in _CHANNELS_LAST
    if (channels_last and all(k == 1 for k in kernel)
            and int(num_group) == 1 and all(p == 0 for p in pad)):
        if any(s != 1 for s in stride):
            x = x[(slice(None),) + tuple(slice(None, None, s)
                                         for s in stride)]
        sp_shape = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1])
        wf = w.reshape(w.shape[0], w.shape[-1])
        if os.environ.get("MXTPU_PALLAS_QMM", "0") == "1":
            out = qmm_requant(xf, wf, bias_q, scale, relu=relu)
        else:
            out = _requant(int8_dot(xf, wf), scale, bias_q, relu)
        return (out.reshape(sp_shape + (w.shape[0],)),) + rng
    acc = int8_conv(x, w, kernel, stride, dilate, pad, num_group, layout)
    bshape = (1,) * (acc.dim() - 1) + (-1,) if channels_last \
        else (1, -1) + (1,) * nsp
    return (_requant(acc, scale, bias_q.reshape(bshape), relu),) + rng


# ---------------------------------------------------------------------------
# implicit-GEMM 3x3 convolution with a fused affine epilogue (B9)
# ---------------------------------------------------------------------------
# input dtype -> the route's name in LAUNCHES and the kernel's type code
_CONV_ROUTES = {torch.int8: ("int8", 0), torch.bfloat16: ("bf16", 1),
                torch.float32: ("float32", 2)}
# output dtype -> the kernel's type code
_CONV_OUTS = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def conv3x3_epilogue_reference(x, w, scale, shift, relu=True,
                               out_dtype=None):
    """Plain ``_conv3x3_kernel``: zero-pad H and W by one, the
    ``(N·H·W, 9·Cin)`` im2col in (dy, dx, c) order, a float64 matmul by
    ``w.reshape(9·Cin, Cout)`` (exact for int8, |acc| <= 9·Cin·127² <
    2³¹, and for bf16 products), converted to float32, then the epilogue
    of :func:`_requant`.  ``scale``/``shift`` are float32 ``(Cout,)``
    tensors on ``x``'s device."""
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    xp = torch.nn.functional.pad(x.to(torch.float64), (0, 0, 1, 1, 1, 1))
    col = torch.cat([xp[:, dy:dy + h, dx:dx + wd, :]
                     for dy in range(3) for dx in range(3)], dim=-1)
    acc = col.reshape(-1, 9 * cin) @ w.to(torch.float64).reshape(9 * cin,
                                                                  cout)
    del xp, col
    return _requant(acc.reshape(n, h, wd, cout), scale, shift, relu,
                    x.dtype if out_dtype is None else out_dtype)


def _channel_vector(v, x, cout, what):
    """``v`` (a numpy array, list or tensor of ``(Cout,)``) as float32 on
    ``x``'s device."""
    t = torch.as_tensor(v, dtype=torch.float32, device=x.device)
    if tuple(t.shape) != (cout,):
        raise MXNetError("conv3x3_epilogue: %s must be (Cout,) = (%d,), got "
                         "%s" % (what, cout, tuple(t.shape)))
    return t.contiguous()


def _check_conv(x, w, out_dtype):
    """Validate NHWC ``x`` and HWIO ``w``; True when they live on the
    card."""
    if x.dtype not in _CONV_ROUTES or w.dtype != x.dtype:
        raise MXNetError("conv3x3_epilogue takes int8, bfloat16 or float32 "
                         "x and w of one dtype, got %s/%s"
                         % (x.dtype, w.dtype))
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (
            3, 3, x.shape[-1]):
        raise MXNetError("conv3x3_epilogue takes x (N, H, W, Cin) and w "
                         "(3, 3, Cin, Cout), got %s/%s"
                         % (tuple(x.shape), tuple(w.shape)))
    if w.device != x.device:
        raise MXNetError("conv3x3_epilogue: w must be on %s, got %s"
                         % (x.device, w.device))
    if x.device.type in ("cpu", "meta"):
        return False
    if x.device.type != "cuda":
        raise MXNetError("conv3x3_epilogue: unsupported device %s"
                         % x.device)
    if out_dtype not in _CONV_OUTS:
        raise MXNetError("conv3x3_epilogue: the kernel writes %s, not %s"
                         % (sorted(str(d) for d in _CONV_OUTS), out_dtype))
    n, h, wd, cin = x.shape
    if n * h * wd >= 2 ** 31 or 9 * cin >= 2 ** 31:
        raise MXNetError("conv3x3_epilogue: %s exceeds the kernel's int32 "
                         "sizes" % (tuple(x.shape),))
    return True


# the two designs of B9: their sources and C entry points
_CONV_DESIGNS = {"wgmma": ("conv3x3_wgmma", "mxtt_conv3x3_wgmma"),
                 "mma": ("conv3x3_epilogue", "mxtt_conv3x3_epilogue")}


def conv3x3_design(cin, dtype, aligned=True):
    """The design a card call of :func:`conv3x3_epilogue` takes, chosen
    by shape, dtype and alignment before any launch:

    - ``"wgmma"`` (``csrc/conv3x3_wgmma.cu``: TMA im2col patch tiles,
      TMA weight boxes, an mbarrier ring, ``wgmma``) for int8 and
      bfloat16 when a tap's channels are whole 64-byte slices
      (``Cin·itemsize % 64 == 0``: an im2col box carries 64 or 128
      channel bytes, one row of the 64- or 128-byte swizzle that
      ``wgmma`` reads, in steps of its 32-byte depth) and ``x`` is
      16-byte aligned (``aligned``; the repacked weight always is);
    - ``"mma"`` (``csrc/conv3x3_epilogue.cu``: synchronous staging,
      ``mma.sync``) otherwise, among them Cin 3, int8 Cin 8-48, bfloat16
      Cin 8-24 and every float32 call (FFMA, never TF32)."""
    if dtype not in (torch.int8, torch.bfloat16) or not aligned:
        return "mma"
    return "wgmma" if cin * dtype.itemsize % 64 == 0 else "mma"


def _conv_fn(design):
    from .build import load
    source, symbol = _CONV_DESIGNS[design]
    fn = getattr(load(source), symbol)
    if fn.argtypes is None:
        # (x, w, scale, shift, out, N, H, W, Cin, Cout, in_type, out_type,
        #  relu[, vec16], stream)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (
            8 if design == "wgmma" else 9) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def conv3x3_epilogue(x, w, scale, shift, relu=True, out_dtype=None):
    """3×3 stride-1 same-pad NHWC convolution with a fused affine
    epilogue: ``out = cast(relu(conv(x, w) * scale + shift))``.

    - int8 ``x``/``w``: exact int32 sums; ``scale`` folds the requantize
      (s_x·s_w/s_out), ``shift`` the bias; the default output is int8,
      rounded half to even and clipped to ±127.
    - bfloat16 ``x``/``w``: float32 sums; ``scale``/``shift`` fold
      inference BatchNorm; the default output is bfloat16.
    - float32 ``x``/``w``: float32 sums on CUDA cores (no TF32).

    Rounding and clipping happen only for an int8 output; any other
    ``out_dtype`` is a plain cast.  ``x`` is (N, H, W, Cin), ``w`` (3, 3,
    Cin, Cout) HWIO, ``scale``/``shift`` (Cout,) numpy arrays or tensors,
    taken as float32 on ``x``'s device.  On the card the call goes to one
    of two kernels, :func:`conv3x3_design` of its shape; both compute the
    same function with the same roundings.

    The reference's tile arguments (``nb``, ``th``, ``tn``), its
    ``interpret`` switch and its VMEM budget size TPU VMEM tiles and have
    no meaning here: the kernels' tiles are fixed and ragged shapes are
    masked inside them, so ``x`` and ``w`` are never padded in memory.
    The kernels read ``w`` as ``(Cout, 9·Cin)``, repacked on each call."""
    return _conv3x3_epilogue(x, w, scale, shift, relu, out_dtype)


def _conv3x3_epilogue(x, w, scale, shift, relu=True, out_dtype=None,
                      design=None):
    """:func:`conv3x3_epilogue`, with ``design`` ("wgmma" or "mma")
    forced instead of chosen by shape, so both designs can be timed on
    the same inputs; raises where the shape is not the design's."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    on_card = _check_conv(x, w, out_dtype)
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    scale = _channel_vector(scale, x, cout, "scale")
    shift = _channel_vector(shift, x, cout, "shift")
    if not on_card:
        return conv3x3_epilogue_reference(x, w, scale, shift, relu,
                                          out_dtype)
    x = x.contiguous()
    chosen = conv3x3_design(cin, x.dtype, x.data_ptr() % 16 == 0)
    design = chosen if design is None else design
    if design not in _CONV_DESIGNS or (design == "wgmma"
                                       and chosen != "wgmma"):
        raise MXNetError("conv3x3_epilogue: the %r design does not take "
                         "%s %s" % (design, x.dtype, tuple(x.shape)))
    wk = w.permute(3, 0, 1, 2).contiguous()     # (Cout, 3, 3, Cin)
    out = torch.empty((n, h, wd, cout), dtype=out_dtype, device=x.device)
    route, in_code = _CONV_ROUTES[x.dtype]
    args = [x.data_ptr(), wk.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), n, h, wd, cin, cout, in_code,
            _CONV_OUTS[out_dtype], int(bool(relu))]
    if design == "mma":
        args.append(int(cin * x.element_size() % 16 == 0
                        and x.data_ptr() % 16 == 0
                        and wk.data_ptr() % 16 == 0))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _conv_fn(design)(*args, stream)
    if err != 0:
        raise MXNetError("%s kernel launch failed: cudaError %d"
                         % (_CONV_DESIGNS[design][1], err))
    _count("conv3x3_epilogue", "conv3x3_epilogue[%s]" % route,
           "conv3x3_epilogue/%s" % design)
    return out
