"""Fused LayerNorm: the port of the LN part of
``mxnet_tpu/ops/fused_optimizer.py`` (``fused_layer_norm``, ``:315-392``).

:func:`fused_layer_norm` runs the hand-written CUDA kernel
``csrc/fused_ln.cu`` (the Hopper port of the Pallas ``_fused_ln_kernel``)
for a CUDA tensor, and :func:`layer_norm_reference`, the plain torch
version of the same arithmetic, for a CPU tensor.  The choice follows the
tensor's device and nothing else: a CUDA tensor launches the kernel or
raises — there is no fallback and no switch.

Every launch adds one to ``LAUNCHES["fused_layer_norm"]`` (see
:func:`launch_counts` / :func:`reset_launch_counts`), so a run can show
that its main path went through the kernel.

Forward only: serving needs no gradient, and the backward (``_ln_bwd``,
XLA in the JAX package) waits for the training slice (ROADMAP queue B4).
The fused optimizer kernels of the same JAX module (B1-B3) are not
ported yet.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError

__all__ = ["fused_layer_norm", "layer_norm_reference", "launch_counts",
           "reset_launch_counts", "LAUNCHES"]

LAUNCHES = {"fused_layer_norm": 0}
_count_lock = threading.Lock()


def launch_counts():
    """``{kernel wrapper name: launches}`` since the last reset."""
    with _count_lock:
        return dict(LAUNCHES)


def reset_launch_counts():
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def layer_norm_reference(x, scale, bias, eps=1e-5):
    """The plain version: ``(x - mu) * rsqrt(var + eps) * scale + bias``
    over the last dim, with the centred variance — the Pallas body's
    arithmetic (``fused_optimizer.py:315-322``)."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale + bias


def _ln_lib():
    from .build import load
    lib = load("fused_ln")
    fn = lib.mxtt_fused_ln_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_float,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch_ln(x, scale, bias, eps):
    if x.dtype != torch.float32 or scale.dtype != torch.float32 \
            or bias.dtype != torch.float32:
        raise MXNetError("fused_layer_norm takes float32, got %s/%s/%s"
                         % (x.dtype, scale.dtype, bias.dtype))
    d = x.shape[-1]
    if scale.shape != (d,) or bias.shape != (d,):
        raise MXNetError("scale/bias must be (%d,), got %s/%s"
                         % (d, tuple(scale.shape), tuple(bias.shape)))
    if scale.device != x.device or bias.device != x.device:
        raise MXNetError("x, scale and bias must share one device")
    rows = x.numel() // d if d else 0
    if rows >= 2 ** 31:
        raise MXNetError("fused_layer_norm: %d rows exceed the kernel's "
                         "int32 row index" % rows)
    fn = _ln_lib()
    x2 = x.contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    out = torch.empty_like(x2)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x2.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), rows, d, float(eps), stream)
    if err != 0:
        raise MXNetError("fused_ln kernel launch failed: cudaError %d"
                         % err)
    with _count_lock:
        LAUNCHES["fused_layer_norm"] += 1
    return out


def fused_layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last dim: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Any leading shape."""
    if x.device.type == "cuda":
        return _launch_ln(x, scale, bias, eps)
    if x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps)
    raise MXNetError("fused_layer_norm: unsupported device %s" % x.device)
