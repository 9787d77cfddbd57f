"""Fused optimizer updates and the fused LayerNorm: the port of
``mxnet_tpu/ops/fused_optimizer.py``.

Four hand-written CUDA kernels, each the Hopper port of a Pallas kernel
of that module:

- :func:`fused_sgd` → ``csrc/fused_optimizer.cu`` ``mxtt_fused_sgd``
  (``_fused_sgd_kernel``, ``:141``);
- :func:`fused_sgd_momentum` → ``mxtt_fused_sgd_mom``
  (``_fused_sgd_mom_kernel``, ``:151``);
- :func:`fused_adam` → ``mxtt_fused_adam`` (``_fused_adam_kernel``,
  ``:165``);
- :func:`fused_layer_norm` → ``csrc/fused_ln.cu`` (``_fused_ln_kernel``,
  ``:315``) for the forward; a ``torch.autograd.Function`` whose backward
  is the reference's ``_ln_bwd`` (``:367-382``, XLA there) in plain torch.

Each wrapper runs its kernel for a CUDA tensor and its plain torch
version (the ``*_reference`` function beside it, the same arithmetic in
the same order) for a CPU tensor.  The choice follows the tensor's device
and nothing else: a CUDA tensor launches the kernel or raises — there is
no fallback and no switch.  The optimizer updates work in place on both
devices, as the Pallas kernels alias their outputs to ``w``/``m``/``v``:
the wrapper writes the new values into the tensors it was given and
returns them.

Every launch adds one to ``LAUNCHES[<wrapper name>]`` (see
:func:`launch_counts` / :func:`reset_launch_counts`), so a run can show
that its main path went through the kernels.

The optimizer kernels take the scalars ``[lr, inv_scale, ok]`` as a
3-float tensor on the device (the counterpart of the SMEM operand):
``inv_scale`` unscales the gradient before the clip, and ``ok == 0``
writes the old values back, so a loss-scale-skipped step is a bitwise
no-op.  The f32 path passes ``inv_scale=1, ok=1``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError

__all__ = ["supports", "fused_sgd", "fused_sgd_momentum", "fused_adam",
           "fused_sgd_reference", "fused_sgd_momentum_reference",
           "fused_adam_reference", "fused_optimizer_update",
           "fused_layer_norm", "layer_norm_reference", "LN_PARTS",
           "ln_shipped_parts", "launch_counts",
           "reset_launch_counts", "LAUNCHES"]

LAUNCHES = {"fused_layer_norm": 0, "fused_sgd": 0, "fused_sgd_momentum": 0,
            "fused_adam": 0}
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


def supports(opt):
    """``"sgd"`` / ``"adam"`` when ``opt`` is EXACTLY the registered SGD
    or Adam optimizer (a subclass may override ``update`` and must keep
    the unfused path), else None."""
    from ..optimizer import SGD, Adam
    if type(opt) is SGD:
        return "sgd"
    if type(opt) is Adam:
        return "adam"
    return None


# ---------------------------------------------------------------------------
# the optimizer updates: plain versions (the Pallas bodies' arithmetic)
# ---------------------------------------------------------------------------
def _scalars(lr, inv_scale, ok, device):
    """The 3-float ``[lr, inv_scale, ok]`` tensor on ``device``; each entry
    may be a python number or a 0-dim tensor (a device-computed flag)."""
    parts = (lr, inv_scale, ok)
    if not any(isinstance(s, torch.Tensor) for s in parts):
        host = [float(s) for s in parts]
        if device.type != "cuda":
            return torch.tensor(host, dtype=torch.float32, device=device)
        # pinned, so the copy is queued on the stream and the host does
        # not wait for the work before it (the backward) to finish
        return torch.tensor(host, dtype=torch.float32,
                            pin_memory=True).to(device, non_blocking=True)
    # a python number becomes a fill kernel, not a host copy, so a step
    # with device-computed flags never waits on the card here
    return torch.stack([
        s.to(device=device, dtype=torch.float32).reshape(())
        if isinstance(s, torch.Tensor)
        else torch.full((), float(s), dtype=torch.float32, device=device)
        for s in parts])


def _prep_g(g, inv_scale, rescale_grad, clip_gradient):
    g = (rescale_grad * inv_scale) * g
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def fused_sgd_reference(w, g, scalars, *, wd=0.0, rescale_grad=1.0,
                        clip_gradient=None):
    """Plain version of ``_fused_sgd_kernel``: the new ``w``."""
    lr, inv_scale, ok = scalars[0], scalars[1], scalars[2]
    gg = _prep_g(g, inv_scale, rescale_grad, clip_gradient)
    return torch.where(ok > 0.0, (1.0 - lr * wd) * w - lr * gg, w)


def fused_sgd_momentum_reference(w, g, m, scalars, *, momentum, wd=0.0,
                                 rescale_grad=1.0, clip_gradient=None):
    """Plain version of ``_fused_sgd_mom_kernel``: ``(new_w, new_m)``."""
    lr, inv_scale, ok = scalars[0], scalars[1], scalars[2]
    gg = _prep_g(g, inv_scale, rescale_grad, clip_gradient)
    new_m = momentum * m - lr * wd * w - lr * gg
    okb = ok > 0.0
    return torch.where(okb, w + new_m, w), torch.where(okb, new_m, m)


def fused_adam_reference(w, g, m, v, scalars, *, beta1, beta2, epsilon,
                         wd=0.0, rescale_grad=1.0, clip_gradient=None):
    """Plain version of ``_fused_adam_kernel`` (``scalars[0]`` is the
    bias-corrected ``lr_t``): ``(new_w, new_m, new_v)``."""
    lr_t, inv_scale, ok = scalars[0], scalars[1], scalars[2]
    gg = (rescale_grad * inv_scale) * g + wd * w
    if clip_gradient is not None and clip_gradient >= 0:
        gg = torch.clamp(gg, -clip_gradient, clip_gradient)
    new_m = beta1 * m + (1.0 - beta1) * gg
    new_v = beta2 * v + (1.0 - beta2) * torch.square(gg)
    okb = ok > 0.0
    return (torch.where(okb, w - lr_t * new_m / (torch.sqrt(new_v)
                                                 + epsilon), w),
            torch.where(okb, new_m, m), torch.where(okb, new_v, v))


# ---------------------------------------------------------------------------
# the optimizer updates: the CUDA kernels
# ---------------------------------------------------------------------------
_OPT_ARGTYPES = {
    # (w, g, n, s, wd, rescale, clip, stream)
    "mxtt_fused_sgd": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p] + [ctypes.c_float] * 3
                      + [ctypes.c_void_p],
    # (w, g, m, n, s, momentum, wd, rescale, clip, stream)
    "mxtt_fused_sgd_mom": [ctypes.c_void_p] * 3
                          + [ctypes.c_longlong, ctypes.c_void_p]
                          + [ctypes.c_float] * 4 + [ctypes.c_void_p],
    # (w, g, m, v, n, s, beta1, beta2, 1-beta1, 1-beta2, eps, wd,
    #  rescale, clip, stream)
    "mxtt_fused_adam": [ctypes.c_void_p] * 4
                       + [ctypes.c_longlong, ctypes.c_void_p]
                       + [ctypes.c_float] * 8 + [ctypes.c_void_p],
}


def _opt_fn(name):
    from .build import load
    fn = getattr(load("fused_optimizer"), name)
    if fn.argtypes is None:
        fn.argtypes = _OPT_ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_flat(wrapper, arrays):
    w = arrays[0]
    for a in arrays:
        if a.dtype != torch.float32:
            raise MXNetError("%s takes float32, got %s" % (wrapper, a.dtype))
        if a.device != w.device:
            raise MXNetError("%s: every tensor must be on %s, got %s"
                             % (wrapper, w.device, a.device))
        if a.numel() != w.numel():
            raise MXNetError("%s: %d elements against %d"
                             % (wrapper, a.numel(), w.numel()))
        if not a.is_contiguous():
            raise MXNetError("%s updates in place and needs contiguous "
                             "tensors" % wrapper)


def _clip_arg(clip_gradient):
    return -1.0 if clip_gradient is None else float(clip_gradient)


def _launch(wrapper, kernel, arrays, scalars, floats):
    n = arrays[0].numel()
    if n == 0:
        return
    fn = _opt_fn(kernel)
    dev = arrays[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(a.data_ptr() for a in arrays), n, scalars.data_ptr(),
                 *floats, stream)
    if err != 0:
        raise MXNetError("%s kernel launch failed: cudaError %d"
                         % (kernel, err))
    _count(wrapper)


def _on_device(wrapper, t):
    if t.device.type not in ("cuda", "cpu"):
        raise MXNetError("%s: unsupported device %s" % (wrapper, t.device))
    return t.device.type == "cuda"


def fused_sgd(w, g, lr, *, wd=0.0, rescale_grad=1.0, clip_gradient=None,
              inv_scale=1.0, ok=1.0):
    """Plain SGD over a flat f32 space as one pass, in place: returns
    ``w`` holding the new weights."""
    _check_flat("fused_sgd", (w, g))
    s = _scalars(lr, inv_scale, ok, w.device)
    if _on_device("fused_sgd", w):
        _launch("fused_sgd", "mxtt_fused_sgd", (w, g), s,
                (float(wd), float(rescale_grad), _clip_arg(clip_gradient)))
        return w
    with torch.no_grad():
        w.copy_(fused_sgd_reference(w, g, s, wd=wd,
                                    rescale_grad=rescale_grad,
                                    clip_gradient=clip_gradient))
    return w


def fused_sgd_momentum(w, g, m, lr, *, momentum, wd=0.0, rescale_grad=1.0,
                       clip_gradient=None, inv_scale=1.0, ok=1.0):
    """SGD+momentum over a flat f32 space as one pass, in place: returns
    ``(w, m)`` holding the new values, elementwise ``nd.sgd_mom_update``."""
    _check_flat("fused_sgd_momentum", (w, g, m))
    s = _scalars(lr, inv_scale, ok, w.device)
    if _on_device("fused_sgd_momentum", w):
        _launch("fused_sgd_momentum", "mxtt_fused_sgd_mom", (w, g, m), s,
                (float(momentum), float(wd), float(rescale_grad),
                 _clip_arg(clip_gradient)))
        return w, m
    nw, nm = fused_sgd_momentum_reference(
        w, g, m, s, momentum=momentum, wd=wd, rescale_grad=rescale_grad,
        clip_gradient=clip_gradient)
    with torch.no_grad():
        w.copy_(nw)
        m.copy_(nm)
    return w, m


def fused_adam(w, g, m, v, lr_t, *, beta1, beta2, epsilon, wd=0.0,
               rescale_grad=1.0, clip_gradient=None, inv_scale=1.0, ok=1.0):
    """Adam over a flat f32 space as one pass, in place: returns
    ``(w, m, v)``; ``lr_t`` is the bias-corrected rate."""
    _check_flat("fused_adam", (w, g, m, v))
    s = _scalars(lr_t, inv_scale, ok, w.device)
    if _on_device("fused_adam", w):
        # 1 - beta in double, then f32: the Pallas body's python-float
        # constants (fused_optimizer.py:180-181)
        _launch("fused_adam", "mxtt_fused_adam", (w, g, m, v), s,
                (float(beta1), float(beta2), float(1.0 - beta1),
                 float(1.0 - beta2), float(epsilon), float(wd),
                 float(rescale_grad), _clip_arg(clip_gradient)))
        return w, m, v
    nw, nm, nv = fused_adam_reference(
        w, g, m, v, s, beta1=beta1, beta2=beta2, epsilon=epsilon, wd=wd,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    with torch.no_grad():
        w.copy_(nw)
        m.copy_(nm)
        v.copy_(nv)
    return w, m, v


def fused_optimizer_update(opt, index, w_flat, g_flat, state, lr, t,
                           inv_scale=1.0, ok=1.0):
    """Fused twin of ``parallel.functional.functional_optimizer_update``
    for the flat f32 space, with the reference's lr/wd-mult resolution
    (``fused_optimizer.py:264-309``) and Adam's bias-corrected rate
    computed on the host.  Updates ``w_flat`` and the state in place and
    returns ``(w_flat, state)``.  ``supports(opt)`` must be truthy."""
    kind = supports(opt)
    if kind is None:
        raise ValueError("fused update supports SGD/Adam exactly; got %s"
                         % type(opt).__name__)
    wd = opt._get_wd(index)
    if index in opt.param_dict:
        lmult = opt.param_dict[index].lr_mult
    elif index in opt.lr_mult:
        lmult = opt.lr_mult[index]
    elif index in opt.idx2name:
        lmult = opt.lr_mult.get(opt.idx2name[index], 1.0)
    else:
        lmult = 1.0
    lr = lr * lmult if lmult != 1.0 else lr
    common = dict(wd=wd, rescale_grad=opt.rescale_grad,
                  clip_gradient=opt.clip_gradient, inv_scale=inv_scale,
                  ok=ok)
    if kind == "sgd":
        if state is None:
            return fused_sgd(w_flat, g_flat, lr, **common), None
        nw, nm = fused_sgd_momentum(w_flat, g_flat, state, lr,
                                    momentum=opt.momentum, **common)
        return nw, nm
    m, v = state
    lr_t = lr * ((1 - opt.beta2 ** t) ** 0.5) / (1 - opt.beta1 ** t)
    nw, nm, nv = fused_adam(w_flat, g_flat, m, v, lr_t, beta1=opt.beta1,
                            beta2=opt.beta2, epsilon=opt.epsilon, **common)
    return nw, (nm, nv)


# ---------------------------------------------------------------------------
# fused LayerNorm: the kernel forward, the reference's backward
# ---------------------------------------------------------------------------
def layer_norm_reference(x, scale, bias, eps=1e-5):
    """The plain version: ``(x - mu) * rsqrt(var + eps) * scale + bias``
    over the last dim, with the centred variance — the Pallas body's
    arithmetic (``fused_optimizer.py:315-322``)."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale + bias


# the parts of csrc/fused_ln.cu's design, each a bit of the kernel's
# ``parts``; the main path runs the set the source ships
# (``mxtt_fused_ln_shipped_parts``), the others are for measurement
LN_PARTS = {"early_params": 1, "vec4": 2, "merge": 4, "row_warps": 8}


def _ln_lib():
    from .build import load
    lib = load("fused_ln")
    if lib.mxtt_fused_ln_forward.argtypes is None:
        args = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_float, ctypes.c_void_p]
        lib.mxtt_fused_ln_forward_parts.argtypes = args + [ctypes.c_int]
        for fn in (lib.mxtt_fused_ln_forward,
                   lib.mxtt_fused_ln_forward_parts,
                   lib.mxtt_fused_ln_shipped_parts):
            fn.restype = ctypes.c_int
        lib.mxtt_fused_ln_forward.argtypes = args    # last: marks it done
    return lib


def ln_shipped_parts():
    """The names of the parts of ``csrc/fused_ln.cu``'s design that the
    main path runs (builds the kernel)."""
    bits = _ln_lib().mxtt_fused_ln_shipped_parts()
    return sorted(k for k, b in LN_PARTS.items() if bits & b)


def _launch_ln(x, scale, bias, eps, parts=None):
    """The kernel on CUDA tensors.  ``parts`` (names of ``LN_PARTS``)
    runs another set of the design's parts than the shipped one, for
    measurement only: such a launch is not counted."""
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
    lib = _ln_lib()
    x2 = x.contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    out = torch.empty_like(x2)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x2.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                out.data_ptr(), rows, d, float(eps), stream)
        if parts is None:
            err = lib.mxtt_fused_ln_forward(*args)
        else:
            err = lib.mxtt_fused_ln_forward_parts(
                *args, sum(LN_PARTS[p] for p in set(parts)))
    if err != 0:
        raise MXNetError("fused_ln kernel launch failed: cudaError %d"
                         % err)
    if parts is None:
        _count("fused_layer_norm")
    return out


def _fused_layer_norm_parts(x, scale, bias, parts, eps=1e-5):
    """The LayerNorm forward kernel with only ``parts`` (names of
    ``LN_PARTS``) of its design; no part is the design it replaced (one
    warp a row, lanes strided over single columns, eight warps a block,
    the parameters loaded after the two trees).  CUDA tensors only, not
    counted: ``tools/ln_ablate.py`` and ``chip_smoke.py`` time these
    against the shipped set."""
    unknown = set(parts) - set(LN_PARTS)
    if unknown:
        raise MXNetError("fused_ln: no part %s (%s)"
                         % (sorted(unknown), sorted(LN_PARTS)))
    if x.device.type != "cuda":
        raise MXNetError("the fused_ln variants run on the card only")
    return _launch_ln(x, scale, bias, float(eps), parts=tuple(parts))


def _ln_bwd(x, scale, g, eps):
    """``(dx, dscale, dbias)``: the reference's ``_ln_bwd``
    (``fused_optimizer.py:367-382``), recomputing mean and rstd from
    ``x`` (the forward saves no statistics), ``dscale``/``dbias`` summed
    over every leading dim."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = xc * rstd
    red = tuple(range(x.dim() - 1))
    dbias = g.sum(dim=red)
    dscale = (g * xhat).sum(dim=red)
    dxhat = g * scale
    dx = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return dx, dscale, dbias


class _LayerNorm(torch.autograd.Function):
    """``_ln_core`` of the reference: the kernel (or its plain version on
    the CPU) forward, saving ``(x, scale)`` only."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if x.device.type == "cuda":
            return _launch_ln(x, scale, bias, eps)
        return layer_norm_reference(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = _ln_bwd(x, scale, g, ctx.eps)
        return dx, dscale, dbias, None


def fused_layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last dim, differentiable: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor, and the reference's
    backward on either.  Any leading shape."""
    if x.device.type not in ("cuda", "cpu"):
        raise MXNetError("fused_layer_norm: unsupported device %s"
                         % x.device)
    return _LayerNorm.apply(x, scale, bias, float(eps))
