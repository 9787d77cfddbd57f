"""Registry and execution of the mxgen generated kernels: the port of
``mxnet_tpu/ops/generated_kernels.py``.

``analysis/codegen.py`` lowers the shipped fusion chains into CUDA C++
text; this module is where that text becomes a kernel on the card:
``register_generated`` builds it with ``nvcc`` (``ops/build.py``),
records the :class:`GeneratedKernel` and auto-declares its
``KERNEL_COSTS`` entry from the chain's modeled byte split, verbatim.

Execution mirrors the reference's two paths:

- :func:`generated_call` — whole arrays, one launch (the Pallas call's
  one grid step): a thread-block cluster on the row plan, one block on
  the group plan (``analysis/codegen.py``); ``()`` externals ride as
  ``(1,)`` buffers;
- :func:`_tiled_call` — flat-tileable chains only: inputs flattened and
  zero-padded to ``grid * block_rows * 128``, one block per
  ``(block_rows, 128)`` tile, outputs sliced back.

The device is the tensors' own: CUDA tensors launch the generated kernel
(a kernel that fails to build or launch raises — there is no fallback),
CPU tensors run the plain PyTorch twin (``codegen.reference_outputs``),
because the caller asked for the CPU.  Every launch adds one to
``LAUNCHES[<kernel name>]`` (:func:`launch_counts`).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..analysis import codegen as cg
from ..analysis.cost import declare_kernel_cost
from ..base import MXNetError, resolve_device

__all__ = ["GENERATED_KERNELS", "GeneratedKernel", "register_generated",
           "generated_call", "build_shipped_generated", "launch_counts",
           "reset_launch_counts", "LAUNCHES"]

GENERATED_KERNELS = {}      # name -> GeneratedKernel
LAUNCHES = {}               # name -> launches since the last reset
_count_lock = threading.Lock()


def launch_counts():
    """``{generated kernel name: launches}`` since the last reset."""
    with _count_lock:
        return dict(LAUNCHES)


def reset_launch_counts():
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name):
    with _count_lock:
        LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


class GeneratedKernel:
    """One generated kernel: the lowered chain's metadata (avals, byte
    contract, equivalence status) and, once built, its library (``fn``)."""

    __slots__ = ("name", "fn", "src", "tag", "rank", "kind", "prims",
                 "n_ops", "in_avals", "out_avals", "bytes_read",
                 "bytes_written", "flops", "transcendentals",
                 "unfused_bytes", "fused_bytes", "bytes_saved",
                 "block_rows", "equivalence_ok", "equivalence_err",
                 "lowered")

    def __init__(self, lk):
        self.name = lk.name
        self.fn = None
        self.src = lk.src
        self.tag = lk.tag
        self.rank = lk.rank
        self.kind = lk.kind
        self.prims = list(lk.prims)
        self.n_ops = lk.n_ops
        self.in_avals = list(lk.in_avals)
        self.out_avals = list(lk.out_avals)
        self.bytes_read = int(lk.bytes_read)
        self.bytes_written = int(lk.bytes_written)
        self.flops = int(lk.flops)
        self.transcendentals = int(lk.transcendentals)
        self.unfused_bytes = int(lk.unfused_bytes)
        self.fused_bytes = int(lk.fused_bytes)
        self.bytes_saved = int(lk.bytes_saved)
        self.block_rows = None
        self.equivalence_ok = False
        self.equivalence_err = None
        self.lowered = lk

    def library(self):
        """The built library (``nvcc`` on first use)."""
        if self.fn is None:
            from .build import load_source
            lib = load_source(self.lowered.symbol, self.src)
            whole = getattr(lib, self.lowered.symbol + "_whole")
            whole.argtypes = [ctypes.c_void_p] * 4
            whole.restype = ctypes.c_int
            if self.lowered.tileable:
                tiled = getattr(lib, self.lowered.symbol + "_tiled")
                tiled.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
                tiled.restype = ctypes.c_int
            self.fn = lib
        return self.fn


def register_generated(lk, device=None):
    """Register a LoweredKernel: build it when ``device`` is CUDA (the
    default: the card, as every entry point of the port; ``"cpu"``
    registers without building), enter it in the registry and
    auto-declare its cost (the chain's fused-byte split, verbatim —
    parity with the fusion pass is an identity).

    The kernel arrives UNPROVEN (``equivalence_ok=False``): callers run
    the equivalence check and mark it, or GEN002 names them."""
    if lk.src is None:
        raise ValueError("chain %r is not lowerable: %s"
                         % (lk.name, [f.rule_id for f in lk.findings]))
    gk = GeneratedKernel(lk)
    if resolve_device(device).type == "cuda":
        gk.library()
    GENERATED_KERNELS[lk.name] = gk
    with _count_lock:
        LAUNCHES.setdefault(lk.name, 0)

    @declare_kernel_cost(lk.name)
    def _cost(eqn, _gk=gk):
        return {"flops": _gk.flops,
                "transcendentals": _gk.transcendentals,
                "bytes_read": _gk.bytes_read,
                "bytes_written": _gk.bytes_written}

    return gk


def _inputs(gk, arrays):
    if len(arrays) != len(gk.in_avals):
        raise MXNetError("%s takes %d inputs, got %d"
                         % (gk.name, len(gk.in_avals), len(arrays)))
    xs = [torch.as_tensor(x) for x in arrays]
    for k, (x, aval) in enumerate(zip(xs, gk.in_avals)):
        if tuple(x.shape) != aval.shape or x.dtype != cg._torch_dtype(
                aval.dtype):
            raise MXNetError("%s input %d: want %s%r, got %s%r"
                             % (gk.name, k, aval.dtype, aval.shape, x.dtype,
                                tuple(x.shape)))
        if x.device != xs[0].device:
            raise MXNetError("%s: every input must be on %s, got %s"
                             % (gk.name, xs[0].device, x.device))
    dev = xs[0].device if xs else torch.device("cpu")
    if dev.type not in ("cuda", "cpu"):
        raise MXNetError("%s: unsupported device %s" % (gk.name, dev))
    return xs, dev


def _empty(aval, shape, dev):
    return torch.empty(shape, dtype=cg._torch_dtype(aval.dtype), device=dev)


def _ptrs(tensors):
    return (ctypes.c_void_p * max(len(tensors), 1))(
        *[t.data_ptr() for t in tensors])


def _launch(gk, fn_name, dev, ins, outs, *args):
    fn = getattr(gk.library(), fn_name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_ptrs(ins), _ptrs(outs), *args, stream)
    if err != 0:
        raise MXNetError("%s kernel launch failed: cudaError %d"
                         % (fn_name, err))
    _count(gk.name)


def generated_call(gk, *arrays, block_rows=None):
    """Run a generated kernel over its external inputs, returning the
    chain's external outputs (in lowered order).

    Default: whole arrays, one launch — valid for every lowered body.
    ``block_rows`` (or the kernel's autotuned choice) row-tiles a
    flat-tileable kernel over ``(block_rows, 128)`` tiles."""
    xs, dev = _inputs(gk, arrays)
    block_rows = block_rows or gk.block_rows
    if block_rows:
        return _tiled_call(gk, xs, int(block_rows))
    if dev.type == "cpu":
        outs = cg.reference_outputs(gk.lowered, xs)
        return [o.contiguous() for o in outs]
    ins = [x.contiguous().reshape(-1) for x in xs]
    outs = [_empty(a, (max(1, cg._numel(a.shape)),), dev)
            for a in gk.out_avals]
    lk = gk.lowered
    ws = None
    if lk.ws_bytes and not lk.ws_shared:
        ws = torch.empty(lk.ws_bytes, dtype=torch.uint8, device=dev)
    _launch(gk, lk.symbol + "_whole", dev, ins, outs,
            None if ws is None else ws.data_ptr())
    return [o.reshape(a.shape) for o, a in zip(outs, gk.out_avals)]


def _tiled_call(gk, arrays, block_rows):
    """The row-tiled path of a flat-tileable kernel: flat inputs
    zero-padded to ``grid * block_rows * 128``, one block per tile;
    padding flows through the elementwise body and is sliced off."""
    if not cg.flat_tileable(gk.lowered):
        raise MXNetError("%s is not flat-tileable (a %s chain): it runs "
                         "whole-array only" % (gk.name, gk.kind))
    xs, dev = _inputs(gk, arrays)
    cols = cg.TILE_COLS
    n = int(gk.in_avals[0].shape[0])
    rows = -(-n // cols)
    grid = max(-(-rows // block_rows), 1)
    padded = grid * block_rows * cols
    if padded >= 2 ** 31:
        raise MXNetError("%s: %d padded elements exceed the kernel's int "
                         "index" % (gk.name, padded))
    ins = []
    for x in xs:
        buf = torch.zeros(padded, dtype=x.dtype, device=dev)
        buf[:n] = x.reshape(-1)
        ins.append(buf)
    if dev.type == "cpu":
        outs = cg.reference_outputs(gk.lowered, ins)
    else:
        outs = [_empty(a, (padded,), dev) for a in gk.out_avals]
        _launch(gk, gk.lowered.symbol + "_tiled", dev, ins, outs, grid,
                block_rows)
    return [o.reshape(-1)[:n] for o in outs]


_SHIPPED = {}               # device type -> [GeneratedKernel]


def build_shipped_generated(autotune=False, device=None):
    """Register the shipped chains as generated kernels (memoized per
    process and device type): build (all ``nvcc`` at once on the card),
    cost declaration, and the equivalence check GEN002 demands, on
    ``device`` (default: the card; off the card the check cannot run and
    the kernels stay unproven).  ``autotune=True`` also picks block
    rows for the flat-tileable ones (seeded, disk-cached — see
    ``analysis.codegen.autotune_block_rows``)."""
    from .build import build_all

    dev = resolve_device(device)
    kernels = _SHIPPED.get(dev.type)
    if kernels is None:
        lowered = [lk for lk in cg.shipped_lowered() if lk.src is not None]
        if dev.type == "cuda":
            build_all((), {lk.symbol: lk.src for lk in lowered})
        kernels = []
        for lk in lowered:
            gk = register_generated(lk, dev)
            ok, err = cg.equivalence_check(lk, dev)
            gk.equivalence_ok = ok is True
            gk.equivalence_err = None if err is None else float(err)
            kernels.append(gk)
        _SHIPPED[dev.type] = kernels
    if autotune:
        for gk in kernels:
            if gk.block_rows is None and cg.flat_tileable(gk.lowered):
                gk.block_rows = cg.autotune_block_rows(gk, device=dev)
    return list(kernels)
