"""What holds the wgmma design of ``conv3x3_epilogue`` (B9) back: the
kernel rebuilt with one part switched off at a time and timed at the
conv A/B harness's four stages.

    python -m mxnet_tpu_torch.tools.conv_ablate [--batch 256] [--iters 20]
        [--dtypes int8 bf16]

Each variant is ``csrc/conv3x3_wgmma.cu`` with textual edits (:data:`CUTS`),
built through ``ops.build.load_source`` like an emitted kernel:

- ``full``: the source as it is;
- ``no_a``: no patch-tile (im2col) loads, the ring's barriers still run;
- ``no_b``: no weight-tile loads (nor the resident weight slice);
- ``no_loads``: neither;
- ``no_mma``: no ``wgmma``;
- ``no_epilogue``: no epilogue math, staging or output stores.

A variant's outputs are wrong by design, so only its device time is
printed: CUDA events around ``--iters`` calls of the C entry point (after
one warm-up), on the harness's seeded inputs, the weight repacked once
outside the timing.  One JSON line per (variant, dtype, stage) and one
per (variant, dtype) pass; :func:`main` also returns the records.  A time
that drops when a part is cut says that part holds the kernel back.  The
card is required.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from ..base import MXNetError, resolve_device
from ..ops import build
from ..ops.pallas_kernels import _CONV_OUTS, _CONV_ROUTES
from .conv_ab import STAGES

__all__ = ["CUTS", "variant_source", "edited_source", "device_ms", "main"]

_EXPECT = "        mbar_expect_tx(bar, stage);\n"
_LOAD_A = ("        tma_load_im2col(a, &xmap, bar, c, w - 1, h - 1, n, "
           "tap % 3, tap / 3);\n")
_LOAD_B = ("        if (!resident)\n"
           "          tma_load_2d(a + A_BYTES, &wmap, bar, tap * kpt + c, "
           "n0);\n")
_RESIDENT = "      mbar_expect_tx(bar, nk * B_BYTES);\n"
_MMA = "        Mma<INT8, BN>::run(acc,"
_EPILOGUE = "    const float* const sc = vec + (i & 1) * 2 * BN;\n"
_STORES = "      for (int q = t; q < BM * chunks; q += 128) {\n"

# variant -> [(text in the source, its replacement)]
_NO_A = [(_EXPECT + _LOAD_A,
          "        mbar_expect_tx(bar, stage - A_BYTES);\n")]
_NO_B = [(_EXPECT, "        mbar_expect_tx(bar, A_BYTES);\n"),
         (_LOAD_B, ""),
         (_RESIDENT, "      mbar_arrive(bar);\n      if (0)\n")]
CUTS = {
    "full": [],
    "no_a": _NO_A,
    "no_b": _NO_B,
    "no_loads": [(_EXPECT + _LOAD_A + _LOAD_B,
                  "        mbar_arrive(bar);\n"),
                 (_RESIDENT, "      mbar_arrive(bar);\n      if (0)\n")],
    "no_mma": [(_MMA, "        if (0) Mma<INT8, BN>::run(acc,")],
    "no_epilogue": [(_EPILOGUE, "    if (acc[0] == Acc(12345)) "
                     "*static_cast<int*>(out) = 1;\n"
                     "    mbar_arrive(smem_u32(&out_full));\n"
                     "    continue;\n" + _EPILOGUE),
                    (_STORES, "      if (0)\n" + _STORES)],
}


def edited_source(source, edits, variant):
    """``csrc/<source>.cu`` with ``edits`` (``[(text, replacement)]``)
    applied; raises if a text is not in the source exactly once."""
    with open(build.source_path(source), encoding="utf-8") as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise MXNetError("ablation %s: the text %r is in %s.cu %d "
                             "times, want once"
                             % (variant, old[:60], source, src.count(old)))
        src = src.replace(old, new)
    return src


def variant_source(name):
    """``csrc/conv3x3_wgmma.cu`` with the edits of variant ``name``."""
    return edited_source("conv3x3_wgmma", CUTS[name], name)


def device_ms(fn, call, iters, dev, what):
    """Device time of one ``fn(*call)`` of a C entry point: CUDA events
    around ``iters`` calls after one warm-up; raises on a cudaError."""
    err = fn(*call)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        err = err or fn(*call)
    end.record()
    torch.cuda.synchronize(dev)
    if err:
        raise MXNetError("%s: cudaError %d" % (what, err))
    return start.elapsed_time(end) / iters


def _fn(name):
    lib = build.load_source("conv3x3_ablate_" + name, variant_source(name))
    fn = lib.mxtt_conv3x3_wgmma
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _inputs(rng, dtype, n, h, w, c, dev):
    """The conv A/B harness's seeded inputs of one stage, in its order."""
    def put(a, t):
        return torch.as_tensor(a, device=dev).to(t)
    if dtype == "int8":
        x = put(rng.randint(-127, 128, (n, h, w, c)), torch.int8)
        wt = put(rng.randint(-16, 16, (3, 3, c, c)), torch.int8)
        scale = put(rng.rand(c) * 0.01 + 1e-3, torch.float32)
    else:
        x = put(rng.randn(n, h, w, c), torch.bfloat16)
        wt = put(rng.randn(3, 3, c, c) * 0.05, torch.bfloat16)
        scale = put(rng.rand(c) + 0.5, torch.float32)
    shift = put(rng.randn(c), torch.float32)
    return x, wt, scale, shift


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--dtypes", nargs="*", default=["int8", "bf16"])
    args = p.parse_args(argv)
    dev = resolve_device(None)
    builds = build.build_all((), {"conv3x3_ablate_" + v: variant_source(v)
                                  for v in CUTS})
    del builds
    fns = {v: _fn(v) for v in CUTS}
    stream = torch.cuda.current_stream(dev).cuda_stream
    records = []
    for dtype in args.dtypes:
        rng = np.random.RandomState(0)
        dt = {"int8": torch.int8, "bf16": torch.bfloat16}[dtype]
        passes = dict.fromkeys(CUTS, 0.0)
        for h, w, c in STAGES:
            x, wt, scale, shift = _inputs(rng, dtype, args.batch, h, w, c,
                                          dev)
            wk = wt.permute(3, 0, 1, 2).contiguous()
            out = torch.empty((args.batch, h, w, c), dtype=dt, device=dev)
            call = (x.data_ptr(), wk.data_ptr(), scale.data_ptr(),
                    shift.data_ptr(), out.data_ptr(), args.batch, h, w, c,
                    c, _CONV_ROUTES[dt][1], _CONV_OUTS[dt], 1, stream)
            for v, fn in fns.items():
                ms = device_ms(fn, call, args.iters, dev, "conv_ablate " + v)
                passes[v] += ms
                rec = {"variant": v, "dtype": dtype, "stage": [h, w, c],
                       "ms": ms, "device": torch.cuda.get_device_name(dev)}
                print(json.dumps(rec), flush=True)
                records.append(rec)
            del x, wt, wk, out
        for v, ms in passes.items():
            rec = {"variant": v, "dtype": dtype, "stage": "pass", "ms": ms,
                   "device": torch.cuda.get_device_name(dev)}
            print(json.dumps(rec), flush=True)
            records.append(rec)
    return records


if __name__ == "__main__":
    main()
