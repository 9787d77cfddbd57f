"""What holds the wgmma design of ``qmm_requant`` (B8) back: the kernel
rebuilt with one part switched off at a time and timed at the four stages
of the int8 ResNet-50 forward's 1×1 convolutions ``a``.

    python -m mxnet_tpu_torch.tools.qmm_ablate [--batch 256] [--iters 20]

Each variant is ``csrc/qmm_wgmma.cu`` with textual edits (:data:`CUTS`),
built through ``ops.build.load_source`` as ``tools/conv_ablate.py`` builds
B9's:

- ``full``: the source as it is;
- ``no_x``: no x-tile loads, the ring's barriers still run;
- ``no_w``: no weight-tile loads (nor the resident weight slice);
- ``no_loads``: neither;
- ``no_mma``: no ``wgmma``;
- ``no_epilogue``: no epilogue math, staging or output stores.

A variant's outputs are wrong by design, so only its device time is
printed: CUDA events around ``--iters`` calls of the C entry point on
seeded inputs, every variant timed once to warm the card and then twice,
in turn and in reverse order, keeping the lesser time; summed over the
shapes of each stage.  One JSON line per (variant, stage), with the time
of each shape, and one per variant for the forward's 16 launches;
:func:`main` also returns the records.  A time that drops when
a part is cut says that part holds the kernel back.  The card is
required.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from ..base import resolve_device
from ..ops import build
from ..ops.pallas_kernels import _qmm_argtypes
from .conv_ablate import device_ms, edited_source

__all__ = ["CUTS", "variant_source", "path_stages", "main"]

_EXPECT = "        mbar_expect_tx(bar, stage);\n"
_LOAD_X = "        tma_load_2d(a, &xmap, bar, step * BKB, m0);\n"
_LOAD_W = ("        if (!resident)\n"
           "          tma_load_2d(a + A_BYTES, &wmap, bar, step * BKB, n0);\n")
_RESIDENT = "      mbar_expect_tx(bar, nk * B_BYTES);\n"
_NO_RESIDENT = (_RESIDENT, "      mbar_arrive(bar);\n      if (0)\n")
_MMA = "        Mma<BN>::run(acc,"
_EPILOGUE = "    const float* const bv = vec(ob);\n"
_STORES = "      for (int q = t; q < BM * CHUNKS; q += 128) {\n"

# variant -> [(text in the source, its replacement)]
CUTS = {
    "full": [],
    "no_x": [(_EXPECT + _LOAD_X,
              "        mbar_expect_tx(bar, stage - A_BYTES);\n")],
    "no_w": [(_EXPECT, "        mbar_expect_tx(bar, A_BYTES);\n"),
             (_LOAD_W, ""), _NO_RESIDENT],
    "no_loads": [(_EXPECT + _LOAD_X + _LOAD_W, "        mbar_arrive(bar);\n"),
                 _NO_RESIDENT],
    "no_mma": [(_MMA, "        if (0) Mma<BN>::run(acc,")],
    "no_epilogue": [(_EPILOGUE, "    if (acc[0] == 12345) out[0] = 1;\n"
                     "    mbar_arrive(smem_u32(&out_full[ob]));\n"
                     "    continue;\n" + _EPILOGUE),
                    (_STORES, "      if (0)\n" + _STORES)],
}


def variant_source(name):
    """``csrc/qmm_wgmma.cu`` with the edits of variant ``name``; raises if
    an edit's text is not in the source exactly once."""
    return edited_source("qmm_wgmma", CUTS[name], name)


def path_stages(batch):
    """(M, K, N) of B8's 16 launches in one int8 ResNet-50 (NHWC) forward
    at ``batch``, 224 × 224 input, by stage: each bottleneck's conv ``a``
    (the stride-2 ones sliced first)."""
    stages = []
    for stage, (units, width, side) in enumerate(
            [(3, 64, 56), (4, 128, 28), (6, 256, 14), (3, 512, 7)]):
        m = batch * side * side
        stages.append([(m, width if stage == 0 else 2 * width, width)]
                      + [(m, 4 * width, width)] * (units - 1))
    return stages


def _fn(name):
    lib = build.load_source("qmm_ablate_" + name, variant_source(name))
    fn = lib.mxtt_qmm_wgmma
    fn.argtypes = _qmm_argtypes(vec16=False)
    fn.restype = ctypes.c_int
    return fn


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    dev = resolve_device(None)
    build.build_all((), {"qmm_ablate_" + v: variant_source(v) for v in CUTS})
    fns = {v: _fn(v) for v in CUTS}
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = torch.cuda.get_device_name(dev)
    rng = np.random.RandomState(0)
    records = []
    forward = dict.fromkeys(CUTS, 0.0)
    for number, shapes in enumerate(path_stages(args.batch), 1):
        per_shape = {v: [] for v in CUTS}
        for m, k, n in shapes:
            x = torch.as_tensor(rng.randint(-127, 128, (m, k)),
                                device=dev).to(torch.int8)
            w = torch.as_tensor(rng.randint(-127, 128, (n, k)),
                                device=dev).to(torch.int8)
            bias = torch.as_tensor(rng.randn(n) * 10, device=dev).float()
            out = torch.empty((m, n), dtype=torch.int8, device=dev)
            call = (x.data_ptr(), k, w.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), m, n, k,
                    float(60.0 / (np.sqrt(k) * 127 * 127 / 3)), 1, stream)
            runs = {v: [] for v in fns}
            for i, v in enumerate(list(fns) * 2 + list(fns)[::-1]):
                ms = device_ms(fns[v], call, args.iters, dev,
                               "qmm_ablate " + v)
                if i >= len(fns):             # the first round warms up
                    runs[v].append(ms)
            for v in fns:
                per_shape[v].append(min(runs[v]))
            del x, w, bias, out
        for v, times in per_shape.items():
            ms = sum(times)
            forward[v] += ms
            rec = {"variant": v, "stage": number, "shapes": shapes,
                   "ms": ms, "shape_ms": times, "device": name}
            print(json.dumps(rec), flush=True)
            records.append(rec)
    for v, ms in forward.items():
        rec = {"variant": v, "stage": "forward", "ms": ms, "device": name}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
