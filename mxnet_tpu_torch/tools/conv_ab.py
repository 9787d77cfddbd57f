"""A/B harness: the hand-written ``conv3x3_epilogue`` kernel (B9) against
the port's library route at the ResNet-50 bottleneck 3×3 shapes, int8
and bf16 — the port of ``tools/conv_ab.py``.

    python -m mxnet_tpu_torch.tools.conv_ab [--batch 256] [--iters 20]
        [--dtypes int8 bf16] [--device cuda|cpu]

One JSON line per (stage, dtype, impl) as it goes, with the reference's
keys (``stage``, ``dtype``, ``impl``, ``ms``, ``img_per_s``, or
``error``) and the ``device`` it ran on; :func:`main` also returns the
records.  ``impl`` is ``"library"`` (the counterpart of the reference's
XLA route) or ``"kernel"`` (B9, :func:`~mxnet_tpu_torch.ops.
pallas_kernels.conv3x3_epilogue`).  The library routes:

- int8: :func:`~mxnet_tpu_torch.ops.quantization.int8_conv` (an im2col
  and ``torch._int_mm``) followed by the requantize epilogue in torch —
  what the port's unfused int8 3×3 convolutions run;
- bf16: ``F.conv2d`` on channels-last bf16 tensors (cuDNN) followed by the
  epilogue in torch.  cuDNN rounds its float32 sums to bf16 before the
  epilogue; B9 applies the epilogue to the float32 sums.

The inputs are the reference's: ``np.random.RandomState(0)`` drawn in its
order.  On the card a call is timed with CUDA events over ``--iters``
calls after one warm-up call; on the CPU with the host clock.  The
device defaults to the card and raises without one.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..base import resolve_device
from ..ops.pallas_kernels import _requant, conv3x3_epilogue
from ..ops.quantization import int8_conv

__all__ = ["STAGES", "main"]

# ResNet-50 bottleneck 3x3 stages: (H, W, C) with Cin == Cout
STAGES = [(56, 56, 64), (28, 28, 128), (14, 14, 256), (7, 7, 512)]


def _time(fn, *args, iters=20):
    """Per-call time in seconds after one warm-up call: CUDA events
    around ``iters`` calls on the card, the host clock on the CPU."""
    out = fn(*args)
    if out.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize(out.device)
    return start.elapsed_time(end) / 1e3 / iters


def library_int8(x, w, scale, shift, relu=True):
    """int8 im2col + ``torch._int_mm`` + the requantize epilogue."""
    acc = int8_conv(x, w.permute(3, 0, 1, 2), (3, 3), (1, 1), (), (1, 1),
                    1, "NHWC")
    return _requant(acc, scale, shift, relu)


def library_bf16(x, w, scale, shift, relu=True):
    """cuDNN's bf16 convolution on channels-last tensors + the epilogue."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return _requant(y.permute(0, 2, 3, 1), scale, shift, relu, x.dtype)


def _ab(stage, dtype, library, inputs, batch, iters):
    """The library route, then the kernel, on one stage's inputs: one
    record each, naming the device it ran on."""
    dev = inputs[0].device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    recs = []
    for name, fn in (("library", library), ("kernel", conv3x3_epilogue)):
        base = {"stage": list(stage), "dtype": dtype, "impl": name,
                "device": where}
        try:
            dt = _time(fn, *inputs, iters=iters)
            rec = dict(base, ms=dt * 1e3, img_per_s=batch / dt)
        except Exception as e:
            rec = dict(base, error=str(e)[:200])
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--dtypes", nargs="*", default=["int8", "bf16"])
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    def put(a, dtype):
        return torch.as_tensor(a, device=dev).to(dtype)

    n = args.batch
    rng = np.random.RandomState(0)
    records = []
    for (h, w, c) in STAGES:
        if "int8" in args.dtypes:
            x = put(rng.randint(-127, 128, (n, h, w, c)), torch.int8)
            wt = put(rng.randint(-16, 16, (3, 3, c, c)), torch.int8)
            scale = put(rng.rand(c) * 0.01 + 1e-3, torch.float32)
            shift = put(rng.randn(c), torch.float32)
            records += _ab((h, w, c), "int8", library_int8,
                           (x, wt, scale, shift), n, args.iters)
            del x, wt
        if "bf16" in args.dtypes:
            x = put(rng.randn(n, h, w, c), torch.bfloat16)
            wt = put(rng.randn(3, 3, c, c) * 0.05, torch.bfloat16)
            scale = put(rng.rand(c) + 0.5, torch.float32)
            shift = put(rng.randn(c), torch.float32)
            records += _ab((h, w, c), "bf16", library_bf16,
                           (x, wt, scale, shift), n, args.iters)
            del x, wt
    return records


if __name__ == "__main__":
    main()
