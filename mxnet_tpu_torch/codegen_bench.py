"""The codegen-tier bench: the port of ``mxnet_tpu/codegen_bench.py``.

    python -m mxnet_tpu_torch.codegen_bench [--device cpu]

Runs on the card unless given ``--device cpu`` (without a card and
without the flag it raises).  It builds the six shipped generated kernels
(``ops/generated_kernels.py``: ``nvcc`` for ``sm_90a``, the equivalence
check GEN002 demands), runs each whole-array and — for the flat-tileable
one — row-tiled at every autotune-ladder rung, holds each against its
plain PyTorch twin, and times the unfused and fused spellings.  One JSON
line:

- ``codegen_n_kernels``: generated kernels built (6);
- ``codegen_modeled_bytes_saved_pct``: ``sum(bytes_saved) /
  sum(unfused_bytes)`` over the lowering — the reference's number;
- ``codegen_unfused_ms``: the twin run op by op, eager (every
  intermediate materializes, one launch per eqn), summed over the
  kernels, median of 20 calls each;
- ``codegen_fused_ms``: the generated kernels (one launch per chain),
  summed the same way;
- ``codegen_generated_speedup``: their ratio, measured on the device
  (the reference's ``_host`` suffix is dropped: its arms ran on the host);
- ``codegen_numerics_max_err``: the largest |kernel - twin| over float
  outputs;
- ``codegen_numerics_ok``: 1.0 only if every kernel passed its
  equivalence check, matched the twin at 1e-5 (ints and bools exactly),
  the tiled runs matched the whole-array run, and a rerun was bitwise
  equal.

Each time is taken between CUDA events around one call (the host's
launch cost included, as the reference's host clock included its
dispatch).  With ``--device cpu`` both arms are the twin (the CPU path
of a generated kernel): no emitted kernel runs, so the two numerics keys
are null (nothing was proven) and the timings say nothing of a kernel;
the keys are what the tests check.  On the card the exit code is 0 only
if numerics are ok; a CPU run, which proves nothing, exits 0.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

BENCH_REPS = 20       # timing samples per arm (median)


def _median_ms(fn, dev, reps=BENCH_REPS):
    from .analysis.codegen import _call_ns

    fn()                                    # warm
    return float(np.median([_call_ns(fn, dev) for _ in range(reps)])) / 1e6


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def run(device=None):
    """The bench's record (a dict) on ``device`` (default: the card)."""
    from .analysis import codegen as cg
    from .base import resolve_device
    from .ops import generated_kernels as gen

    dev = resolve_device(device)
    out = {}
    kernels = gen.build_shipped_generated(device=dev)
    lowered = cg.shipped_lowered()

    unfused = sum(lk.unfused_bytes for lk in lowered)
    saved = sum(lk.bytes_saved for lk in lowered)
    out["codegen_modeled_bytes_saved_pct"] = round(
        100.0 * saved / unfused, 2) if unfused else 0.0

    t_unfused_total, t_fused_total = 0.0, 0.0
    numerics_ok = True
    max_err = 0.0
    for gk in kernels:
        lk = gk.lowered
        xs = [torch.as_tensor(x).to(dev)
              for x in cg.seeded_inputs(lk.in_avals, cg.EQUIV_SEED)]
        if dev.type == "cuda":
            want = cg.reference_outputs(lk, xs)
            got = gen.generated_call(gk, *xs)
            ok, err = cg.compare_outputs(got, want)
            max_err = max(max_err, err)
            numerics_ok &= ok and gk.equivalence_ok
            numerics_ok &= _bitwise(got, gen.generated_call(gk, *xs))
            if cg.flat_tileable(lk):
                for br in cg.AUTOTUNE_LADDER:
                    tiled = gen.generated_call(gk, *xs, block_rows=br)
                    ok, err = cg.compare_outputs(tiled, got)
                    max_err = max(max_err, err)
                    numerics_ok &= ok

        t_unfused_total += _median_ms(
            lambda lk=lk, xs=xs: cg.reference_outputs(lk, xs), dev)
        t_fused_total += _median_ms(
            lambda gk=gk, xs=xs: gen.generated_call(gk, *xs), dev)

    out["codegen_n_kernels"] = len(kernels)
    out["codegen_unfused_ms"] = round(t_unfused_total, 4)
    out["codegen_fused_ms"] = round(t_fused_total, 4)
    out["codegen_generated_speedup"] = round(
        t_unfused_total / t_fused_total, 3) if t_fused_total else 0.0
    proven = dev.type == "cuda"
    out["codegen_numerics_max_err"] = float(max_err) if proven else None
    out["codegen_numerics_ok"] = (1.0 if numerics_ok else 0.0) \
        if proven else None
    out["device"] = torch.cuda.get_device_name(dev) \
        if dev.type == "cuda" else "cpu"
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mxnet_tpu_torch."
                                 "codegen_bench", description=__doc__
                                 .split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain twin on the host "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run(args.device)
    print(json.dumps(out))
    return 0 if out["codegen_numerics_ok"] in (1.0, None) else 1


if __name__ == "__main__":
    sys.exit(main())
