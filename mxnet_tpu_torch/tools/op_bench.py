"""Per-operator microbenchmark: the port of ``tools/op_bench.py``.

    python -m mxnet_tpu_torch.tools.op_bench                 # every op
    python -m mxnet_tpu_torch.tools.op_bench --ops flip topk # named ops
    python -m mxnet_tpu_torch.tools.op_bench --grad --scale 2 --device cpu

The reference times each registered op on its first sweep case
(``tests/test_op_sweep.py``'s ``CASES``, a test module of the JAX
package); the port times each op of its own case table,
:data:`~.op_cases.CASES` (one case per op, at the shapes models give
them), with the reference's flags and record.  Every op there is a
registered op of the port, run through its registry function as the
reference's harness runs its ``op.fn``.

One JSON line per (op, case) is printed as soon as it is measured, then
a summary line (ops timed, errors, the ten slowest).  Timing: one first
call (``first_call_s``: PyTorch compiles nothing, so this is the first
dispatch and its allocations, where the reference reports its jit
compile), then ``iters`` calls fenced once by a device synchronize
(``fwd_us``, and ``fwd_gbps_in`` over the inputs' bytes); ``--eager``
adds per-call fenced timing (``eager_us``), ``--grad`` the backward of
the sum of the first output over the float inputs (``bwd_us``).  Runs
on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

__all__ = ["bench_case", "main"]


def _scale_case(case, factor):
    """Inflate the leading (batch) axis of every generated input by
    ``factor``."""
    base = case.inputs

    def gen(rng):
        return [x if x.ndim == 0 else np.tile(x, (factor,) + (1,) * (
            x.ndim - 1)) for x in base(rng)]
    return case._replace(inputs=gen)


def _fence(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, iters, device):
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    _fence(device)
    return out, (time.perf_counter() - t0) / iters


def bench_case(name, case, device, iters=50, grad=False, eager=False):
    """One JSON record of op ``name`` on ``case``'s inputs on ``device``."""
    import torch

    from ..ops import registry

    op = registry.get(name)
    np_inputs = case.inputs(np.random.RandomState(0))
    inputs = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
              for x in np_inputs]
    params = dict(case.params)
    if op.needs_train:
        params["_train"] = True
    if not inputs and "ctx" in op.fn_params:
        params["ctx"] = device
    rec = {"op": name, "device": str(device),
           "shapes": [list(x.shape) for x in np_inputs],
           "dtypes": [str(x.dtype) for x in np_inputs],
           "bytes_in": int(sum(x.nbytes for x in np_inputs)),
           "iters": iters}

    def fwd():
        with torch.no_grad():
            return op.fn(*inputs, **params)

    t0 = time.perf_counter()
    fwd()
    _fence(device)
    rec["first_call_s"] = round(time.perf_counter() - t0, 4)
    if eager:
        def fenced():
            out = fwd()
            _fence(device)
            return out
        rec["eager_us"] = round(_timed(fenced, iters, device)[1] * 1e6, 2)
    dt = _timed(fwd, iters, device)[1]
    rec["fwd_us"] = round(dt * 1e6, 2)
    if rec["bytes_in"] and dt > 0:
        rec["fwd_gbps_in"] = round(rec["bytes_in"] / dt / 1e9, 3)
    float_idx = [i for i, x in enumerate(np_inputs)
                 if np.issubdtype(x.dtype, np.floating)]
    if grad and float_idx:
        def bwd():
            xs = list(inputs)
            for i in float_idx:
                xs[i] = xs[i].detach().requires_grad_(True)
            o = op.fn(*xs, **params)
            o = o[0] if isinstance(o, (tuple, list)) else o
            return torch.autograd.grad(o.float().sum(),
                                       [xs[i] for i in float_idx],
                                       allow_unused=True)
        try:
            bwd()
            rec["bwd_us"] = round(_timed(bwd, iters, device)[1] * 1e6, 2)
        except Exception as e:      # an op without a gradient
            rec["bwd_error"] = str(e)[:120]
    return rec


def main(argv=None, emit=print):
    """Time the ops; returns the records and the summary."""
    from ..base import resolve_device
    from ..ops import registry
    from .op_cases import CASES

    registry.load_all()

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ops", nargs="*", default=None,
                   help="op names to time (default: every op of the "
                        "case table)")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--all-cases", action="store_true",
                   help="time every case of an op, not just the first")
    p.add_argument("--grad", action="store_true", help="also time backward")
    p.add_argument("--eager", action="store_true",
                   help="also time per-call fenced dispatch")
    p.add_argument("--scale", type=int, default=1,
                   help="inflate case batch axes by this factor")
    p.add_argument("--out", default=None,
                   help="also append JSONL records to this file")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    table = {}
    for case in CASES:
        table.setdefault(case.name, []).append(case)
    names = args.ops or sorted(table)
    sink = open(args.out, "a") if args.out else None
    records, slowest, n_ok, n_err = [], [], 0, 0

    def put(rec):
        line = json.dumps(rec)
        emit(line)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for name in names:
        cases = table.get(name)
        if not cases:
            records.append({"op": name, "error": "no case"})
            put(records[-1])
            n_err += 1
            continue
        for i, case in enumerate(cases if args.all_cases else cases[:1]):
            if args.scale > 1:
                case = _scale_case(case, args.scale)
            try:
                rec = bench_case(name, case, device, iters=args.iters,
                                 grad=args.grad, eager=args.eager)
                rec["case"] = i
                n_ok += 1
                slowest.append((rec["fwd_us"], "%s-%d" % (name, i)))
            except Exception as e:
                rec = {"op": name, "case": i, "error": str(e)[:200]}
                n_err += 1
            records.append(rec)
            put(rec)
    slowest.sort(reverse=True)
    summary = {"summary": True, "timed": n_ok, "errors": n_err,
               "slowest": [{"case": c, "fwd_us": us}
                           for us, c in slowest[:10]]}
    put(summary)
    if sink:
        sink.close()
    return records, summary


if __name__ == "__main__":
    main()
