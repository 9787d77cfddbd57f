"""Long-context demo, ring attention and Ulysses sequence parallelism:
the port of ``examples/long_context/ring_attention_demo.py``.

    python -m mxnet_tpu_torch.tools.ring_attention_demo \\
        [--seq-len 4096] [--ranks 8] [--device cpu]

A ``(batch, seq_len, heads, head_dim)`` sequence cut into ``--ranks``
chunks (the reference spreads them over its devices; here they are a
leading rank dimension on one device, ``parallel/mesh.py``), run through
:func:`~..parallel.ring_attention_sharded` (the flash kernels on every
hop on the card) and, where the heads divide, Ulysses; each timed over 3
calls after one warm-up, and held to plain causal attention up to
8,192 tokens.  Runs on the card unless ``--device cpu``; :func:`main`
returns ``{"ring_ms", "ulysses_ms", "max_err"}`` (None where not run).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

__all__ = ["main"]


def _timed(fn, device, reps=3):
    import torch
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) / reps


def main(argv=None):
    import torch

    from ..base import resolve_device
    from ..parallel import (local_attention, ring_attention_sharded,
                            ulysses_attention_sharded)

    parser = argparse.ArgumentParser()
    parser.add_argument("--seq-len", type=int, default=4096)
    parser.add_argument("--heads", type=int, default=8)
    parser.add_argument("--head-dim", type=int, default=64)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--ranks", type=int, default=8,
                        help="sequence ranks (the reference's device count)")
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    n = args.ranks
    print("ranks: %d (%s), sequence %d -> %d per rank"
          % (n, device, args.seq_len, args.seq_len // n))
    rng = np.random.RandomState(0)
    shape = (args.batch, args.seq_len, args.heads, args.head_dim)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                ).to(device) for _ in range(3))
    res = {"ring_ms": None, "ulysses_ms": None, "max_err": None}
    with torch.no_grad():
        out, t = _timed(lambda: ring_attention_sharded(q, k, v, n,
                                                       causal=True), device)
        res["ring_ms"] = t * 1e3
        print("ring attention:     %.1f ms/step" % res["ring_ms"])
        if args.heads % n == 0:
            _, t = _timed(lambda: ulysses_attention_sharded(
                q, k, v, n, causal=True), device)
            res["ulysses_ms"] = t * 1e3
            print("ulysses attention:  %.1f ms/step" % res["ulysses_ms"])
        if args.seq_len <= 8192:
            ref = local_attention(q, k, v, causal=True)
            res["max_err"] = float((out - ref).abs().max())
            print("max err vs full attention: %.2e" % res["max_err"])
    return res


if __name__ == "__main__":
    main()
