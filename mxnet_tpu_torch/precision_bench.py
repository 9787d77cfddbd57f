"""The mixed-precision bench: the port of ``mxnet_tpu/precision_bench.py``.

    python -m mxnet_tpu_torch.precision_bench [--device cpu]

Runs on the card unless given ``--device cpu`` (without a card and
without the flag it raises).  One JSON line:

- ``fused_loss_scaled_unfused_ms`` / ``fused_loss_scaled_fused_ms`` /
  ``fused_loss_scaled_speedup``: the unfused unscale + clip + update
  chain (per parameter, ``g * inv_scale`` through
  ``functional_optimizer_update``, the ``torch.where`` select-skip
  outside) against one launch of the fused SGD-momentum kernel (B1) with
  ``inv_scale`` and ``ok`` as device tensors in its scalar block, 96
  parameters of 4,096; median wall time of 40 calls each, the card
  synchronized after each (the reference's ``_host`` suffix is dropped:
  its arms ran on the host);
- ``precision_numerics_max_err``: the largest difference of the two;
- ``bf16_convergence_delta`` / ``bf16_final_loss``: the largest |loss_bf16
  - loss_f32| over 20 trainer steps of the same net, seed and data, and
  the last bf16 loss;
- ``precision_numerics_ok``: 1.0 iff the fused and unfused updates agree
  within 1e-5, an inf gradient with ``ok = 0`` leaves the weights and
  momentum bitwise untouched, and the bf16 run learns;
- ``unported``: the reference's keys this bench does not print, each
  with the ROADMAP.md queue A item that brings it — the int8 KV-cache
  decode keys (A9) and the bf16 ZeRO-1 budget model's modeled HBM ratio
  (A13).  They are absent, never faked.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

FLOAT_TOL = 1e-5
BENCH_REPS = 40
NPAR, PSIZE = 96, 4096
CONV_STEPS = 20
UNPORTED = {
    "int8_kv_decode_tokens_per_sec_host": "A9 (int8 KV cache)",
    "int8_kv_token_agreement": "A9 (int8 KV cache)",
    "int8_kv_page_bytes": "A9 (int8 KV cache)",
    "bf16_modeled_hbm_ratio": "A13 (the budget models' "
                              "bf16_zero1_train_step)",
    "bf16_modeled_hbm_drop_pct": "A13 (the budget models' "
                                 "bf16_zero1_train_step)",
}


def _bench(fn, device, reps=BENCH_REPS):
    import torch
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _loss_scaled_update_bench(out, device):
    """The unfused unscale + clip + update chain against the fused
    kernel with ``inv_scale`` / ``ok`` in its scalar block."""
    import torch

    from . import optimizer as opt_mod
    from .ops import fused_optimizer as fo
    from .parallel.functional import functional_optimizer_update

    opt = opt_mod.SGD(learning_rate=0.1, momentum=0.9, wd=1e-4)
    rng = np.random.RandomState(7)

    def mk():
        return [torch.from_numpy(rng.randn(PSIZE).astype("f")).to(device)
                for _ in range(NPAR)]

    ws, gs, ms = mk(), mk(), mk()
    wf, gf, mf = (torch.cat(t) for t in (ws, gs, ms))
    lr = 0.1
    inv = torch.full((), 1.0 / 1024.0, device=device)
    ok = torch.ones((), device=device)

    def unfused():
        outs = []
        for w, g, m in zip(ws, gs, ms):
            nw, nm = functional_optimizer_update(opt, 0, w, g * inv, m, lr, 1)
            okb = ok > 0.0
            outs.append((torch.where(okb, nw, w), torch.where(okb, nm, m)))
        return outs

    def fused(w, g, m, ok_flag):
        return fo.fused_optimizer_update(opt, 0, w, g, m, lr, 1,
                                         inv_scale=inv, ok=ok_flag)

    nw_u = unfused()
    w1, m1 = wf.clone(), mf.clone()
    fused(w1, gf, m1, ok)
    err = max(float((torch.cat([a for a, _ in nw_u]) - w1).abs().max()),
              float((torch.cat([b for _, b in nw_u]) - m1).abs().max()))
    w2, m2 = wf.clone(), mf.clone()
    t_u = _bench(unfused, device)
    t_f = _bench(lambda: fused(w2, gf, m2, ok), device)
    out["fused_loss_scaled_unfused_ms"] = round(t_u * 1e3, 4)
    out["fused_loss_scaled_fused_ms"] = round(t_f * 1e3, 4)
    out["fused_loss_scaled_speedup"] = round(t_u / t_f, 3)
    # the skip contract: an inf gradient with ok = 0 leaves w / m alone
    gbad = gf.clone()
    gbad[0] = float("inf")
    sw, sm = wf.clone(), mf.clone()
    fused(sw, gbad, sm, torch.zeros((), device=device))
    skipped_ok = bool(torch.equal(sw, wf) and torch.equal(sm, mf))
    return err, skipped_ok


def _convergence_bench(out, device):
    """bf16 against f32 trainer loss trajectories, same seed and data."""
    from . import initializer
    from .gluon import loss as gloss
    from .gluon import nn
    from .parallel import DataParallelTrainer

    rng = np.random.RandomState(11)
    x = rng.randn(32, 16).astype(np.float32)
    y = rng.randint(0, 4, size=32).astype(np.int32)

    def losses(dtype):
        net = nn.HybridSequential()
        net.add(nn.Dense(32, activation="relu"))
        net.add(nn.Dense(4))
        # identical init for both arms
        net.initialize(initializer.Xavier(rnd_type="gaussian",
                                          magnitude=2.0), ctx=device,
                       rng=np.random.RandomState(3))
        tr = DataParallelTrainer(net, gloss.SoftmaxCrossEntropyLoss(), "sgd",
                                 {"learning_rate": 0.1}, dtype=dtype,
                                 device=device)
        return [float(tr.step(x, y)) for _ in range(CONV_STEPS)]

    l32 = losses("float32")
    l16 = losses("bf16")
    out["bf16_convergence_delta"] = round(
        max(abs(a - b) for a, b in zip(l32, l16)), 5)
    out["bf16_final_loss"] = round(l16[-1], 5)
    return l16[-1] < l16[0]


def main(argv=None):
    import torch

    from .base import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.precision_bench")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the host; default the card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {}
    err, skipped_ok = _loss_scaled_update_bench(out, device)
    out["precision_numerics_max_err"] = float(err)
    learning = _convergence_bench(out, device)
    out["precision_numerics_ok"] = 1.0 if (
        err <= FLOAT_TOL and skipped_ok and learning) else 0.0
    out["device"] = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")
    out["unported"] = sorted(UNPORTED)
    out["unported_items"] = UNPORTED
    print(json.dumps(out), flush=True)
    return 0 if out["precision_numerics_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
