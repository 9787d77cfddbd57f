#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mxnet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Three phases; any failure exits non-zero and prints no result line.

1. **Kernels.** Build every CUDA source of the port with ``nvcc`` (one
   process per source, started together), run each kernel's wrapper on
   the card at the shapes the serving path gives it plus ragged ones, and
   hold it against its plain torch version (LayerNorm: atol = rtol =
   1e-5, f32 — only the reduction order differs).  Time the kernel, the
   plain version and one PyTorch library call of the same function
   (``torch.nn.functional.layer_norm``, a yardstick the port never calls)
   on the device (CUDA graphs between CUDA events), beside the least time
   the card could take, and their eager call times with the host's
   launch cost.
2. **Serve.** The TransformerLM at the widest configuration the repo
   documents (vocab 256, d_model 128, 8 heads, 4 layers, d_ff 512,
   seq_len 1024; random weights from ``init_params(0)``), page size 8, 8
   slots, behind ``ModelFleet.register_decode`` and ``Server`` on an
   ephemeral port; 16 concurrent ``POST /decode`` requests of mixed
   prompt lengths and tiers, 32 new tokens each.  Every answer must be
   200 and equal ``reference_decode`` computed on the idle runner, with
   zero recompiles after warmup, every page returned after drain, and the
   kernels' launch counts (zeroed just before the load) showing the path
   went through them.
3. **CUDA vs CPU.** One prefill and 8 decode steps of the same weights on
   ``device="cpu"`` (plain versions) against the card: logits within
   atol 1e-4 (f32; matmul reduction orders differ).

Output: per-phase lines, then a ``{"kernels": [...]}`` JSON line, the
card's name and power limit from ``nvidia-smi``, and as the last line
``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense
# f32 CUDA-core FLOP/s, for the bound of a kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

LN_TOL = 1e-5
LOGIT_TOL = 1e-4
CFG = dict(vocab_size=256, d_model=128, n_heads=8, n_layers=4, d_ff=512,
           seq_len=1024)
PAGE_SIZE, SLOTS = 8, 8
N_REQUESTS, MAX_NEW = 16, 32


def _time_ms(fn, iters=100, replays=10):
    """Device time of one ``fn()`` call: ``iters`` calls captured in a
    CUDA graph, replayed ``replays`` times between CUDA events, so the
    host's launch cost (Python, ctypes) is not in the number."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def _call_ms(fn, iters=200):
    """Eager time of one ``fn()`` call, host launch cost included."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import build
    from mxnet_tpu_torch.ops import fused_optimizer as fo

    t0 = time.monotonic()
    libs = build.build_all()
    print("phase 1: built %s in %.2f s" % (sorted(libs),
                                          time.monotonic() - t0))
    d = CFG["d_model"]
    # the serving path's LN shapes (prefill buckets, the last-position
    # final LN, the decode slot batch) and ragged ones
    shapes = [(1, 1024, d), (1, 8, d), (1, 1, d), (SLOTS, 1, d),
              (997, 96), (3, 33), (5, 1100)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for shape in shapes:
        x = torch.randn(shape, device="cuda", generator=gen) * 3 + 1
        s = torch.randn(shape[-1], device="cuda", generator=gen)
        b = torch.randn(shape[-1], device="cuda", generator=gen)
        got = fo.fused_layer_norm(x, s, b)
        torch.cuda.synchronize()
        want = fo.layer_norm_reference(x, s, b)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        torch.testing.assert_close(got, want, rtol=LN_TOL, atol=LN_TOL)
        print("phase 1: fused_layer_norm %s max_abs_err %.3g"
              % (tuple(shape), err))
    # timing at the prefill shape (the largest the path gives it)
    rows, width = 1024, d
    x = torch.randn(rows, width, device="cuda", generator=gen)
    s = torch.randn(width, device="cuda", generator=gen)
    b = torch.randn(width, device="cuda", generator=gen)
    fns = {"kernel": lambda: fo.fused_layer_norm(x, s, b),
           "plain": lambda: fo.layer_norm_reference(x, s, b),
           "library": lambda: F.layer_norm(x, (width,), s, b, 1e-5)}
    ms, plain_ms, library_ms = (_time_ms(fns[k])
                                for k in ("kernel", "plain", "library"))
    print("phase 1: eager call incl. host launch: kernel %.5f ms, plain "
          "%.5f ms, F.layer_norm %.5f ms"
          % tuple(_call_ms(fns[k]) for k in ("kernel", "plain", "library")))
    nbytes = 4 * (2 * rows * width + 2 * width)
    flops = 8 * rows * width
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print("phase 1: fused_layer_norm (%d, %d) device time: kernel %.5f ms, "
          "plain %.5f ms, F.layer_norm %.5f ms; bound %.6f ms (%d bytes, "
          "%d flops)"
          % (rows, width, ms, plain_ms, library_ms, bound_ms, nbytes,
             flops))
    return {"name": "fused_layer_norm", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/fused_ln.cu",
            "replaces": "mxnet_tpu/ops/fused_optimizer.py:315",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


def _post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_serve():
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    from mxnet_tpu_torch.serving import DecodeRunner, ModelFleet, Server
    from mxnet_tpu_torch.transformer import (DecodeProgram,
                                             TransformerLMConfig,
                                             from_jax_params)

    prog = DecodeProgram(TransformerLMConfig(**CFG), page_size=PAGE_SIZE)
    host_params = prog.program.init_params(0)
    t0 = time.monotonic()
    runner = DecodeRunner(prog, from_jax_params(host_params), slots=SLOTS)
    print("phase 2: runner %r warmed in %.2f s" % (runner,
                                                   time.monotonic() - t0))
    rng = np.random.RandomState(0)
    lengths = [3, 200] + list(rng.randint(3, 201, size=N_REQUESTS - 2))
    prompts = [rng.randint(0, CFG["vocab_size"], size=int(n)).tolist()
               for n in lengths]
    t0 = time.monotonic()
    refs = [runner.reference_decode(p, MAX_NEW).tolist() for p in prompts]
    print("phase 2: %d sequential references in %.2f s"
          % (len(refs), time.monotonic() - t0))

    fleet = ModelFleet()
    fleet.register_decode("lm", runner, max_queue=64)
    srv = Server(fleet, port=0)
    host, port = srv.start()
    url = "http://%s:%d/decode" % (host, port)
    results = [None] * N_REQUESTS
    tiers = ("gold", "silver", "bronze")

    def fire(i):
        results[i] = _post(url, {"prompt": prompts[i], "model": "lm",
                                 "max_new_tokens": MAX_NEW,
                                 "tier": tiers[i % 3]})

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(N_REQUESTS)]
    try:
        fo.reset_launch_counts()
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.monotonic() - t0
        counts = fo.launch_counts()
    finally:
        drained = srv.drain(timeout=120)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a /decode request did not return")
    stats = fleet.batcher("lm").stats
    for i, ((code, body), ref) in enumerate(zip(results, refs)):
        if code != 200:
            raise RuntimeError("request %d: HTTP %d %r" % (i, code, body))
        if body["tokens"] != ref:
            raise RuntimeError("request %d (prompt %d tokens) served %r, "
                               "reference %r" % (i, len(prompts[i]),
                                                 body["tokens"], ref))
    if runner.recompiles_since_warmup() != 0:
        raise RuntimeError("recompiles after warmup: %r"
                           % (runner.jit_cache_keys() - runner._warm_keys))
    need = (2 * CFG["n_layers"] + 1) * (stats.prefills_total
                                        + stats.steps_total)
    if counts["fused_layer_norm"] < need:
        raise RuntimeError("fused_layer_norm launched %d times, the path "
                           "needs >= %d" % (counts["fused_layer_norm"],
                                            need))
    if not drained or runner.pool.pages_in_use != 0:
        raise RuntimeError("drain %s, %d pages still leased"
                           % (drained, runner.pool.pages_in_use))
    p50, p99 = stats.token_latency_ms()
    n_tokens = N_REQUESTS * MAX_NEW
    print("phase 2: %d requests x %d tokens all equal reference_decode; "
          "recompiles 0; pages in use 0" % (N_REQUESTS, MAX_NEW))
    print("phase 2: prefills %d, decode steps %d, fused_layer_norm "
          "launches %d (>= %d)" % (stats.prefills_total, stats.steps_total,
                                   counts["fused_layer_norm"], need))
    print("phase 2: %.1f tokens/s over %.3f s wall; per-token step p50 "
          "%.3f ms, p99 %.3f ms" % (n_tokens / wall, wall, p50, p99))
    return runner, host_params, counts


def phase_cpu_parity(cuda_runner, host_params):
    from mxnet_tpu_torch.serving import DecodeRunner
    from mxnet_tpu_torch.transformer import from_jax_params

    cpu = DecodeRunner(cuda_runner.program,
                       from_jax_params(host_params, "cpu"), slots=SLOTS,
                       warmup=False, device="cpu")
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, CFG["vocab_size"], size=37).astype(np.int32)
    steps = 8
    # the CPU runner's cache is private, so the same page ids serve both
    pages = cuda_runner.pool.alloc(cuda_runner.pool.pages_for(37 + steps))
    worst = 0.0
    try:
        gl = cuda_runner.prefill(prompt, pages)
        cl = cpu.prefill(prompt, pages)
        worst = float(np.abs(gl - cl).max())
        pt = np.zeros((SLOTS, cuda_runner.pages_per_seq), np.int32)
        pt[0, :len(pages)] = pages
        lengths = np.zeros(SLOTS, np.int32)
        toks = np.zeros(SLOTS, np.int32)
        lengths[0], toks[0] = prompt.size, int(gl.argmax())
        for _ in range(steps):
            gl = cuda_runner.decode_step(pt, lengths, toks)[0]
            cl = cpu.decode_step(pt, lengths, toks)[0]
            if not np.isfinite(gl).all():
                raise RuntimeError("non-finite logits on the card")
            worst = max(worst, float(np.abs(gl - cl).max()))
            lengths[0] += 1
            toks[0] = int(gl.argmax())
    finally:
        cuda_runner.pool.free(pages)
    if worst > LOGIT_TOL:
        raise RuntimeError("CUDA vs CPU logits differ by %.3g > %g"
                           % (worst, LOGIT_TOL))
    print("phase 3: prefill + %d decode steps, CUDA vs CPU max |dlogit| "
          "%.3g (tol %g)" % (steps, worst, LOGIT_TOL))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 1
    try:
        import mxnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print("chip_smoke: the mxnet_tpu_torch package is not here (%s); "
              "run from the repository root" % e, file=sys.stderr)
        return 1
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                    torch.cuda.get_device_name(0)))
    t_start = time.monotonic()
    try:
        kernel = phase_kernels()
        runner, host_params, counts = phase_serve()
        kernel["launches"] = counts[kernel["name"]]
        phase_cpu_parity(runner, host_params)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print("total %.2f s" % (time.monotonic() - t_start))
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
