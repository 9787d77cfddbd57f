#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mxnet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile]

Sixteen phases; any failure exits non-zero and prints no result line.

1. **Kernels.** Build every CUDA source of the port with ``nvcc`` (one
   process per source, started together — the six mxgen kernels that
   ``analysis/codegen.py`` emits among them), run each kernel's wrapper on
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
4. **Optimizer kernels.** The fused SGD, SGD+momentum and Adam kernels
   against their plain versions at the ResNet-50 bucket size (every
   trainable parameter, one flat f32 bucket), ragged sizes 1, 3, 127,
   1,000,003 and a view that is not 16-byte aligned, with clipping off
   and on, wd 0 and 1e-4, rescale_grad and inv_scale != 1, and ok = 0
   (outputs bitwise the inputs): atol = rtol = 1e-6 (f32; only FMA
   contraction differs).  Two runs of one input are bitwise equal.
   Timed at the bucket size as in phase 1; the library yardsticks are
   ``torch.optim.SGD(momentum=0.9, fused=True)`` / ``SGD(fused=True)`` /
   ``Adam(fused=True, capturable=True)`` ``.step()`` on one flat tensor
   of the same size — near-equivalents only (torch's momentum is
   ``buf = mu*buf + g; w -= lr*buf``).
5. **Train ResNet-50.** The bench's recipe (``bench.py:483-500``) through
   the port's entry points: ``vision.resnet50_v1()`` (NCHW, 1000
   classes), ``initialize(Xavier(), rng=RandomState(0))``,
   ``DataParallelTrainer(net, SoftmaxCrossEntropyLoss(), "sgd", lr 0.05,
   momentum 0.9, wd 1e-4)`` on a fixed random 256 x 3 x 224 x 224 batch
   (halved on out-of-memory), 3 warm-up and 10 timed steps with torch's
   default TF32 settings.  Every loss finite, the last below the first,
   and ``fused_sgd_momentum`` launched exactly steps x buckets times.
   Then 2 steps each of ``"sgd"`` (momentum 0) and ``"adam"`` on the same
   net: ``fused_sgd`` and ``fused_adam`` launched 2 x buckets times.
   ``--profile`` adds a ``torch.profiler`` window of 2 more SGD+momentum
   steps: device time by kernel category and the device's idle share.
6. **CUDA vs CPU training.** The same carried weights at full width,
   batch 2 at 224 x 224, 2 SGD+momentum steps on the card (TF32 off) and
   with ``device="cpu"``.  The first step's loss (the forward before any
   update) within atol 1e-4 (f32; conv and BatchNorm reduction orders
   differ).  After two steps the parameters and moving statistics cannot
   be held to a fixed tolerance: from Xavier weights at lr 0.05 the first
   steps are chaotic (moving the input by one ulp moves parameters by
   ~0.2 after two steps on one CPU), so they are held to 10x the rounding
   floor measured in the same run — a third, CPU run on the input moved
   one ulp up.  The same two steps in float64 (``Block.cast``; the
   update takes the unfused route, the kernels being f32) hold losses,
   parameters and moving statistics to atol 1e-4: there the rounding
   floor is far below it.

7. **Flash kernels.** The forward (``flash_forward_with_lse``), ``flash_dq``
   and ``flash_dkv`` kernels against their plain versions at the training
   path's pairings (512 x 512 chunks at D = 16: causal over BH = 512,
   full over BH = 256), ragged (3, 997 x 1000, 64) causal and full,
   (2, 1 x 1, 16) and (4, 300 x 300, 128) causal: out and lse within
   atol = rtol = 1e-5 (f32; only the summation order differs), dq/dk/dv
   from a seeded dO within 1e-4 (they sum over T); two runs bitwise
   equal.  Timed per layer (both pairings) with CUDA events around eager
   calls, beside the bound and the library yardstick
   ``scaled_dot_product_attention`` (f32; its backward through one
   ``torch.autograd.grad`` stands for dq and dk/dv together).
8. **Train the TransformerLM.** The configuration above through
   ``DataParallelTrainer(TransformerLM(cfg), None, "sgd", lr 0.1,
   momentum 0.9, mesh_plan=MeshPlan(sequence=2))``: ring attention over a
   sequence axis of 2 (the ranks a leading dimension on the card), batches
   of 32 x 1024 tokens cut from the bench's seeded Markov corpus, 3
   warm-up and 10 timed steps with torch's default precision.  Every loss
   finite, the last below the first, each flash kernel launched steps x
   layers x 2 hops times and the LayerNorm kernel >= steps x (2 x layers
   + 1).  ``--profile`` adds the ``torch.profiler`` breakdown.
9. **Held on the card.** The same ``init_params(0)`` weights, 2 steps on
   one batch of 2 x 1024 tokens three ways: ``MeshPlan(sequence=2)`` on
   CUDA and on ``device="cpu"``, and the collapsed ``MeshPlan()`` (local
   attention, no flash kernel) on CUDA.  Losses CUDA vs CPU within 1e-4,
   sequence=2 vs collapsed within 2e-5 (the reference's own tolerance),
   parameters after 2 steps within 2e-5 both ways.
10. **qmm_requant (B8).** The kernel against its plain version at the 16
    (M, K, N) shapes of one int8 ResNet-50 forward at batch 256 (each
    bottleneck's 1x1 conv ``a``) and ragged ones (K = 70, N = 17, M = 1),
    relu on and off: bitwise equal, and a rerun bitwise equal.  Timed
    summed over one forward's 16 launches (CUDA events around eager
    calls) beside its bound (bytes over 3.35 TB/s against 2MKN over 1,979
    int8 TOP/s) and the yardstick ``torch._int_mm`` + torch epilogue.
11. **Serve int8 ResNet-50.** ``resnet_symbol(50, num_classes=1000,
    layout="NHWC")``, ``Module.init_params(Xavier(), rng=RandomState(0))``,
    ``ptq_quantize_module`` over 64 seeded 224 x 224 images (naive
    calibration) with ``MXTPU_FUSE_QCONV=1`` and ``MXTPU_PALLAS_QMM=1``
    (33 fused / 20 unfused conv nodes), ``Module(qsym)`` at batch 256,
    ``ModelRunner(buckets=(1, 4, 16, 64))`` behind ``ModelFleet`` and
    ``Server``: 16 concurrent ``POST /predict`` of 1-4 images, mixed
    tiers, every answer 200 and equal to ``forward_batch`` on the idle
    runner, 0 recompiles.  Then ``Module.forward`` at batch 256 (the
    bench's recipe, ``bench.py:1033-1062``): 3 warm-up and 20 timed
    forwards, images/s, p50/p99, peak memory; ``qmm_requant`` launched 16
    times per forward.  ``--profile`` adds the device time by category.
12. **Held on the card.** The same quantized graph and weights for 2
    images on the card and ``device="cpu"``: top-1 equal, probabilities
    within 1e-5.  Calibrated ranges of a card calibration (cuDNN TF32 off
    for it, restored after) and a CPU calibration over the same 8 images
    within 1e-4 relative.
13. **conv3x3_epilogue (B9).** The implicit-GEMM 3x3 kernel against its
    plain version (float64 sums) at the conv A/B harness's four stages at
    batch 256 (the stride-1 conv ``b`` of every ResNet-50 bottleneck:
    56 x 56 x 64, 28 x 28 x 128, 14 x 14 x 256, 7 x 7 x 512, Cin = Cout)
    and ragged shapes (Cin 3 with odd W, Cin 8 and 16, Cout 5, 16, 24,
    N = 1), int8 and bf16, relu on and off, and float32 at
    (2, 28, 28, 512) -> 128.  int8 bitwise equal; bf16 within one bf16
    ulp (magnitudes counted no finer than 1/64 of the outputs' RMS, where
    a bf16 ulp is finer than the float32 sums' rounding; the outputs
    beyond one ulp at their own magnitude are counted and printed);
    float32 within 1e-4 x max(1, max |plain|); every rerun bitwise.
    Then one pass of the four stages per route, timed with CUDA events
    around eager calls: kernel, plain, and the library route (int8:
    ``int8_conv``'s im2col + ``torch._int_mm`` + the torch epilogue;
    bf16: cuDNN's ``F.conv2d`` + the torch epilogue), beside the bound
    (per stage the larger of bytes over 3.35 TB/s and 2 x multiply-adds
    over 1,979 int8 TOP/s or 989 bf16 TFLOP/s).
14. **The conv A/B harness.** ``mxnet_tpu_torch.tools.conv_ab.main(
    ["--batch", "256", "--iters", "20"])`` on the card: 16 records (4
    stages x int8/bf16 x library/kernel), each with ``ms``, none an
    ``error``; ``conv3x3_epilogue`` launched 4 x (1 warm-up + 20) times
    per route.  Prints each stage's kernel and library times.
    ``--profile`` adds phase 13's device time by category of one pass of
    each library route and of B9 (im2col, GEMM, epilogue).
15. **The mxgen kernels (B10).** The six shipped fusion chains
    (``mxnet_tpu_torch/analysis/shipped_chains.json``) lowered to CUDA
    C++ by ``analysis/codegen.py`` and built with one ``nvcc`` each in
    phase 1; ``build_shipped_generated(device="cuda")`` registers and
    proves them and ``lint_generated_kernels()`` is empty.  Each kernel
    against its plain PyTorch twin on the card on the reference's seeded
    inputs: floats within rtol = atol = 1e-5 (only summation orders and
    the library's tanh/rsqrt differ), ints and bools exactly, whole-array
    for all six and row-tiled at every ladder rung (8, 32, 128, 256) for
    the flat-tileable ``_gen_zero1_top2``; reruns bitwise.  With
    ``MXGEN_LOWER_EXACT = False`` (``sub`` emitted as ``add``) every chain
    with a ``sub`` is rebuilt and must FAIL its check.  A synthetic
    chain of 90 eqns over 48 prims of the provable set (f32, int32 and
    bool; ``_sweep_ir``) is lowered, built and held to its twin the same
    way, so the emitter's forms the six chains do not use run too.  The
    autotune
    cache is written once into a temporary file and replayed: same
    choice, byte-identical file.  Each kernel timed as its device time
    (CUDA graph of 200 calls), its eager call and the eager twin, beside
    its bound (bytes over 3.35 TB/s against f32 operations over 67
    TFLOP/s) and one tiny kernel's launch floor.  ``_gen_zero1_top2``
    (``m' = 0.9 m + g / 8``, ``w' = w - 0.1 m'``) is SGD with momentum,
    so ``torch._fused_sgd_`` with ``grad_scale`` 8 computes it in one
    call: it is held to the twin at 1e-5 and timed the same way as the
    library time (the port never calls it).
16. **The entry point.** ``mxnet_tpu_torch.codegen_bench.main([])`` on
    the card: its JSON line has ``codegen_numerics_ok == 1.0`` and
    ``codegen_n_kernels == 6``, and the launch counters (zeroed just
    before) show every ``_gen_*`` kernel launched.

Output: per-phase lines, then a ``{"kernels": [...]}`` JSON line (the
flash kernels' ``ms``/``plain_ms``/``bound_ms`` are per layer, both
pairings; ``qmm_requant``'s per forward, its 16 launches summed;
``conv3x3_epilogue[int8]``/``[bf16]``'s per pass of the four harness
stages, ``launches`` from phase 14; the ``_gen_*`` kernels' per call,
``launches`` from phase 16, ``library_ms`` that of ``torch._fused_sgd_``
for ``_gen_zero1_top2`` and null for the other five, which no single
PyTorch call computes), the card's name and power limit from
``nvidia-smi``, and as the last line ``{"ok": true, "device": {...}}``.
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

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense f32
# CUDA-core FLOP/s and dense int8 tensor-core operations/s, for the bound
# of a kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
INT8_OPS_PER_S = 1.979e15
BF16_FLOPS_PER_S = 989e12

LN_TOL = 1e-5
LOGIT_TOL = 1e-4
OPT_TOL = 1e-6
TRAIN_TOL = 1e-4
NOISE_FACTOR = 10
CFG = dict(vocab_size=256, d_model=128, n_heads=8, n_layers=4, d_ff=512,
           seq_len=1024)
PAGE_SIZE, SLOTS = 8, 8
N_REQUESTS, MAX_NEW = 16, 32
BATCH, WARMUP, TIMED = 256, 3, 10
SGD_PARAMS = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
# slice 3: the TransformerLM's training batch and optimizer, and the
# tolerances of phases 7 and 9
TRAIN_LM_BATCH = 32
LM_SGD = {"learning_rate": 0.1, "momentum": 0.9}
FLASH_FWD_TOL, FLASH_BWD_TOL = 1e-5, 1e-4
LM_LOSS_TOL_DEVICE, LM_LOSS_TOL_SEQ, LM_PARAM_TOL = 1e-4, 2e-5, 2e-5
# slice 4: int8 ResNet-50 serving (phases 10-12)
QCLASSES, QBATCH, QTIMED, QCALIB, QSIDE = 1000, 256, 20, 64, 224
QBUCKETS = (1, 4, 16, 64)
Q_REQUESTS = 16
QMM_RAGGED = [(130, 70, 40), (600, 520, 300), (1, 8, 8), (333, 48, 17)]
PARITY_IMAGES, CALIB_PARITY_IMAGES = 2, 8
PROB_TOL, RANGE_RTOL = 1e-5, 1e-4
# slice 5: conv3x3_epilogue (B9) and the conv A/B harness (phases 13-14);
# ((N, H, W, Cin), Cout) of the ragged checks and the float32 check
CONV_BATCH, CONV_ITERS = 256, 20
CONV_RAGGED = [((2, 8, 8, 16), 32), ((4, 6, 6, 16), 32), ((1, 14, 14, 8), 16),
               ((2, 6, 6, 8), 24), ((2, 9, 11, 3), 5), ((1, 7, 7, 512), 512)]
CONV_F32 = ((2, 28, 28, 512), 128)
# slice 6: the mxgen kernels (B10) and codegen_bench (phases 15-16)
GEN_TOL = 1e-5          # codegen.EQUIV_TOL: rtol = atol, ints/bools exact
GEN_TIMED = 200
CONV_F32_TOL = 1e-4
# bf16 outputs are held to one bf16 ulp at their magnitude, counted no
# finer than at 1/64 of the outputs' RMS (see _bf16_ulps)
CONV_BF16_FLOOR = 2.0 ** -6
# (clip_gradient, wd, rescale_grad, inv_scale, ok)
OPT_CASES = [(None, 0.0, 1.0, 1.0, 1.0), (0.5, 1e-4, 1.0, 1.0, 1.0),
             (None, 1e-4, 0.25, 1.0, 1.0), (0.3, 0.0, 1.0, 1.0 / 1024, 1.0),
             (0.5, 1e-4, 0.5, 0.5, 0.0)]
# wrapper -> (bytes moved per element, f32 operations per element, the
# TPU kernel it replaces)
OPT_KERNELS = {
    "fused_sgd": (12, 5, "mxnet_tpu/ops/fused_optimizer.py:141"),
    "fused_sgd_momentum": (20, 8, "mxnet_tpu/ops/fused_optimizer.py:151"),
    "fused_adam": (28, 16, "mxnet_tpu/ops/fused_optimizer.py:165"),
}


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

    from mxnet_tpu_torch.analysis import codegen as cg

    t0 = time.monotonic()
    emitted = {lk.symbol: lk.src for lk in cg.shipped_lowered()}
    t1 = time.monotonic()
    libs = build.build_all(build.KERNEL_SOURCES, emitted)
    print("phase 1: lowered the 6 shipped mxgen chains to CUDA in %.2f s; "
          "built %s in %.2f s (one nvcc each, started together)"
          % (t1 - t0, sorted(libs), time.monotonic() - t1))
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


def _bucket_size():
    """Trainable elements of ``resnet50_v1`` (1000 classes): the one f32
    bucket the trainer updates (shapes resolved by one CPU forward of a
    zero-initialized net)."""
    import torch
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import vision
    net = vision.resnet50_v1()
    net.initialize(initializer.Zero(), ctx="cpu")
    with torch.no_grad():
        net(torch.zeros(1, 3, 64, 64))
    return sum(p.data().numel() for p in net.collect_params().values()
               if p.grad_req != "null")


def _opt_kernel(name, arrays, lr, case):
    """Wrapper ``name`` on ``(w, g, m, v)``, in place."""
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    clip, wd, rescale, inv, ok = case
    kw = dict(wd=wd, rescale_grad=rescale, clip_gradient=clip,
              inv_scale=inv, ok=ok)
    w, g, m, v = arrays
    if name == "fused_sgd":
        return (fo.fused_sgd(w, g, lr, **kw),)
    if name == "fused_sgd_momentum":
        return fo.fused_sgd_momentum(w, g, m, lr, momentum=0.9, **kw)
    return fo.fused_adam(w, g, m, v, lr, beta1=0.9, beta2=0.999,
                         epsilon=1e-8, **kw)


def _opt_plain(name, arrays, scalars, case):
    """The plain version of wrapper ``name``: new tensors."""
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    clip, wd, rescale, _, _ = case
    kw = dict(wd=wd, rescale_grad=rescale, clip_gradient=clip)
    w, g, m, v = arrays
    if name == "fused_sgd":
        return (fo.fused_sgd_reference(w, g, scalars, **kw),)
    if name == "fused_sgd_momentum":
        return fo.fused_sgd_momentum_reference(w, g, m, scalars,
                                               momentum=0.9, **kw)
    return fo.fused_adam_reference(w, g, m, v, scalars, beta1=0.9,
                                   beta2=0.999, epsilon=1e-8, **kw)


def _placed(t, offset):
    """A copy of ``t`` starting ``offset`` floats into a fresh buffer
    (offset 1: not 16-byte aligned)."""
    import torch
    base = torch.empty(t.numel() + offset, device=t.device)
    out = base[offset:]
    out.copy_(t)
    return out


def _opt_library(name, w, g):
    """One PyTorch optimizer step of the same size (a near-equivalent
    yardstick; the port never calls it)."""
    import torch
    p = torch.nn.Parameter(w.clone())
    p.grad = g.clone()
    if name == "fused_sgd":
        opt = torch.optim.SGD([p], lr=0.05, weight_decay=1e-4, fused=True)
    elif name == "fused_sgd_momentum":
        opt = torch.optim.SGD([p], lr=0.05, momentum=0.9, weight_decay=1e-4,
                              fused=True)
    else:
        opt = torch.optim.Adam([p], lr=1e-3, weight_decay=1e-4, fused=True,
                               capturable=True)
    return opt.step


def phase_opt_kernels(bucket):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(4)
    sizes = [(bucket, 0), (1, 0), (3, 0), (127, 0), (1000003, 0),
             (1000003, 1)]
    out = []
    for name, (per_elem, ops_per_elem, replaces) in OPT_KERNELS.items():
        lr = 1e-3 if name == "fused_adam" else 0.05
        worst = 0.0
        for n, offset in sizes:
            base = [torch.randn(n, device="cuda", generator=gen)
                    for _ in range(4)]
            base[3] = base[3].abs()
            base = [_placed(a, offset) for a in base]
            for case in OPT_CASES:
                s = torch.tensor([lr, case[3], case[4]], device="cuda")
                want = _opt_plain(name, base, s, case)
                runs = []
                for _ in range(2):
                    work = [_placed(a, offset) for a in base]
                    runs.append(_opt_kernel(name, work, lr, case))
                torch.cuda.synchronize()
                slots = {"fused_sgd": (0,), "fused_sgd_momentum": (0, 2),
                         "fused_adam": (0, 2, 3)}[name]
                for got, again, ref, i in zip(runs[0], runs[1], want, slots):
                    if not torch.equal(got, again):
                        raise RuntimeError("%s n=%d: two runs differ"
                                           % (name, n))
                    torch.testing.assert_close(got, ref, rtol=OPT_TOL,
                                               atol=OPT_TOL)
                    worst = max(worst, float((got - ref).abs().max()))
                    if case[4] == 0.0 and not torch.equal(got, base[i]):
                        raise RuntimeError("%s n=%d: ok=0 changed the "
                                           "state" % (name, n))
        # timing at the bucket size, scalars already on the device
        w, g, m, v = (torch.randn(bucket, device="cuda", generator=gen)
                      for _ in range(4))
        v = v.abs()
        case = (None, 1e-4, 1.0, torch.tensor(1.0, device="cuda"),
                torch.tensor(1.0, device="cuda"))
        lr_t = torch.tensor(lr, device="cuda")
        s = torch.tensor([lr, 1.0, 1.0], device="cuda")
        fns = {"kernel": lambda: _opt_kernel(name, (w, g, m, v), lr_t, case),
               "plain": lambda: _opt_plain(name, (w, g, m, v), s, case),
               "library": _opt_library(name, w, g)}
        ms, plain_ms, library_ms = (_time_ms(fns[k], iters=20, replays=5)
                                    for k in ("kernel", "plain", "library"))
        eager = tuple(_call_ms(fns[k], iters=20)
                      for k in ("kernel", "plain", "library"))
        nbytes, flops = per_elem * bucket, ops_per_elem * bucket
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print("phase 4: %s max_abs_err %.3g over sizes %s x %d cases "
              "(tol %g), ok=0 bitwise, reruns bitwise"
              % (name, worst, [n for n, _ in sizes], len(OPT_CASES),
                 OPT_TOL))
        print("phase 4: %s (%d,) device time: kernel %.5f ms, plain %.5f "
              "ms, torch.optim fused %.5f ms; bound %.5f ms (%d bytes, %d "
              "flops); eager call: %.5f / %.5f / %.5f ms"
              % ((name, bucket, ms, plain_ms, library_ms, bound_ms, nbytes,
                  flops) + eager))
        out.append({"name": name, "route": "cuda",
                    "source": "mxnet_tpu_torch/csrc/fused_optimizer.cu",
                    "replaces": replaces, "launches": None,
                    "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "bound_by": "bytes" if bytes_ms >= ops_ms
                    else "operations", "library_ms": library_ms})
        del w, g, m, v, fns
        torch.cuda.empty_cache()
    return out


def _run_steps(trainer, x, y, n):
    import torch
    losses, times = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        loss = trainer.step(x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    if not np.isfinite(losses).all():
        raise RuntimeError("non-finite loss: %r" % losses)
    return losses, times


# kernel-name fragments -> category, first match wins
PROFILE_CATEGORIES = (
    ("fused optimizer (B1-B3)", ("sgd_mom_kernel", "sgd_kernel",
                                 "adam_kernel")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_")),
    ("convolution", ("conv", "xmma", "implicit", "wgrad", "dgrad", "cudnn",
                     "nchw", "nhwc")),
    ("matmul", ("gemm", "cutlass")),
    ("reduction", ("reduce",)),
    ("pooling", ("pool",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
# the TransformerLM step runs no convolution: every GEMM is a matmul
LM_PROFILE_CATEGORIES = (
    ("flash attention (B5-B7)", ("flash_fwd_kernel", "flash_dq_kernel",
                                 "flash_dkv_kernel")),
    ("layer norm (B4)", ("ln_fwd",)),
    ("matmul", ("gemm", "cutlass")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def profile_train(trainer, x, y, steps=2, label="phase 5",
                  categories=PROFILE_CATEGORIES):
    """Device time by kernel category over ``steps`` training steps
    (``torch.profiler``), and the device's idle share of the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    trainer.step(x, y)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.step(x, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels)
    if not kernels:
        print("%s profile: the profiler recorded no device time; "
              "not measured" % label)
        return
    cats = {}
    for e in kernels:
        name = e.key.lower()
        cat = next((c for c, frags in categories
                    if any(f in name for f in frags)), "other")
        cats[cat] = cats.get(cat, 0.0) + e.self_device_time_total
    print("%s profile: %d steps, wall %.2f ms, device busy %.2f ms, "
          "idle share %.4f" % (label, steps, wall_us / 1e3, busy / 1e3,
                               1 - busy / wall_us))
    for cat, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        print("%s profile: %-24s %9.3f ms per step (%.4f of busy)"
              % (label, cat, us / steps / 1e3, us / busy))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print("%s profile: kernel %9.3f ms per step x%-5d %s"
              % (label, e.self_device_time_total / steps / 1e3,
                 e.count // steps, e.key[:110]))


def phase_train(bucket, profile=False):
    import gc
    import torch
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    from mxnet_tpu_torch.parallel import DataParallelTrainer

    print("phase 5: precision flags as found: cudnn.allow_tf32=%s "
          "matmul.allow_tf32=%s float32_matmul_precision=%s "
          "cudnn.benchmark=%s"
          % (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision(),
             torch.backends.cudnn.benchmark))
    rng = np.random.RandomState(0)
    batch = BATCH
    while True:
        net = tr = x = y = None
        try:
            net = vision.resnet50_v1()
            net.initialize(initializer.Xavier(),
                           rng=np.random.RandomState(0))
            tr = DataParallelTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                                     dict(SGD_PARAMS))
            x = torch.from_numpy(
                rng.rand(batch, 3, 224, 224).astype(np.float32)).cuda()
            y = torch.from_numpy(
                (rng.rand(batch) * 1000).astype(np.int64)).cuda()
            torch.cuda.reset_peak_memory_stats()
            fo.reset_launch_counts()
            losses, times = _run_steps(tr, x, y, WARMUP + TIMED)
            counts = fo.launch_counts()
            break
        except torch.cuda.OutOfMemoryError:
            if batch <= 8:
                raise
            del net, tr, x, y
            gc.collect()
            torch.cuda.empty_cache()
            batch //= 2
            print("phase 5: out of memory, batch halved to %d" % batch)
    peak = torch.cuda.max_memory_allocated()
    n_buckets = len(tr._groups)
    got_bucket = tr._w_flat[0].numel()
    steps = WARMUP + TIMED
    if got_bucket != bucket or n_buckets != 1:
        raise RuntimeError("expected one bucket of %d, got %d buckets, the "
                           "first of %d" % (bucket, n_buckets, got_bucket))
    if counts["fused_sgd_momentum"] != steps * n_buckets:
        raise RuntimeError("fused_sgd_momentum launched %d times, want "
                           "%d" % (counts["fused_sgd_momentum"],
                                   steps * n_buckets))
    if not losses[-1] < losses[0]:
        raise RuntimeError("loss did not fall on the repeated batch: %r"
                           % losses)
    timed = np.asarray(times[WARMUP:])
    print("phase 5: resnet50_v1 batch %d, %d trainable params in %d "
          "bucket(s); losses %s" % (batch, got_bucket, n_buckets,
                                     ["%.4f" % v for v in losses]))
    print("phase 5: %.1f images/s over %d timed steps; step p50 %.2f ms, "
          "p99 %.2f ms; warm-up steps %s ms; peak memory %.2f GiB"
          % (batch * TIMED / (timed.sum() / 1e3), TIMED,
             np.percentile(timed, 50), np.percentile(timed, 99),
             ["%.1f" % t for t in times[:WARMUP]], peak / 2 ** 30))
    print("phase 5: launches %s (fused_sgd_momentum = %d steps x %d "
          "bucket)" % (counts, steps, n_buckets))
    launches = {"fused_sgd_momentum": counts["fused_sgd_momentum"]}
    if profile:
        profile_train(tr, x, y)
    del tr
    gc.collect()
    for name, params, wrapper in (
            ("sgd", {"learning_rate": 0.05, "wd": 1e-4}, "fused_sgd"),
            ("adam", {"learning_rate": 1e-3, "wd": 1e-4}, "fused_adam")):
        t2 = DataParallelTrainer(net, SoftmaxCrossEntropyLoss(), name,
                                 params)
        fo.reset_launch_counts()
        ls, ts = _run_steps(t2, x, y, 2)
        c = fo.launch_counts()
        if c[wrapper] != 2 * len(t2._groups):
            raise RuntimeError("%s launched %d times, want %d"
                               % (wrapper, c[wrapper], 2 * len(t2._groups)))
        launches[wrapper] = c[wrapper]
        print("phase 5: %r 2 steps, losses %s, step ms %s, %s launches %d"
              % (name, ["%.4f" % v for v in ls], ["%.1f" % t for t in ts],
                 wrapper, c[wrapper]))
        del t2
        gc.collect()
    del net, x, y
    torch.cuda.empty_cache()
    return launches


def _worst_param_diff(a, b):
    """(max |a - b| over every parameter and moving statistic, its name
    relative to the block prefix)."""
    from mxnet_tpu_torch.gluon.utils import relative_names
    pa, pb = a.collect_params(), b.collect_params()
    ra = relative_names(list(pa.keys()), a.prefix)
    rb = relative_names(list(pb.keys()), b.prefix)
    return max((float((pa[name].data().detach().cpu().double()
                       - pb[rb[rel]].data().detach().cpu().double())
                      .abs().max()), rel) for rel, name in ra.items())


def phase_train_parity():
    import torch
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.utils import from_jax_params
    from mxnet_tpu_torch.parallel import DataParallelTrainer

    net = vision.resnet50_v1()
    net.initialize(initializer.Xavier(), ctx="cpu",
                   rng=np.random.RandomState(1))
    with torch.no_grad():
        net(torch.zeros(1, 3, 224, 224))
    arrays = {n: p.data().detach().numpy().copy()
              for n, p in net.collect_params().items()}
    rng = np.random.RandomState(2)
    x = rng.rand(2, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 1000, 2)

    def train(device, xx, dtype="float32"):
        n = from_jax_params(vision.resnet50_v1(), arrays, device=device)
        n.cast(dtype)
        tr = DataParallelTrainer(n, SoftmaxCrossEntropyLoss(), "sgd",
                                 dict(SGD_PARAMS), device=device)
        losses = [float(tr.step(xx.astype(dtype), y)) for _ in range(2)]
        if not np.isfinite(losses).all():
            raise RuntimeError("non-finite loss on %s: %r" % (device,
                                                            losses))
        return n, losses

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu, l_cpu = train("cpu", x)
        gpu, l_gpu = train(None, x)
        # the rounding floor: the same CPU run on an input one ulp up
        ulp, l_ulp = train("cpu", np.nextafter(x, np.float32(np.inf)))
        cpu64, l_cpu64 = train("cpu", x, "float64")
        gpu64, l_gpu64 = train(None, x, "float64")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    first = abs(l_cpu[0] - l_gpu[0])
    d_gpu, at_gpu = _worst_param_diff(cpu, gpu)
    d_ulp, at_ulp = _worst_param_diff(cpu, ulp)
    d_64, at_64 = _worst_param_diff(cpu64, gpu64)
    dl_64 = max(abs(a - b) for a, b in zip(l_cpu64, l_gpu64))
    print("phase 6: resnet50_v1 batch 2 x 224^2, 2 SGD+momentum steps, TF32 "
          "off; f32 losses cpu %s, cuda %s, cpu one ulp up %s"
          % tuple(["%.6f" % v for v in ls] for ls in (l_cpu, l_gpu, l_ulp)))
    print("phase 6: f32: first-step loss CUDA vs CPU %.3g (tol %g); after 2 "
          "steps max |dparam| CUDA vs CPU %.3g (%s), rounding floor %.3g "
          "(%s), allowed %g x floor"
          % (first, TRAIN_TOL, d_gpu, at_gpu, d_ulp, at_ulp, NOISE_FACTOR))
    print("phase 6: f64: losses cpu %s, cuda %s; max |dloss| %.3g, max "
          "|dparam| %.3g (%s) (tol %g)"
          % (["%.9f" % v for v in l_cpu64], ["%.9f" % v for v in l_gpu64],
             dl_64, d_64, at_64, TRAIN_TOL))
    if first > TRAIN_TOL:
        raise RuntimeError("f32 first-step loss differs by %.3g > %g"
                           % (first, TRAIN_TOL))
    if d_gpu > max(NOISE_FACTOR * d_ulp, TRAIN_TOL):
        raise RuntimeError("f32 parameters differ by %.3g, more than %g x "
                           "the rounding floor %.3g"
                           % (d_gpu, NOISE_FACTOR, d_ulp))
    if dl_64 > TRAIN_TOL or d_64 > TRAIN_TOL:
        raise RuntimeError("f64 CUDA vs CPU training differs: loss %.3g, "
                           "params %.3g (tol %g)" % (dl_64, d_64, TRAIN_TOL))


# -- slice 3: TransformerLM training with ring attention ----------------------
# the path's flash pairings per layer at K = 2, batch 32, 8 heads, T = 1024:
# (BH, Tq, Tk, D, causal) — hop 0 is the diagonal for both ranks, hop 1
# the full pairing of rank 1 with chunk 0
FLASH_PATH = [(2 * TRAIN_LM_BATCH * 8, 512, 512, 16, True),
              (TRAIN_LM_BATCH * 8, 512, 512, 16, False)]
FLASH_CHECK = FLASH_PATH + [(3, 997, 1000, 64, True),
                            (3, 997, 1000, 64, False), (2, 1, 1, 16, True),
                            (4, 300, 300, 128, True)]
# wrapper -> (TPU kernel replaced, f32 operations per visible (q, k) pair
# and head-dim element; each pair adds one expf)
FLASH_KERNELS = {
    "flash_forward_with_lse": ("mxnet_tpu/ops/pallas_kernels.py:62", 4),
    "flash_dq": ("mxnet_tpu/ops/pallas_kernels.py:171", 6),
    "flash_dkv": ("mxnet_tpu/ops/pallas_kernels.py:226", 8),
}


def _pairs(tq, tk, causal):
    """The (q, k) pairs a row-block must visit: q >= k when causal."""
    if not causal:
        return tq * tk
    full = min(tq, tk)
    return full * (full + 1) // 2 + max(0, tq - tk) * tk


def _flash_bound(name, cases):
    """(bound ms, bound_by, flops, bytes) of kernel ``name`` over the
    flash pairings ``cases``: each input read once, each output written
    once; FMAs as 2 operations, one expf per visible pair."""
    flops = nbytes = 0
    for bh, tq, tk, d, causal in cases:
        pairs = _pairs(tq, tk, causal)
        flops += bh * pairs * (FLASH_KERNELS[name][1] * d + 1)
        qside, kside = bh * tq * d, bh * tk * d
        if name == "flash_forward_with_lse":
            nbytes += 4 * (2 * qside + 2 * kside + bh * tq)
        elif name == "flash_dq":
            nbytes += 4 * (3 * qside + 2 * kside + 2 * bh * tq)
        else:
            nbytes += 4 * (2 * qside + 4 * kside + 2 * bh * tq)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", flops, nbytes)


def _event_ms(fn, iters=20):
    """Device time of one ``fn()`` between CUDA events over ``iters``
    eager calls (each call is long against the host's launch cost, so the
    queue stays ahead of the host)."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _flash_inputs(case, gen):
    import torch
    bh, tq, tk, d, causal = case
    q, do = (torch.randn(bh, tq, d, device="cuda", generator=gen)
             for _ in range(2))
    k, v = (torch.randn(bh, tk, d, device="cuda", generator=gen)
            for _ in range(2))
    return q, k, v, do, causal, d ** -0.5


def _sdpa_backend(q, k, v, causal):
    """The name of the attention kernel ``scaled_dot_product_attention``
    ran for these inputs (from one profiled call)."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        torch.cuda.synchronize()
    names = sorted((e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0),
                   key=lambda e: -e.self_device_time_total)
    return names[0].key[:90] if names else "not measured"


def phase_flash_kernels():
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import pallas_kernels as pk

    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = dict.fromkeys(FLASH_KERNELS, 0.0)
    for case in FLASH_CHECK:
        q, k, v, do, causal, scale = _flash_inputs(case, gen)
        want_o, want_lse = pk.flash_forward_with_lse_reference(
            q, k, v, causal, scale)
        delta = pk.flash_delta(want_o, do)
        args = (q, k, v, do, want_lse, delta, causal, scale)
        want_dq = pk.flash_dq_reference(*args)
        want_dk, want_dv = pk.flash_dkv_reference(*args)
        runs = [(pk.flash_forward_with_lse(q, k, v, causal, scale),
                 pk.flash_dq(*args), pk.flash_dkv(*args)) for _ in range(2)]
        torch.cuda.synchronize()
        flat = [torch.cat([t.flatten() for t in r[0] + (r[1],) + r[2]])
                for r in runs]
        if not torch.equal(flat[0], flat[1]):
            raise RuntimeError("flash kernels %s: two runs differ"
                               % (case,))
        (o, lse), dq, (dk, dv) = runs[0]
        errs = []
        for name, got, want, tol in (
                ("flash_forward_with_lse", o, want_o, FLASH_FWD_TOL),
                ("flash_forward_with_lse", lse, want_lse, FLASH_FWD_TOL),
                ("flash_dq", dq, want_dq, FLASH_BWD_TOL),
                ("flash_dkv", dk, want_dk, FLASH_BWD_TOL),
                ("flash_dkv", dv, want_dv, FLASH_BWD_TOL)):
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            errs.append(float((got - want).abs().max()))
            worst[name] = max(worst[name], errs[-1])
        print("phase 7: %s out/lse/dq/dk/dv max_abs_err %s, reruns bitwise"
              % (case, ["%.3g" % e for e in errs]))
        del q, k, v, do, want_o, want_lse, delta, want_dq, want_dk, want_dv
        del runs, flat, o, lse, dq, dk, dv, args
        torch.cuda.empty_cache()

    # timing at the path's shapes: one layer's pairings (hop 0 + hop 1)
    ins = [_flash_inputs(c, gen) for c in FLASH_PATH]
    bwd = []
    for q, k, v, do, causal, scale in ins:
        o, lse = pk.flash_forward_with_lse_reference(q, k, v, causal, scale)
        bwd.append((q, k, v, do, lse, pk.flash_delta(o, do), causal, scale))
    kernel = {
        "flash_forward_with_lse": lambda: [pk.flash_forward_with_lse(
            *a[:3], a[6], a[7]) for a in bwd],
        "flash_dq": lambda: [pk.flash_dq(*a) for a in bwd],
        "flash_dkv": lambda: [pk.flash_dkv(*a) for a in bwd]}
    plain = {
        "flash_forward_with_lse": lambda: [
            pk.flash_forward_with_lse_reference(*a[:3], a[6], a[7])
            for a in bwd],
        "flash_dq": lambda: [pk.flash_dq_reference(*a) for a in bwd],
        "flash_dkv": lambda: [pk.flash_dkv_reference(*a) for a in bwd]}
    # the library yardstick: scaled_dot_product_attention on (1, BH, T, D)
    lib_in = [tuple(t[None].clone().requires_grad_() for t in a[:3])
              + (a[3][None], a[6]) for a in bwd]
    backend = [_sdpa_backend(*a[:3], a[4]) for a in lib_in]
    with torch.no_grad():
        lib_fwd = _event_ms(lambda: [F.scaled_dot_product_attention(
            *a[:3], is_causal=a[4]) for a in lib_in])
    outs = [F.scaled_dot_product_attention(*a[:3], is_causal=a[4])
            for a in lib_in]
    lib_bwd = _event_ms(lambda: [torch.autograd.grad(
        o, a[:3], a[3], retain_graph=True) for o, a in zip(outs, lib_in)])
    library = {"flash_forward_with_lse": lib_fwd, "flash_dq": lib_bwd,
               "flash_dkv": lib_bwd}
    out = []
    for name, (replaces, _) in FLASH_KERNELS.items():
        ms = _event_ms(kernel[name])
        plain_ms = _event_ms(plain[name], iters=5)
        bound_ms, bound_by, flops, nbytes = _flash_bound(name, FLASH_PATH)
        print("phase 7: %s per layer %s: kernel %.5f ms, plain %.5f ms, "
              "library %.5f ms%s; bound %.5f ms (%s: %d flops, %d bytes); "
              "%.1f %% of the bound"
              % (name, FLASH_PATH, ms, plain_ms, library[name],
                 " (B6+B7 together)" if name != "flash_forward_with_lse"
                 else "", bound_ms, bound_by, flops, nbytes,
                 100 * bound_ms / ms))
        out.append({"name": name, "route": "cuda",
                    "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
                    "replaces": replaces, "launches": None,
                    "max_abs_err": worst[name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library[name]})
    print("phase 7: library scaled_dot_product_attention (f32) ran %s"
          % backend)
    print("phase 7: tolerances out/lse %g, dq/dk/dv %g; worst %s"
          % (FLASH_FWD_TOL, FLASH_BWD_TOL,
             {k: "%.3g" % v for k, v in worst.items()}))
    del ins, bwd, lib_in, outs
    torch.cuda.empty_cache()
    return out


def _markov_corpus(vocab, length, seed=7):
    """The bench's seeded Markov corpus (``mxnet_tpu/transformer/
    bench.py:31-40``): each token's successor is a fixed permutation 80 %
    of the time, uniform otherwise."""
    rng = np.random.RandomState(seed)
    succ = rng.permutation(vocab)
    out = np.empty(length, np.int32)
    tok = 0
    for i in range(length):
        out[i] = tok
        tok = int(succ[tok]) if rng.rand() < 0.8 \
            else int(rng.randint(vocab))
    return out


def _lm_batches(n, batch, seed=11):
    corpus = _markov_corpus(CFG["vocab_size"], 1 << 16)
    rng = np.random.RandomState(seed)
    hi = len(corpus) - CFG["seq_len"] - 1
    out = []
    for _ in range(n):
        starts = rng.randint(0, hi, size=batch)
        out.append((np.stack([corpus[s:s + CFG["seq_len"]] for s in starts]),
                    np.stack([corpus[s + 1:s + CFG["seq_len"] + 1]
                              for s in starts])))
    return out


def _lm_trainer(plan, device=None):
    from mxnet_tpu_torch.parallel import DataParallelTrainer
    from mxnet_tpu_torch.transformer import TransformerLM, TransformerLMConfig
    return DataParallelTrainer(
        TransformerLM(TransformerLMConfig(**CFG, attention="ring")), None,
        "sgd", dict(LM_SGD), mesh_plan=plan, device=device)


def phase_train_lm(profile=False):
    import torch
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    from mxnet_tpu_torch.ops import pallas_kernels as pk
    from mxnet_tpu_torch.parallel import MeshPlan

    print("phase 8: precision flags as found: matmul.allow_tf32=%s "
          "float32_matmul_precision=%s"
          % (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision()))
    k_ranks = 2
    steps = WARMUP + TIMED
    batches = [tuple(torch.from_numpy(a).cuda() for a in b)
               for b in _lm_batches(steps, TRAIN_LM_BATCH)]
    tr = _lm_trainer(MeshPlan(sequence=k_ranks))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pk.reset_launch_counts()
    fo.reset_launch_counts()
    losses, times = [], []
    for x, y in batches:
        t0 = time.perf_counter()
        loss = tr.step(x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    flash, ln = pk.launch_counts(), fo.launch_counts()["fused_layer_norm"]
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all():
        raise RuntimeError("non-finite loss: %r" % losses)
    if not losses[-1] < losses[0]:
        raise RuntimeError("loss did not fall: %r" % losses)
    want = steps * CFG["n_layers"] * k_ranks
    if any(flash[n] != want for n in FLASH_KERNELS):
        raise RuntimeError("flash launches %s, want %d each (steps x layers "
                           "x hops)" % (flash, want))
    if ln < steps * (2 * CFG["n_layers"] + 1):
        raise RuntimeError("fused_layer_norm launched %d times, want >= %d"
                           % (ln, steps * (2 * CFG["n_layers"] + 1)))
    if tr._mesh_program.attention_mode != "ring":
        raise RuntimeError("attention mode %s"
                           % tr._mesh_program.attention_mode)
    timed = np.asarray(times[WARMUP:])
    tokens = TRAIN_LM_BATCH * CFG["seq_len"]
    print("phase 8: TransformerLM %s, MeshPlan(sequence=%d), batch %d x %d "
          "tokens; losses %s" % (CFG, k_ranks, TRAIN_LM_BATCH, CFG["seq_len"],
                                 ["%.4f" % v for v in losses]))
    print("phase 8: %.1f tokens/s over %d timed steps; step p50 %.2f ms, "
          "p99 %.2f ms; warm-up steps %s ms; peak memory %.3f GiB (%.3f "
          "GiB of it held before the first step)"
          % (tokens * TIMED / (timed.sum() / 1e3), TIMED,
             np.percentile(timed, 50), np.percentile(timed, 99),
             ["%.1f" % t for t in times[:WARMUP]], peak / 2 ** 30,
             held / 2 ** 30))
    print("phase 8: launches %s = %d steps x %d layers x %d hops each; "
          "fused_layer_norm %d (>= %d)" % (flash, steps, CFG["n_layers"],
                                           k_ranks, ln,
                                           steps * (2 * CFG["n_layers"] + 1)))
    if profile:
        x, y = batches[-1]
        profile_train(tr, x, y, label="phase 8",
                      categories=LM_PROFILE_CATEGORIES)
    del tr, batches
    torch.cuda.empty_cache()
    return flash


def phase_train_lm_parity():
    import torch
    from mxnet_tpu_torch.parallel import MeshPlan

    (x, y), = _lm_batches(1, 2, seed=13)
    runs = {}
    for key, plan, device in (("seq2_cuda", MeshPlan(sequence=2), None),
                              ("seq2_cpu", MeshPlan(sequence=2), "cpu"),
                              ("collapsed_cuda", MeshPlan(), None)):
        tr = _lm_trainer(plan, device)
        losses = [float(tr.step(x, y)) for _ in range(2)]
        if not np.isfinite(losses).all():
            raise RuntimeError("%s: non-finite loss %r" % (key, losses))
        runs[key] = (losses, tr.mesh_params())
        del tr
    torch.cuda.empty_cache()

    def diff(a, b):
        dl = max(abs(p - q) for p, q in zip(runs[a][0], runs[b][0]))
        dp = max((float(np.abs(runs[a][1][n] - runs[b][1][n]).max()), n)
                 for n in runs[a][1])
        return dl, dp

    (dl_dev, dp_dev), (dl_seq, dp_seq) = (diff("seq2_cuda", "seq2_cpu"),
                                          diff("seq2_cuda", "collapsed_cuda"))
    print("phase 9: 2 steps on batch 2 x %d, losses %s"
          % (CFG["seq_len"], {k: ["%.7f" % v for v in r[0]]
                              for k, r in runs.items()}))
    print("phase 9: sequence=2 CUDA vs CPU: max |dloss| %.3g (tol %g), max "
          "|dparam| %.3g (%s) (tol %g)" % (dl_dev, LM_LOSS_TOL_DEVICE,
                                           dp_dev[0], dp_dev[1],
                                           LM_PARAM_TOL))
    print("phase 9: sequence=2 vs collapsed on the card: max |dloss| %.3g "
          "(tol %g), max |dparam| %.3g (%s) (tol %g)"
          % (dl_seq, LM_LOSS_TOL_SEQ, dp_seq[0], dp_seq[1], LM_PARAM_TOL))
    if dl_dev > LM_LOSS_TOL_DEVICE or dl_seq > LM_LOSS_TOL_SEQ:
        raise RuntimeError("losses differ: CUDA vs CPU %.3g, sequence=2 vs "
                           "collapsed %.3g" % (dl_dev, dl_seq))
    if dp_dev[0] > LM_PARAM_TOL or dp_seq[0] > LM_PARAM_TOL:
        raise RuntimeError("parameters differ: CUDA vs CPU %.3g, "
                           "sequence=2 vs collapsed %.3g"
                           % (dp_dev[0], dp_seq[0]))


# -- slice 4: int8 ResNet-50 serving with qmm_requant (B8) --------------------
def _qmm_path_shapes(batch):
    """(M, K, N) of the 16 B8 launches of one int8 ResNet-50 (NHWC)
    forward at ``batch``: each bottleneck's conv ``a`` (the stride-2 ones
    sliced first), 224 x 224 input."""
    shapes = []
    for stage, (units, width, side) in enumerate(
            [(3, 64, 56), (4, 128, 28), (6, 256, 14), (3, 512, 7)]):
        m = batch * side * side
        shapes.append((m, width if stage == 0 else 2 * width, width))
        shapes += [(m, 4 * width, width)] * (units - 1)
    return shapes


def _qmm_bound(shapes):
    """(bound ms, bound_by) of B8 over ``shapes``: x, w, bias read once,
    the int8 output written once; 2 int8 operations per multiply-add."""
    nbytes = sum(m * k + n * k + 4 * n + m * n for m, k, n in shapes)
    ops = sum(2 * m * k * n for m, k, n in shapes)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT8_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, ops)


def _qmm_inputs(shape, gen):
    import torch
    m, k, n = shape
    x = torch.randint(-127, 128, (m, k), device="cuda", dtype=torch.int8,
                      generator=gen)
    w = torch.randint(-127, 128, (n, k), device="cuda", dtype=torch.int8,
                      generator=gen)
    bias = torch.randn(n, device="cuda", generator=gen) * 10
    # codes spread over the int8 range: acc has std ~ sqrt(K) * 127**2 / 3
    scale = 60.0 / (np.sqrt(k) * 127 * 127 / 3)
    return x, w, bias, scale


def phase_qmm_kernel():
    import torch
    from mxnet_tpu_torch.ops import pallas_kernels as pk
    from mxnet_tpu_torch.ops.quantization import int8_dot

    gen = torch.Generator(device="cuda").manual_seed(10)
    path = _qmm_path_shapes(QBATCH)
    worst = 0
    for shape in path + QMM_RAGGED:
        for relu in (True, False):
            x, w, bias, scale = _qmm_inputs(shape, gen)
            got = pk.qmm_requant(x, w, bias, scale, relu=relu)
            again = pk.qmm_requant(x, w, bias, scale, relu=relu)
            want = pk.qmm_requant_reference(x, w, bias, scale, relu=relu)
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max())
            worst = max(worst, err)
            if not torch.equal(got, want) or not torch.equal(got, again):
                raise RuntimeError("qmm_requant %s relu=%s: %d codes differ "
                                   "from the plain version, rerun equal %s"
                                   % (shape, relu, int((got != want).sum()),
                                      torch.equal(got, again)))
        del x, w, got, again, want
    print("phase 10: qmm_requant bitwise equal to its plain version and to "
          "a rerun at the %d path shapes of batch %d and %s, relu on and "
          "off" % (len(path), QBATCH, QMM_RAGGED))
    times = {"kernel": 0.0, "plain": 0.0, "library": 0.0}
    for shape in path:
        x, w, bias, scale = _qmm_inputs(shape, gen)
        fns = {"kernel": lambda: pk.qmm_requant(x, w, bias, scale),
               "plain": lambda: pk.qmm_requant_reference(x, w, bias, scale),
               "library": lambda: pk._requant(int8_dot(x, w), scale, bias,
                                              True)}
        for key, fn in fns.items():
            times[key] += _event_ms(fn, iters=10)
        del x, w, fns
        torch.cuda.empty_cache()
    bound_ms, bound_by, nbytes, ops = _qmm_bound(path)
    print("phase 10: one forward's 16 launches (batch %d), device time: "
          "kernel %.5f ms, plain %.5f ms, torch._int_mm + torch epilogue "
          "%.5f ms; bound %.5f ms (%s: %d bytes, %d int8 operations)"
          % (QBATCH, times["kernel"], times["plain"], times["library"],
             bound_ms, bound_by, nbytes, ops))
    return {"name": "qmm_requant", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/qmm_requant.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:436",
            "launches": None, "max_abs_err": worst, "ms": times["kernel"],
            "plain_ms": times["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": times["library"]}


def _images(n, seed):
    return np.random.RandomState(seed).rand(n, QSIDE, QSIDE, 3) \
        .astype(np.float32)


def _quantized_resnet50(ctx, calib, classes=QCLASSES, calib_batch=32):
    """The fp32 ResNet-50 (NHWC) with Xavier weights from RandomState(0)
    on ``ctx``, and ``ptq_quantize_module`` of it over ``calib``."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch import io as tio
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.serving.quantize import ptq_quantize_module
    from mxnet_tpu_torch.symbol.models import resnet_symbol

    net = resnet_symbol(50, num_classes=classes, layout="NHWC")
    mod = Module(net, context=ctx)
    mod.bind([("data", (calib_batch, QSIDE, QSIDE, 3))],
             [("softmax_label", (calib_batch,))], for_training=False)
    mod.init_params(initializer.Xavier(), rng=np.random.RandomState(0))
    arg, aux = mod.get_params()
    it = tio.NDArrayIter(calib, np.zeros(len(calib), np.float32),
                         calib_batch)
    return (net, arg, aux) + ptq_quantize_module(
        net, arg, aux, it, num_calib_examples=len(calib))


def _int8_module(qsym, qarg, qaux, batch, ctx=None):
    from mxnet_tpu_torch.module import Module
    qmod = Module(qsym, context=ctx)
    qmod.bind([("data", (batch, QSIDE, QSIDE, 3))], for_training=False)
    qmod.set_params(qarg, qaux, allow_extra=True)
    return qmod


QPROFILE_CATEGORIES = (
    ("qmm_requant (B8)", ("qmm_requant_kernel",)),
    ("int8 GEMM (torch._int_mm)", ("gemm", "cutlass", "imma", "xmma")),
    ("im2col / layout copies", ("cat", "copy", "pad")),
    ("reduction", ("reduce",)),
    ("pooling", ("pool",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _profile_calls(label, fn, categories, per, steps=2, top=14):
    """Device time by kernel category over ``steps`` calls of ``fn``
    (warmed up by one call), and the device's idle share of the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        print("%s: the profiler recorded no device time; not measured"
              % label)
        return
    busy = sum(e.self_device_time_total for e in kernels)
    cats = {}
    for e in kernels:
        name = e.key.lower()
        cat = next((c for c, frags in categories
                    if any(f in name for f in frags)), "other")
        cats[cat] = cats.get(cat, 0.0) + e.self_device_time_total
    print("%s: %d calls (one %s each), wall %.2f ms, device busy %.2f ms, "
          "idle share %.4f" % (label, steps, per, wall_us / 1e3, busy / 1e3,
                               1 - busy / wall_us))
    for cat, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        print("%s: %-28s %9.3f ms per %s (%.4f of busy)"
              % (label, cat, us / steps / 1e3, per, us / busy))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print("%s: kernel %9.3f ms per %s x%-5d %s"
              % (label, e.self_device_time_total / steps / 1e3, per,
                 e.count // steps, e.key[:110]))


def profile_forward(qmod, batch, steps=2):
    """Device time by kernel category over ``steps`` int8 forwards, and
    the device's idle share of the window."""
    _profile_calls("phase 11 profile",
                   lambda: qmod.forward(batch, is_train=False),
                   QPROFILE_CATEGORIES, "forward", steps)


def phase_int8_serve(profile=False):
    import os
    from collections import Counter

    import torch
    from mxnet_tpu_torch import io as tio
    from mxnet_tpu_torch import ndarray as tnd
    from mxnet_tpu_torch.ops import pallas_kernels as pk
    from mxnet_tpu_torch.serving import ModelFleet, ModelRunner, Server

    os.environ["MXTPU_FUSE_QCONV"] = "1"
    os.environ["MXTPU_PALLAS_QMM"] = "1"
    t0 = time.monotonic()
    net, arg, aux, qsym, qarg, qaux, report = _quantized_resnet50(
        None, _images(QCALIB, 1))
    ops = Counter(n.op for n in qsym._nodes() if n.op)
    print("phase 11: resnet_symbol(50, %d classes, NHWC) quantized over %d "
          "images in %.2f s; nodes %s; digest %s"
          % (QCLASSES, QCALIB, time.monotonic() - t0, dict(sorted(
              ops.items())), report["digest"][:16]))
    for op, want in (("_contrib_quantized_conv_requant", 33),
                     ("_contrib_quantized_conv", 20),
                     ("_contrib_quantized_pooling", 2),
                     ("_contrib_quantized_fully_connected", 1)):
        if ops[op] != want:
            raise RuntimeError("%s: %d nodes, want %d" % (op, ops[op], want))
    qmod = _int8_module(qsym, qarg, qaux, QBATCH)
    t0 = time.monotonic()
    runner = ModelRunner(qmod, buckets=QBUCKETS)
    print("phase 11: %r warmed in %.2f s" % (runner, time.monotonic() - t0))
    rng = np.random.RandomState(2)
    reqs = [rng.rand(1 + i % 4, QSIDE, QSIDE, 3).astype(np.float32)
            for i in range(Q_REQUESTS)]
    refs = [np.stack([runner.forward_batch(r[j:j + 1])[0]
                      for j in range(len(r))]) for r in reqs]
    fleet = ModelFleet(batch_timeout_ms=5.0)
    fleet.register("resnet50_int8", runner)
    srv = Server(fleet, port=0, max_body_bytes=64 << 20)
    host, port = srv.start()
    url = "http://%s:%d/predict" % (host, port)
    results = [None] * Q_REQUESTS
    tiers = ("gold", "silver", "bronze")

    def fire(i):
        results[i] = _post(url, {"data": reqs[i].tolist(),
                                 "model": "resnet50_int8",
                                 "tier": tiers[i % 3]})

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(Q_REQUESTS)]
    try:
        pk.reset_launch_counts()
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.monotonic() - t0
    finally:
        srv.drain(timeout=120)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a /predict request did not return")
    bitwise = True
    for i, ((code, body), ref) in enumerate(zip(results, refs)):
        if code != 200:
            raise RuntimeError("request %d: HTTP %d %r" % (i, code, body))
        got = np.asarray(body["outputs"], np.float32)
        bitwise = bitwise and np.array_equal(got, ref)
        if not (np.abs(got - ref).max() <= 1e-6
                and (got.argmax(1) == ref.argmax(1)).all()):
            raise RuntimeError("request %d: served answer differs from "
                               "forward_batch by %.3g" % (
                                   i, np.abs(got - ref).max()))
    if runner.recompiles_since_warmup() != 0:
        raise RuntimeError("recompiles after warmup: %r"
                           % (runner.jit_cache_keys() - runner._warm_keys))
    served_batches = fleet.batcher("resnet50_int8").stats.batches_total
    n_images = sum(len(r) for r in reqs)
    print("phase 11: %d concurrent POST /predict (%d images, tiers mixed) "
          "all 200, equal to forward_batch %s; recompiles 0; %d batches, "
          "%.2f s wall (%.1f images/s, HTTP and JSON included)"
          % (Q_REQUESTS, n_images, "bitwise" if bitwise else "within 1e-6",
             served_batches, wall, n_images / wall))

    # throughput: Module.forward at the bench's batch (bench.py:1033-1062)
    batch = tio.DataBatch([tnd.array(_images(QBATCH, 3))])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(WARMUP + QTIMED):
        t0 = time.perf_counter()
        qmod.forward(batch, is_train=False)
        out = qmod.get_outputs()[0]._data
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = pk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not torch.isfinite(out).all() or tuple(out.shape) != (QBATCH,
                                                            QCLASSES):
        raise RuntimeError("int8 forward gave %s, finite %s"
                           % (tuple(out.shape), bool(torch.isfinite(out)
                                                     .all())))
    forwards = served_batches + WARMUP + QTIMED
    if counts["qmm_requant"] != 16 * forwards:
        raise RuntimeError("qmm_requant launched %d times, want 16 x %d "
                           "forwards" % (counts["qmm_requant"], forwards))
    timed = np.asarray(times[WARMUP:])
    print("phase 11: batch %d: %.1f images/s over %d timed forwards; p50 "
          "%.2f ms, p99 %.2f ms; warm-up %s ms; peak memory %.2f GiB"
          % (QBATCH, QBATCH * QTIMED / (timed.sum() / 1e3), QTIMED,
             np.percentile(timed, 50), np.percentile(timed, 99),
             ["%.1f" % t for t in times[:WARMUP]], peak / 2 ** 30))
    print("phase 11: launches %s (qmm_requant = 16 x %d forwards: %d served "
          "batches + %d)" % (counts, forwards, served_batches,
                             WARMUP + QTIMED))
    if profile:
        profile_forward(qmod, batch)
    del runner, qmod, fleet, batch
    torch.cuda.empty_cache()
    return counts["qmm_requant"], (net, arg, aux, qsym, qarg, qaux)


def _calib_ranges(qsym):
    return {(n.name, k): float(v) for n in qsym._nodes()
            for k, v in n.attrs.items()
            if k in ("min_calib_range", "max_calib_range")}


def phase_int8_parity(model):
    import os

    import torch
    from mxnet_tpu_torch import io as tio
    from mxnet_tpu_torch import ndarray as tnd
    from mxnet_tpu_torch.contrib.quantization import quantize_model

    net, arg, aux, qsym, qarg, qaux = model
    x = _images(PARITY_IMAGES, 4)
    probs = {}
    for dev in ("cuda", "cpu"):
        q_arg = {k: v.as_in_context(dev) for k, v in qarg.items()}
        q_aux = {k: v.as_in_context(dev) for k, v in qaux.items()}
        qmod = _int8_module(qsym, q_arg, q_aux, PARITY_IMAGES, ctx=dev)
        qmod.forward(tio.DataBatch([tnd.array(x, ctx="cpu")]),
                     is_train=False)
        probs[dev] = qmod.get_outputs()[0].asnumpy()
    dp = float(np.abs(probs["cuda"] - probs["cpu"]).max())
    top1 = (probs["cuda"].argmax(1) == probs["cpu"].argmax(1)).all()
    print("phase 12: int8 forward of %d images, CUDA vs CPU: top-1 %s, max "
          "|dprob| %.3g (tol %g)" % (PARITY_IMAGES, probs["cuda"].argmax(1),
                                     dp, PROB_TOL))
    if not top1 or dp > PROB_TOL:
        raise RuntimeError("int8 CUDA vs CPU: top-1 equal %s, max |dprob| "
                           "%.3g" % (top1, dp))
    calib = _images(CALIB_PARITY_IMAGES, 5)
    ranges = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cuda", "cpu"):
            it = tio.NDArrayIter(calib, np.zeros(len(calib), np.float32),
                                 len(calib))
            qs, _, _ = quantize_model(
                net, {k: v.as_in_context(dev) for k, v in arg.items()},
                {k: v.as_in_context(dev) for k, v in aux.items()},
                calib_data=it, num_calib_examples=len(calib))
            ranges[dev] = _calib_ranges(qs)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    if set(ranges["cuda"]) != set(ranges["cpu"]):
        raise RuntimeError("the two calibrations rewrote different nodes")
    worst = max(abs(ranges["cuda"][k] - v) / max(abs(v), 1e-30)
                for k, v in ranges["cpu"].items() if v or ranges["cuda"][k])
    print("phase 12: %d calibrated ranges over %d images, CUDA (TF32 off) vs "
          "CPU: max relative difference %.3g (tol %g)"
          % (len(ranges["cpu"]), len(calib), worst, RANGE_RTOL))
    if worst > RANGE_RTOL:
        raise RuntimeError("calibrated ranges differ by %.3g relative"
                           % worst)


# -- slice 5: conv3x3_epilogue (B9) through the conv A/B harness ---------------
def _conv_inputs(shape, cout, route, gen):
    """Seeded ``(x, w, scale, shift)`` on the card.  int8: the harness's
    ranges, with a scale that spreads the codes over the int8 range (acc
    has std ~ sqrt(9 Cin) x 73.6 x 9.2); bf16 / float32: the harness's."""
    import torch
    c = shape[-1]
    dev = "cuda"
    if route == "int8":
        x = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev,
                          generator=gen)
        wt = torch.randint(-16, 16, (3, 3, c, cout), dtype=torch.int8,
                           device=dev, generator=gen)
        spread = 60.0 / (np.sqrt(9 * c) * 73.6 * 9.2)
        scale = (torch.rand(cout, device=dev, generator=gen) + 0.5) * spread
        shift = torch.randn(cout, device=dev, generator=gen) * 10
        return x, wt, scale, shift
    dtype = torch.bfloat16 if route == "bf16" else torch.float32
    x = torch.randn(shape, device=dev, generator=gen).to(dtype)
    wt = (torch.randn((3, 3, c, cout), device=dev, generator=gen)
          * 0.05).to(dtype)
    scale = torch.rand(cout, device=dev, generator=gen) + 0.5
    shift = torch.randn(cout, device=dev, generator=gen)
    return x, wt, scale, shift


def _bf16_ulp(v):
    """One bf16 ulp at |v| (float32): 2^(exponent - 7), normals only."""
    import torch
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def _bf16_ulps(got, want):
    """|got - want| in bf16 ulps at max(|got|, |want|), magnitudes below
    CONV_BF16_FLOOR x rms(want) taken at that floor: there a bf16 ulp is
    finer than the rounding of the float32 sums themselves."""
    import torch
    g, w = got.float(), want.float()
    floor = CONV_BF16_FLOOR * float(w.square().mean().sqrt())
    mag = torch.maximum(torch.maximum(g.abs(), w.abs()),
                        torch.full_like(w, floor))
    return (g - w).abs() / _bf16_ulp(mag)


def _conv_check(pk, shape, cout, route, relu, gen):
    """B9 against its plain version (float64 sums) on one case: int8
    bitwise, bf16 within one bf16 ulp (:func:`_bf16_ulps`), float32
    within CONV_F32_TOL relative; a rerun bitwise equal.  Returns (max
    absolute error, bf16 ulps or 0, outputs beyond one strict bf16 ulp)."""
    import torch
    x, w, scale, shift = _conv_inputs(shape, cout, route, gen)
    got = pk.conv3x3_epilogue(x, w, scale, shift, relu=relu)
    again = pk.conv3x3_epilogue(x, w, scale, shift, relu=relu)
    want = pk.conv3x3_epilogue_reference(x, w, scale, shift, relu=relu)
    torch.cuda.synchronize()
    case = "conv3x3_epilogue %s -> %d %s relu=%s" % (shape, cout, route,
                                                     relu)
    if got.dtype != want.dtype or got.shape != want.shape \
            or not torch.equal(got, again):
        raise RuntimeError("%s: %s %s vs %s %s, rerun bitwise %s"
                           % (case, got.dtype, tuple(got.shape), want.dtype,
                              tuple(want.shape), torch.equal(got, again)))
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if route == "int8":
        if not torch.equal(got, want):
            raise RuntimeError("%s: %d codes differ from the plain version"
                               % (case, int((got != want).sum())))
        return err, 0.0, 0
    if route == "bf16":
        ulps = float(_bf16_ulps(got, want).max())
        strict = int((diff > _bf16_ulp(torch.maximum(
            got.float().abs(), want.float().abs()))).sum())
        if ulps > 1.0:
            raise RuntimeError("%s: outputs beyond one bf16 ulp (worst %.3g "
                               "ulps, %.3g absolute)" % (case, ulps, err))
        return err, ulps, strict
    tol = CONV_F32_TOL * max(1.0, float(want.abs().max()))
    if err > tol:
        raise RuntimeError("%s: max |diff| %.3g above %.3g"
                           % (case, err, tol))
    return err, 0.0, 0


def _conv_bound(stages, batch, route):
    """(bound ms, bound_by, bytes, operations) of one pass of B9 over the
    harness's ``stages`` (Cin = Cout = C): x, w, scale and shift read
    once, the output (the input's dtype) written once; 2 operations per
    multiply-add.  Each stage is bound by the larger of its two times;
    ``bound_by`` names the kind that bounds most of the sum."""
    es, peak = (1, INT8_OPS_PER_S) if route == "int8" \
        else (2, BF16_FLOPS_PER_S)
    total = by_bytes = 0.0
    nbytes = ops = 0
    for h, w, c in stages:
        m = batch * h * w
        b = es * (2 * m * c + 9 * c * c) + 8 * c
        o = 2 * m * 9 * c * c
        b_ms, o_ms = b / HBM_BYTES_PER_S * 1e3, o / peak * 1e3
        total += max(b_ms, o_ms)
        by_bytes += b_ms if b_ms >= o_ms else 0.0
        nbytes, ops = nbytes + b, ops + o
    return (total, "bytes" if by_bytes > total / 2 else "operations",
            nbytes, ops)


CONV_PROFILE_CATEGORIES = (
    ("conv3x3_epilogue (B9)", ("conv3x3_kernel",)),
    ("cuDNN convolution", ("fprop", "conv", "implicit")),
    ("int8 GEMM (torch._int_mm)", ("gemm", "cutlass", "imma", "xmma")),
    ("im2col / layout copies", ("cat", "copy", "pad")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def phase_conv_kernel(profile=False):
    """Phase 13: B9 against its plain version, then one pass of the four
    harness stages timed per route: kernel, plain, library.  With
    ``profile``, the device time by category of one pass of the library
    route and of B9."""
    import torch
    from mxnet_tpu_torch.ops import pallas_kernels as pk
    from mxnet_tpu_torch.tools import conv_ab

    gen = torch.Generator(device="cuda").manual_seed(13)
    worst = {"int8": 0.0, "bf16": 0.0, "float32": 0.0}
    ulps = strict = outputs = 0
    stages = [((CONV_BATCH, h, w, c), c) for h, w, c in conv_ab.STAGES]
    checks = [(r, shape, cout) for r in ("int8", "bf16")
              for shape, cout in stages + CONV_RAGGED]
    for route, shape, cout in checks + [("float32",) + CONV_F32]:
        for relu in (True, False):
            err, u, n = _conv_check(pk, shape, cout, route, relu, gen)
            worst[route] = max(worst[route], err)
            if route == "bf16":
                ulps, strict = max(ulps, u), strict + n
                outputs += int(np.prod(shape[:-1])) * cout
        torch.cuda.empty_cache()
    print("phase 13: conv3x3_epilogue int8 bitwise equal to its plain "
          "version and to a rerun at the 4 harness stages of batch %d and "
          "%s, relu on and off (worst code difference %g)"
          % (CONV_BATCH, [(tuple(s), c) for s, c in CONV_RAGGED],
             worst["int8"]))
    print("phase 13: bf16 there within one bf16 ulp (floor %g x rms): worst "
          "%.4g ulps, max |diff| %.4g; %d of %d outputs beyond one ulp at "
          "their own magnitude; reruns bitwise"
          % (CONV_BF16_FLOOR, ulps, worst["bf16"], strict, outputs))
    print("phase 13: float32 at %s within %g relative: max |diff| %.4g"
          % (CONV_F32, CONV_F32_TOL, worst["float32"]))
    library = {"int8": conv_ab.library_int8, "bf16": conv_ab.library_bf16}
    out = []
    for route in ("int8", "bf16"):
        times = {"kernel": 0.0, "plain": 0.0, "library": 0.0}
        for shape, cout in stages:
            x, w, scale, shift = _conv_inputs(shape, cout, route, gen)
            fns = {"kernel": lambda: pk.conv3x3_epilogue(x, w, scale, shift),
                   "plain": lambda: pk.conv3x3_epilogue_reference(
                       x, w, scale, shift),
                   "library": lambda: library[route](x, w, scale, shift)}
            for key, fn in fns.items():
                times[key] += _event_ms(fn, iters=2 if key == "plain"
                                        else 10)
            del x, w, fns
            torch.cuda.empty_cache()
        bound_ms, bound_by, nbytes, ops = _conv_bound(conv_ab.STAGES,
                                                      CONV_BATCH, route)
        print("phase 13: %s, one pass of the 4 stages (batch %d), device "
              "time: kernel %.5f ms, plain %.5f ms, library %s %.5f ms; "
              "bound %.5f ms (%s: %d bytes, %d operations); %.1f %% of the "
              "bound"
              % (route, CONV_BATCH, times["kernel"], times["plain"],
                 "int8_conv (im2col + torch._int_mm) + torch epilogue"
                 if route == "int8" else "F.conv2d (cuDNN, bf16 sums "
                 "rounded before the epilogue) + torch epilogue",
                 times["library"], bound_ms, bound_by, nbytes, ops,
                 100 * bound_ms / times["kernel"]))
        if profile:
            ins = [_conv_inputs(shape, cout, route, gen)
                   for shape, cout in stages]
            for impl, fn in (("library", library[route]),
                             ("kernel", pk.conv3x3_epilogue)):
                _profile_calls("phase 13 profile %s %s" % (route, impl),
                               lambda: [fn(*a) for a in ins],
                               CONV_PROFILE_CATEGORIES, "pass", top=8)
            del ins
            torch.cuda.empty_cache()
        out.append({"name": "conv3x3_epilogue[%s]" % route, "route": "cuda",
                    "source": "mxnet_tpu_torch/csrc/conv3x3_epilogue.cu",
                    "replaces": "mxnet_tpu/ops/pallas_kernels.py:596",
                    "launches": None, "max_abs_err": worst[route],
                    "ms": times["kernel"], "plain_ms": times["plain"],
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": times["library"]})
    return out


def phase_conv_path():
    """Phase 14: the conv A/B harness at batch 256 on the card; returns
    B9's launches there by route."""
    from mxnet_tpu_torch.ops import pallas_kernels as pk
    from mxnet_tpu_torch.tools import conv_ab

    argv = ["--batch", str(CONV_BATCH), "--iters", str(CONV_ITERS)]
    pk.reset_launch_counts()
    t0 = time.monotonic()
    recs = conv_ab.main(argv)
    counts = pk.launch_counts()
    wall = time.monotonic() - t0
    want = len(conv_ab.STAGES) * 2 * 2
    bad = [r for r in recs if "ms" not in r]
    if len(recs) != want or bad:
        raise RuntimeError("conv_ab %s: %d records (want %d), without ms: %s"
                           % (argv, len(recs), want, bad))
    per_route = len(conv_ab.STAGES) * (1 + CONV_ITERS)
    launches = {r: counts["conv3x3_epilogue[%s]" % r] for r in ("int8",
                                                                "bf16")}
    if counts["conv3x3_epilogue"] != 2 * per_route \
            or any(v != per_route for v in launches.values()):
        raise RuntimeError("conv3x3_epilogue launched %s times in the "
                           "harness, want %d per route"
                           % (counts, per_route))
    for lib, ker in zip(recs[::2], recs[1::2]):
        print("phase 14: %s %s: kernel %.5f ms, library %.5f ms (%.2fx), "
              "%.1f images/s" % (tuple(ker["stage"]), ker["dtype"],
                                 ker["ms"], lib["ms"], lib["ms"] / ker["ms"],
                                 ker["img_per_s"]))
    print("phase 14: conv_ab %s: %d records in %.2f s; conv3x3_epilogue "
          "launched %d times (int8 %d, bf16 %d = 4 stages x (1 warm-up + "
          "%d))" % (" ".join(argv), len(recs), wall,
                    counts["conv3x3_epilogue"], launches["int8"],
                    launches["bf16"], CONV_ITERS))
    return launches

def _gen_inputs(lk, dev="cuda"):
    import torch
    from mxnet_tpu_torch.analysis import codegen as cg
    return [torch.as_tensor(x).to(dev)
            for x in cg.seeded_inputs(lk.in_avals, cg.EQUIV_SEED)]


def _gen_check(gk, xs, block_rows=None):
    """The kernel against the twin on the card (rerun bitwise); returns
    the max |diff| over float outputs."""
    import torch
    from mxnet_tpu_torch.analysis import codegen as cg
    from mxnet_tpu_torch.ops import generated_kernels as gen
    got = gen.generated_call(gk, *xs, block_rows=block_rows)
    torch.cuda.synchronize()
    ok, err = cg.compare_outputs(got, cg.reference_outputs(gk.lowered, xs),
                                 GEN_TOL)
    if not ok:
        raise RuntimeError("%s (block_rows %s) differs from its twin: max "
                           "|diff| %g" % (gk.name, block_rows, err))
    again = gen.generated_call(gk, *xs, block_rows=block_rows)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError("%s (block_rows %s): a rerun is not bitwise "
                           "equal" % (gk.name, block_rows))
    return err


def _sweep_ir():
    """A synthetic chain over the provable set's prims and dtypes, most
    of which the six shipped chains do not use: every value is an
    output, so each eqn's emitted form is held against the twin."""
    avals, lits, ops = {}, {}, []

    def val(shape, dtype):
        k = str(len(avals))
        avals[k] = [list(shape), dtype]
        return int(k)

    def lit(v, dtype):
        k = val((), dtype)
        vals = ["0x%08x" % int(np.float32(v).view(np.uint32))] \
            if dtype == "float32" else [v]
        lits[str(k)] = {"dtype": dtype, "shape": [], "values": vals}
        return k

    def op(prim, ins, out_shape, out_dtype, **params):
        out = val(out_shape, out_dtype)
        ops.append({"prim": prim, "in": ins, "out": [out],
                    "params": params})
        return out

    S, f, i32, b8 = (33, 7), "float32", "int32", "bool"
    x, y, i, j, b = (val(S, d) for d in (f, f, i32, i32, b8))
    q = op("add", [op("abs", [x], S, f), lit(1.0, f)], S, f)  # >= 1
    for p in ("neg", "sign", "floor", "ceil", "copy"):
        op(p, [x], S, f)
    for p in ("exp", "exp2", "log", "log1p", "tanh", "sqrt", "rsqrt",
              "logistic", "sin", "cos", "erf"):
        op(p, [q], S, f)
    op("is_finite", [x], S, b8)
    for p in ("add", "sub", "mul", "div", "max", "min", "rem"):
        op(p, [x, q], S, f)
    op("pow", [q, y], S, f)
    j1 = op("add", [op("abs", [j], S, i32), lit(1, i32)], S, i32)
    for p in ("gt", "ge", "lt", "le", "eq", "ne"):
        op(p, [x, y], S, b8)
        op(p, [i, j], S, b8)
    for p in ("add", "sub", "mul", "div", "rem", "max", "min", "and", "or",
              "xor"):
        op(p, [i, j1], S, i32)
    for p in ("neg", "abs", "sign", "not"):
        op(p, [i], S, i32)
    pos = op("gt", [x, lit(0.0, f)], S, b8)
    for p in ("and", "or", "xor"):
        op(p, [b, pos], S, b8)
    op("not", [b], S, b8)
    op("convert_element_type", [x], S, i32, new_dtype=i32)
    op("convert_element_type", [i], S, f, new_dtype=f)
    op("convert_element_type", [b], S, f, new_dtype=f)
    op("convert_element_type", [x], S, b8, new_dtype=b8)
    for e in (0, 1, 2, 3, 5, -2):
        op("integer_pow", [q], S, f, y=e)
    op("select_n", [b, x, y], S, f)
    k3 = op("rem", [op("abs", [i], S, i32), lit(3, i32)], S, i32)
    op("select_n", [k3, x, y, q], S, f)
    col = op("reduce_sum", [x], (7,), f, axes=[0])
    op("broadcast_in_dim", [col], S, f, shape=list(S),
       broadcast_dimensions=[1])
    op("add", [x, op("broadcast_in_dim", [col], (1, 7), f, shape=[1, 7],
                     broadcast_dimensions=[1])], S, f)
    total = op("reduce_sum", [x], (), f, axes=[0, 1])
    op("mul", [total, x], S, f)
    op("broadcast_in_dim", [total], S, f, shape=list(S),
       broadcast_dimensions=[])
    op("broadcast_in_dim", [lit(2.5, f)], S, f, shape=list(S),
       broadcast_dimensions=[])
    op("reduce_max", [x], (33,), f, axes=[1])
    op("reduce_min", [x], (33,), f, axes=[1])
    op("reduce_prod", [q], (33,), f, axes=[1])
    op("reduce_and", [b], (7,), b8, axes=[0])
    op("reduce_or", [b], (7,), b8, axes=[0])
    op("reduce_sum", [i], (), i32, axes=[0, 1])
    wide = op("expand_dims", [x], (33, 1, 7), f, dimensions=[1])
    op("squeeze", [wide], S, f, dimensions=[1])
    return {"name": "_gen_prim_sweep", "kind": "reduction_epilogue",
            "ext_in": [x, y, i, j, b],
            "ext_out": [o["out"][0] for o in ops], "avals": avals,
            "literals": lits, "ops": ops}


def phase_gen_kernels():
    """Phase 15: the six generated kernels (B10) against their twins on
    the card, the mislowering seam caught, the autotune cache replayed,
    and each kernel timed beside its twin and its bound."""
    import os
    import tempfile
    import torch
    from mxnet_tpu_torch.analysis import codegen as cg
    from mxnet_tpu_torch.ops import build
    from mxnet_tpu_torch.ops import generated_kernels as gen

    t0 = time.monotonic()
    kernels = gen.build_shipped_generated(device="cuda")
    findings = cg.lint_generated_kernels(device="cuda")
    if len(kernels) != 6 or findings:
        raise RuntimeError("generated kernels %s, lint %s"
                           % ([g.name for g in kernels],
                              [str(f) for f in findings]))
    print("phase 15: %d generated kernels built, registered and proven "
          "on the card in %.2f s; lint_generated_kernels() == []"
          % (len(kernels), time.monotonic() - t0))
    worst = {}
    for gk in kernels:
        lk, xs = gk.lowered, _gen_inputs(gk.lowered)
        worst[gk.name] = _gen_check(gk, xs)
        rungs = cg.AUTOTUNE_LADDER if cg.flat_tileable(lk) else ()
        for br in rungs:
            worst[gk.name] = max(worst[gk.name], _gen_check(gk, xs, br))
        print("phase 15: %s (%s, %d eqns, %d in / %d out, %d threads, "
              "workspace %d B %s): whole-array%s within %g of its twin, "
              "max |diff| %.3g, reruns bitwise"
              % (gk.name, gk.kind, gk.n_ops, len(xs), len(gk.out_avals),
                 lk.threads, lk.ws_bytes,
                 "shared" if lk.ws_shared else "global",
                 " and tiled at %s" % (rungs,) if rungs else "", GEN_TOL,
                 worst[gk.name]))

    # the mislowering seam: sub emitted as add must fail the check
    chains = {lk.name: lk.chain for lk in cg.shipped_lowered()}
    cg.MXGEN_LOWER_EXACT = False
    try:
        mutants = {n: cg.lower_chain(c) for n, c in chains.items()}
    finally:
        cg.MXGEN_LOWER_EXACT = True
    with_sub = sorted(n for n, c in chains.items() if "sub" in c.prims)
    changed = sorted(n for n, lk in mutants.items()
                     if lk.src != gen.GENERATED_KERNELS[n].src)
    if changed != with_sub:
        raise RuntimeError("the seam changed %s, want the chains with a "
                           "sub %s" % (changed, with_sub))
    sweep = cg.lower_chain(_sweep_ir())
    if sweep.src is None:
        raise RuntimeError("the prim sweep does not lower: %s"
                           % [str(f) for f in sweep.findings])
    build.build_all((), dict({mutants[n].symbol: mutants[n].src
                              for n in with_sub},
                             **{sweep.symbol: sweep.src}))
    ok, err = cg.equivalence_check(sweep, "cuda")
    if not ok:
        raise RuntimeError("the prim sweep (%d eqns) differs from its "
                           "twin: max |diff| %g" % (sweep.n_ops, err))
    print("phase 15: prim sweep (%d eqns over %d prims, f32/int32/bool) "
          "within %g of its twin, max |diff| %.3g"
          % (sweep.n_ops, len(set(sweep.prims)), GEN_TOL, err))
    for n in with_sub:
        ok, err = cg.equivalence_check(mutants[n], "cuda")
        if ok:
            raise RuntimeError("%s lowered with sub -> add still passes "
                               "its equivalence check" % n)
        print("phase 15: seam %s (sub emitted as add): equivalence check "
              "fails as it must, max |diff| %.4g" % (n, err))

    # the autotune cache: measured once, then replayed byte-identically
    tiled = [gk for gk in kernels if cg.flat_tileable(gk.lowered)]
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "mxgen_cache.json")
        for gk in tiled:
            first = cg.autotune_block_rows(gk, cache_path=cache,
                                           device="cuda")
            with open(cache, "rb") as f:
                blob = f.read()
            again = cg.autotune_block_rows(gk, cache_path=cache,
                                           device="cuda")
            with open(cache, "rb") as f:
                if f.read() != blob or again != first:
                    raise RuntimeError("%s: the autotune cache was not "
                                       "replayed (%s then %s)"
                                       % (gk.name, first, again))
            print("phase 15: autotune %s: block_rows %d of %s (t_ns %s), "
                  "replayed from the cache byte-identically"
                  % (gk.name, first, list(cg.AUTOTUNE_LADDER),
                     json.loads(blob)["kernels"][gk.name]["t_ns"]))

    # times: the kernel's device time (CUDA graph of GEN_TIMED calls),
    # its eager call with the host's launch cost, and the eager twin
    tiny = torch.zeros(1, device="cuda")
    floor_ms = _time_ms(lambda: tiny.zero_())
    out = []
    for gk in kernels:
        xs = _gen_inputs(gk.lowered)
        ms = _time_ms(lambda: gen.generated_call(gk, *xs), iters=GEN_TIMED)
        call_ms = _event_ms(lambda: gen.generated_call(gk, *xs),
                            iters=GEN_TIMED)
        plain_ms = _event_ms(lambda: cg.reference_outputs(gk.lowered, xs),
                             iters=GEN_TIMED)
        library_ms = _gen_library_ms(gk, xs)
        nbytes = gk.bytes_read + gk.bytes_written
        ops = gk.flops + gk.transcendentals
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print("phase 15: %s device time %.5f ms (eager call %.5f ms), twin "
              "%.5f ms (%d eqns eager); bound %.6f ms (%d bytes, %d "
              "operations); one tiny kernel's launch floor %.5f ms"
              % (gk.name, ms, call_ms, plain_ms, gk.n_ops, bound_ms, nbytes,
                 ops, floor_ms))
        if library_ms is not None:
            print("phase 15: %s library time %.5f ms (torch._fused_sgd_, "
                  "grad_scale 8, within %g of the twin)"
                  % (gk.name, library_ms, GEN_TOL))
        out.append({"name": gk.name, "route": "cuda",
                    "source": "mxnet_tpu_torch/analysis/codegen.py",
                    "replaces": "mxnet_tpu/ops/generated_kernels.py:95",
                    "launches": None, "max_abs_err": worst[gk.name],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "bytes" if bytes_ms >= ops_ms
                    else "operations", "library_ms": library_ms})
    return out


def _gen_library_ms(gk, xs):
    """Device time of the one PyTorch call that computes a generated
    kernel's chain, or None where there is none.  ``_gen_zero1_top2`` is
    SGD with momentum 0.9, dampening 0, lr 0.1 and grad_scale 8 (inputs
    m, g, w; outputs m', w'), which ``torch._fused_sgd_`` computes in
    place; it also writes ``g / 8`` back into the gradient.  The result
    is held to the twin first, so the time is of the same function."""
    import torch
    from mxnet_tpu_torch.analysis import codegen as cg

    if gk.name != "_gen_zero1_top2":
        return None
    scale = torch.tensor(8.0, device="cuda")

    def step(m, g, w):
        torch._fused_sgd_([w], [g], [m], weight_decay=0.0, momentum=0.9,
                          lr=0.1, dampening=0.0, nesterov=False,
                          maximize=False, is_first_step=False,
                          grad_scale=scale)
        return [m, w]

    ok, err = cg.compare_outputs(step(*[x.clone() for x in xs]),
                                 cg.reference_outputs(gk.lowered, xs),
                                 GEN_TOL)
    if not ok:
        raise RuntimeError("torch._fused_sgd_ differs from the twin of %s: "
                           "max |diff| %g" % (gk.name, err))
    state = [x.clone() for x in xs]
    return _time_ms(lambda: step(*state), iters=GEN_TIMED)


def phase_codegen_bench():
    """Phase 16: ``codegen_bench.main()`` on the card; returns the
    generated kernels' launches there."""
    import contextlib
    import io
    from mxnet_tpu_torch import codegen_bench
    from mxnet_tpu_torch.ops import generated_kernels as gen

    gen.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = codegen_bench.main([])
    counts = gen.launch_counts()
    line = buf.getvalue().strip().splitlines()[-1]
    rec = json.loads(line)
    if rc != 0 or rec["codegen_numerics_ok"] != 1.0 \
            or rec["codegen_n_kernels"] != 6:
        raise RuntimeError("codegen_bench rc %d: %s" % (rc, line))
    idle = sorted(n for n in gen.GENERATED_KERNELS if not counts.get(n))
    if idle:
        raise RuntimeError("codegen_bench launched no %s" % idle)
    print("phase 16: codegen_bench in %.2f s: %s" % (time.monotonic() - t0,
                                                    line))
    print("phase 16: generated kernels launched %s" % counts)
    return counts


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
        del runner
        bucket = _bucket_size()
        print("phase 4: resnet50_v1 has %d trainable parameters (one "
              "f32 bucket)" % bucket)
        opt_kernels = phase_opt_kernels(bucket)
        launches = phase_train(bucket, profile="--profile" in sys.argv)
        for k in opt_kernels:
            k["launches"] = launches[k["name"]]
        phase_train_parity()
        flash_kernels = phase_flash_kernels()
        flash = phase_train_lm(profile="--profile" in sys.argv)
        for k in flash_kernels:
            k["launches"] = flash[k["name"]]
        phase_train_lm_parity()
        qmm_kernel = phase_qmm_kernel()
        qmm_kernel["launches"], model = phase_int8_serve(
            profile="--profile" in sys.argv)
        phase_int8_parity(model)
        del model
        conv_kernels = phase_conv_kernel(profile="--profile" in sys.argv)
        launches = phase_conv_path()
        for k in conv_kernels:
            k["launches"] = launches[k["name"].split("[")[1][:-1]]
        gen_kernels = phase_gen_kernels()
        launches = phase_codegen_bench()
        for k in gen_kernels:
            k["launches"] = launches[k["name"]]
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print("total %.2f s" % (time.monotonic() - t_start))
    print(json.dumps({"kernels": [kernel] + opt_kernels + flash_kernels
                      + [qmm_kernel] + conv_kernels + gen_kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
