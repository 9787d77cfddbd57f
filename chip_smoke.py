#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mxnet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile]

Thirty-five phases; any failure exits non-zero and prints no result line.

1. **Kernels.** Build every CUDA source of the port with ``nvcc`` (one
   process per source, started together — the six mxgen kernels that
   ``analysis/codegen.py`` emits among them, and the 43 variants phase
   15 builds), run each kernel's wrapper on
   the card at the shapes the serving path gives it plus ragged ones, and
   hold it against its plain torch version (LayerNorm: atol = rtol =
   1e-5, f32 — only the reduction order differs; reruns bitwise).  Time
   the plain version on the device (CUDA graphs between CUDA events) and
   the eager calls with the host's launch cost.  Then B4 at the decode
   step's shapes (the slot batch (8, 1, 128), (1, 8, 128), (1, 1, 128))
   and the prefill's (1024, 128), in turns (CUDA graphs, a warm round,
   then two rounds in turn and in reverse, the lesser time) with the
   design it replaced (``_fused_layer_norm_parts(..., ())``, held to
   plain first), one PyTorch library call of the same function
   (``torch.nn.functional.layer_norm``, a yardstick the port never calls)
   and one tiny kernel's launch floor, beside the least time the card
   could take (bytes) and the aims (1.25x the floor at the decode shapes,
   1.40x at the prefill's; a miss is printed, not failed).  Fails where
   the replaced design is more than 10 % faster than B4.  Beside the
   build, in the same step, ``nvcc -cubin -Xptxas -v`` of the flash wgmma
   sources (``PTXAS_SOURCES``): each kernel instantiation's registers,
   spill stores and loads and any C75xx advisory (``wgmma`` serialized)
   are printed.
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

7. **Flash kernels.** Both designs of the forward
   (``flash_forward_with_lse``), ``flash_dq`` and ``flash_dkv`` (the
   split-TF32 ``wgmma`` design of ``csrc/flash_fwd_wgmma.cu`` and
   ``csrc/flash_bwd_wgmma.cu``, which takes D % 4 == 0 up to 32, and the
   CUDA-core design of ``csrc/flash_attention.cu`` for every D, each
   forced through the private ``_flash_forward_with_lse`` /
   ``_flash_dq`` / ``_flash_dkv``, whether ``flash_design`` routes the
   shape there or not) against their plain versions at the training
   path's
   pairings (512 x 512 chunks at D = 16: causal over BH = 512, full over
   BH = 256), ragged (3, 997 x 1000, 64) causal and full, (2, 1 x 1, 16)
   and (4, 300 x 300, 128) causal, and the wgmma design's tile edges
   (``FLASH_WGMMA_EDGES``: T not a multiple of the tiles, Tq != Tk both
   ways, dk/dv blocks with no query to visit, T = 1, every D % 4 == 0 up
   to 32): out and lse within atol = rtol = 1e-5
   (f32; only the summation order differs), dq/dk/dv from a seeded dO
   within 1e-4 (they sum over T; the wgmma design's three TF32 passes
   keep both there); two runs bitwise equal; every launch counted on its
   design.  The plain versions and the library run with matmul TF32 off
   (the flags as found are printed and restored after).  Timed per hop
   and per layer (both pairings) with CUDA events around eager calls,
   the two designs of each kernel in turns (wgmma, simt, simt, wgmma)
   against the 1.5x target, beside both bounds (the f32 CUDA-core one
   and the split-TF32 tensor-core one), plain, and the library yardstick
   ``scaled_dot_product_attention`` (f32; its forward for the forward,
   its backward through one ``torch.autograd.grad`` for dq and dk/dv
   together).  The choice of design by head dim: both designs of each
   kernel timed per layer at the path's pairings with D = 4, 8, ..., 32
   (``FLASH_DIMS``); fails where ``flash_design`` chose the slower one.
   Head dims above 128 (``FLASH_WIDE``: D = 160 and 256 on the 192- and
   256-wide builds, D = 320 on the wide kernels in chunks of 256; causal
   and not, ragged, Tq != Tk both ways) held to plain the same way and
   timed at (32, 512 x 512) causal beside the f32 bound; the launch shape
   the built source reports (``mxtt_flash_simt_shape``) equal to
   ``simt_launch_shape`` at every D of the phase.  A forward and a dq
   with q of more than 2^31 elements (1,048,580 x 128 x 16, causal), on
   the design ``flash_design`` picks and on the CUDA-core one, held to
   plain on the first and last four heads.
8. **Train the TransformerLM.** The configuration above through
   ``DataParallelTrainer(TransformerLM(cfg), None, "sgd", lr 0.1,
   momentum 0.9, mesh_plan=MeshPlan(sequence=2))``: ring attention over a
   sequence axis of 2 (the ranks a leading dimension on the card), batches
   of 32 x 1024 tokens cut from the bench's seeded Markov corpus, 3
   warm-up and 10 timed steps with torch's default precision.  Every loss
   finite, the last below the first, each flash kernel launched steps x
   layers x 2 hops times, every forward, ``flash_dq`` and ``flash_dkv``
   launch on the wgmma design, and the LayerNorm kernel >= steps x (2 x
   layers + 1).
   ``--profile`` adds the ``torch.profiler`` breakdown (the flash
   category holds B5-B7).
9. **Held on the card.** The same ``init_params(0)`` weights, 2 steps on
   one batch of 2 x 1024 tokens three ways: ``MeshPlan(sequence=2)`` on
   CUDA and on ``device="cpu"``, and the collapsed ``MeshPlan()`` (local
   attention, no flash kernel) on CUDA.  Losses CUDA vs CPU within 1e-4,
   sequence=2 vs collapsed within 2e-5 (the reference's own tolerance),
   parameters after 2 steps within 2e-5 both ways.
10. **qmm_requant (B8).** Each design against its plain version, relu on
    and off, bitwise, and a rerun bitwise, each launch counted on its
    design: the wgmma design (``csrc/qmm_wgmma.cu``) at the 16 (M, K, N)
    shapes of one int8 ResNet-50 forward at batch 256 (each bottleneck's
    1x1 conv ``a``; ``qmm_design`` must route all 16 there) and at its
    tile edges (``QMM_EDGES``: M 1,000, 333 and 1, N 200 and 17, K 48 and
    208, a row-strided x); the mma.sync design (``csrc/qmm_requant.cu``)
    at ``QMM_RAGGED``, forced and as routed.  Then each of the forward's
    four stages timed on both designs on the same inputs (CUDA graphs),
    the kernel also in eager calls between CUDA events, beside plain, the
    yardstick ``torch._int_mm`` + torch epilogue and the bound (bytes
    over 3.35 TB/s against 2MKN over 1,979 int8 TOP/s), and the sum per
    forward against ``QMM_TARGET_MS``.
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
    times per forward, every launch on the wgmma design.  ``--profile``
    adds the device time by category.
12. **Held on the card.** The same quantized graph and weights for 2
    images on the card and ``device="cpu"``: top-1 equal, probabilities
    within 1e-5.  Calibrated ranges of a card calibration (cuDNN TF32 off
    for it, restored after) and a CPU calibration over the same 8 images
    within 1e-4 relative.
13. **conv3x3_epilogue (B9).** The implicit-GEMM 3x3 kernel against its
    plain version (float64 sums) at the conv A/B harness's four stages at
    batch 256 (the stride-1 conv ``b`` of every ResNet-50 bottleneck:
    56 x 56 x 64, 28 x 28 x 128, 14 x 14 x 256, 7 x 7 x 512, Cin = Cout),
    ragged shapes (Cin 3 with odd W, Cin 8 and 16, Cout 5, 16, 24,
    N = 1) and the wgmma design's tile edges (M not a multiple of 128,
    Cout 96 and 200, a tile over two images), int8 and bf16, relu on
    and off, and float32 at (2, 28, 28, 512) -> 128, each on the design
    ``conv3x3_design`` routes it to (wgmma for the stages, the edges and
    (1, 7, 7, 512) -> 512, which must hold; mma.sync for Cin 3, int8
    Cin 8 and float32).  int8 bitwise equal; bf16 within one bf16 ulp
    (magnitudes counted no finer than 1/64 of the outputs' RMS, where a
    bf16 ulp is finer than the float32 sums' rounding; the outputs
    beyond one ulp at their own magnitude are counted and printed);
    float32 within 1e-4 x max(1, max |plain|); every rerun bitwise.
    Then each of the four stages per route, timed with CUDA events
    around eager calls, and summed per pass: the kernel (the wgmma
    design), the mma.sync design on the same inputs (through the private
    ``_conv3x3_epilogue(..., design="mma")``), plain, and the library
    route (int8: ``int8_conv``'s im2col + ``torch._int_mm`` + the torch
    epilogue; bf16: cuDNN's ``F.conv2d`` + the torch epilogue), beside
    the bound (per stage the larger of bytes over 3.35 TB/s and 2 x
    multiply-adds over 1,979 int8 TOP/s or 989 bf16 TFLOP/s) and the
    device time of the wrapper's weight repack (CUDA graph).
14. **The conv A/B harness.** ``mxnet_tpu_torch.tools.conv_ab.main(
    ["--batch", "256", "--iters", "20"])`` on the card: 16 records (4
    stages x int8/bf16 x library/kernel), each with ``ms``, none an
    ``error``; ``conv3x3_epilogue`` launched 4 x (1 warm-up + 20) times
    per route, every launch on the wgmma design.  Prints each stage's
    kernel and library times.
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
    way, so the emitter's forms the six chains do not use run too; a
    synthetic chain for the row plan (``_rows_sweep_ir``: a sum across
    rows read back by every row, so two phases and two exchanges; every
    reduction across rows, one keeping a row axis; 40 columns) too, at
    every cluster size.  The
    autotune
    cache is written once into a temporary file and replayed: same
    choice, byte-identical file.  Each row-plan kernel also emitted at
    every cluster size (1, 2, 4, 8), each flat-plan kernel
    (``_gen_zero1_top2``) at every size of ``codegen._FLAT_SIZES``
    (threads a block x elements a thread), and both on the group plan
    they replaced, each held to the twin (reruns bitwise; the flat
    plan's outputs bitwise the group plan's) and timed in turns (CUDA
    graphs, the lesser of two rounds) beside the launch floor; fails when
    a cluster size or flat size is more than 10 % faster than the one
    ``codegen.ROW_CLUSTER`` or ``FLAT_THREADS`` / ``FLAT_PER_THREAD``
    pins, or the group plan than the flat plan.  Each kernel timed as its
    device time
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
17. **The bf16 designs of B5-B7.** ``flash_forward_with_lse``,
    ``flash_dq`` and ``flash_dkv`` on bfloat16 q, k, v, dO, on each bf16
    design that takes the pairing, forced: the bf16 ``wgmma`` design of
    all three (``csrc/flash_bf16_wgmma.cu``, D % 8 == 0 up to 32) and the
    CUDA-core route of all three (the ``mxtt_flash_*_bf16`` kernels
    of ``csrc/flash_attention.cu``), against their bf16 plain versions
    (the f32 plain version on the widened inputs, rounded) at the ring
    path's hop pairings, at D = 64 and 128 causal and full, ragged (3, 997
    x 1000, 64), D = 320 and the wgmma design's edges
    (``FLASH_BF16_WGMMA_EDGES``: ragged tiles, Tq != Tk both ways, T = 1,
    D = 8, 24, 32): out, dq, dk, dv within one bf16 ulp (counted as in
    phase 13), lse within 1e-5, two runs bitwise, every launch on its
    design's count.  Timed per layer (both pairings) with CUDA events
    around eager calls, the two designs of each kernel in turns
    (wgmma_bf16, bf16, bf16, wgmma_bf16), and at D = 64 and 128 (the
    CUDA-core route alone), beside the bound (bytes at bf16 I/O, f32
    lse/delta; operations on the tensor cores: q k^T and dO v^T in one
    bf16 pass, the products with p or ds in two bf16 passes, cheaper than
    two TF32 ones, the non-matrix operations at the f32 rate), the bound
    of the CUDA-core route's own arithmetic, plain, and
    ``scaled_dot_product_attention`` in bf16 (its forward; its backward
    for dq and dk/dv together) as ``library_ms``.  Both designs of each
    kernel timed per layer at the path's pairings with D = 8, 24, 32
    (``FLASH_BF16_DIMS``); fails where ``flash_design`` chose the slower
    one.  dq's bf16 wgmma kernel at each key tile of
    ``flash_ablate.DQ_TILES`` (the other width built in phase 1 from the
    source with ``DQ_BT`` edited) held to plain at the path's pairings and
    timed per layer in turns; fails where the shipped width is more than
    ``DQ_TILE_SLACK`` slower than another.
18. **Train ResNet-50 in bf16.** First the half BatchNorm on the card
    on seeded bf16 data: moving statistics against the CPU's (rtol 1e-4;
    the card reads the forward kernel's saved f32 statistics, the CPU
    widens the data), the output within one bf16 ulp of the f64 spelling;
    ``Optimizer(multi_precision=True)`` over ``Parameter.cast("bfloat16")``
    weights on the card against the CPU (rtol 1e-6). Then phase 5's
    recipe and batch through
    ``DataParallelTrainer(..., dtype="bf16")`` (bf16 forward over the f32
    bucket masters, dynamic loss scaling, B1 on ``[lr, inv_scale, ok]``
    from the card) inside ``engine.bulk(4)``: 3 warm-up and 10 timed
    steps, images/s over the flushed window, step intervals p50/p99 and
    peak memory, beside an f32 trainer timed the same way in the same
    window (and phase 5's f32 numbers, taken outside any window); the
    final loss scale and
    skipped count; ``fused_sgd_momentum`` launched steps x buckets times.
    One bf16 step under ``torch.cuda.set_sync_debug_mode("error")`` with
    the batch on the card must not synchronize (an f32 step is tried the
    same way and a synchronizing op named, not failed).  A batch holding
    an inf leaves the masters and momentum bitwise untouched, halves the
    scale and books one skip.  Depth 1 and depth 4 over 3 steps on the
    same batch tensors (cuDNN's deterministic algorithms for both): losses
    and masters bitwise equal.
19. **Train the TransformerLM in bf16.** Phase 8's configuration and
    batches with ``dtype="bf16"`` (``compute_dtype`` on the mesh tier):
    tokens/s, p50/p99, peak memory, each bf16 flash kernel launched steps
    x layers x 2 hops times, all on the bf16 ``wgmma`` design
    (``PATH_BF16_ROUTES``), the largest |loss_bf16 - loss_f32| against
    phase 8's losses on the same seed and batches; ``--profile`` adds the
    device time by category, each flash kernel's time per step and the
    idle share.
20. **The benches.** ``mxnet_tpu_torch.engine_bench.main([])`` and
    ``precision_bench.main([])`` on the card: their JSON lines printed;
    the ring and prefetch bounds held, ``precision_numerics_ok == 1.0``.
21. **Gluon ResNet-50 training.** The reference's imperative loop on
    ``mx.gpu()``: ``vision.resnet50_v1()`` (1000 classes, NCHW, f32,
    created on the card by ``initialize()`` with no ``ctx``), each step
    ``with autograd.record(): L = loss(net(x), y)``, ``L.backward()``,
    ``gluon.Trainer(..., "sgd", lr 0.1, momentum 0.9, wd 1e-4,
    kvstore="device").step(batch)`` and ``metric.Accuracy`` /
    ``TopKAccuracy(5)`` / ``CrossEntropy`` updates, at phase 5's batch
    of 256 (halved on out-of-memory): 2 warm-up and 10 timed steps,
    images/s, step p50/p99 and peak memory beside phase 5's images/s.
    Fails unless every loss is finite and the last below the first, and
    unless no launch counter of B1-B10 moved during the steps (the
    reference's Gluon update is per parameter and reaches no
    ``pallas_call``).  Parity from one set of carried weights at batch 2
    x 224 x 224, 2 steps: (a) the card against the CPU in float64
    (losses, parameters and moving statistics within
    ``GLUON_F64_TOL``, the card-vs-CPU check) and in float32 with TF32
    off (the first-step loss within 1e-4; the parameters after one step
    are printed, not held: a max-pool or ReLU choice that f32 rounding
    flips moves a whole gradient term); (b) the Gluon route against one
    step of ``DataParallelTrainer`` (B1 on the card, launched once per
    bucket) in float32 with TF32 off and cuDNN's deterministic
    algorithms: the loss within ``GLUON_ROUTE_LOSS_TOL`` (the same
    forward), every parameter and moving statistic within
    ``GLUON_ROUTE_ULPS`` float32 ulps (the update's rounding; the
    momentum coefficient first acts at the second step, held on the CPU
    by tests).  Checkpoints:
    ``save_parameters`` in both formats reloaded into a fresh net on the
    card gives logits bitwise the saved net's, each file byte-identical
    to one written on the CPU from the same values, and ``save_states``
    -> ``load_states`` into a fresh Trainer then one step is bitwise the
    uninterrupted step (cuDNN's deterministic algorithms).
22. **Channels-last ResNet-50.** At phase 5's batch (halved on
    out-of-memory): (a) phase 21's Gluon loop and recipe on
    ``resnet50_v1(layout="NHWC")`` (OHWI weights, ``BatchNorm(axis=-1)``,
    NHWC images) in float32, (b) the same net in bf16 (``net.cast(
    "bfloat16")``, ``multi_precision=True``, the logits cast to float32
    before the loss), each with images/s, step p50/p99 and peak memory
    beside phase 21's NCHW numbers and no B1-B10 launch; (c)
    ``DataParallelTrainer(dtype="bf16")`` on the NHWC net inside
    ``engine.bulk(4)`` on phase 18's batch transposed: images/s, p50/p99
    and peak memory beside phase 18's NCHW bf16 window, loss scale,
    ``fused_sgd_momentum`` launched steps x buckets times (the kernels
    line's ``launches_bf16_nhwc``).  ``--profile`` adds the device time
    by category of (c) and of phase 18's NCHW recipe, side by side, with
    cuDNN's layout transposes and torch's copy kernels as categories of
    their own, each such kernel on its own line, and the idle share.
    Parity from one set of carried weights at batch 2 x 224^2, TF32 off,
    cuDNN deterministic: NHWC against NCHW on the card (weights moved
    OIHW -> OHWI), float64 logits and one float64 step within
    ``NHWC_F64_TOL``; in float32, predict-mode logits within
    ``NHWC_F32_LOGIT_TOL`` of the largest, one step's loss within 1e-4
    and every parameter and moving statistic after it within
    ``NHWC_F32_STEP_TOL`` of the step's largest move (past ``STEP_ULPS``
    ulps).  Torch runs float64 convolutions on cuDNN's NCHW kernels
    whatever the input's layout (the phase prints the memory format it
    returns per dtype), so the float32 checks are the ones that hold the
    channels-last kernels.  NHWC card against NHWC CPU, two float64
    steps within ``GLUON_F64_TOL``; an NHWC ``.params`` file written on the card, in
    both formats, byte-identical to the CPU's and reloaded to bitwise
    logits.
23. **The vision model zoo.** Every name of ``vision.get_model`` (the
    reference's 34) through ``tools/benchmark_score.score`` on the card
    (1000 classes, Xavier drawn on the card from a seeded generator,
    ``hybridize(static_alloc=True)``, 224^2, 299^2 for ``inceptionv3``,
    ``ZOO_WARMUP`` + ``ZOO_ITERS`` forwards, cut from the tool's 5 + 20;
    smoke readings, their spread not measured): images/s at batch 1 and
    32.  ``resnet50_v1``'s whole 1-32 sweep in both layouts, timed
    apart from those: at each batch size both nets built once, then
    ``ZOO_SWEEP_ROUNDS`` rounds that alternate the layouts' order, each
    timing ~``ZOO_SWEEP_S`` s of forwards; the median and range per
    layout, and whether the ranges part.  Initialization of three large
    nets drawn on the card from a ``torch.Generator`` against drawn on
    the host from a ``numpy.random.RandomState`` and copied over (the
    tool's draw against the reference's), each up to its first forward.
    One net per family (``ZOO_FAMILIES``) trained two Gluon
    SGD+momentum steps at batch 32: finite losses, no trainable
    parameter with an all-zero gradient.  The same eight, He-initialized
    (the signal reaches the head), card against CPU in float64 at batch
    2 from carried parameters: logits within ``ZOO_F64_TOL`` of the
    largest.  ``get_model(name, pretrained=True,
    root=...)`` from a plain ``.params`` file and from a ``file://``
    repo with a registered SHA-1: logits bitwise the saving net's.
    Every B1-B10 counter stays at 0 over the phase, as the reference's
    zoo reaches no ``pallas_call``.
24. **The op set and ``nd.random``.** (a) Every deterministic op the
    seeded-RNG slice ported (``mxnet_tpu_torch.tools.op_cases.CASES``:
    one case per function of ``ops/init.py``, the rest of ``matrix``,
    ``indexing``, ``reduce``, ``elemwise`` and ``nn``, the update ops,
    the repaired ``SoftmaxOutput``) at a model's sizes, forward and
    backward from a seeded head gradient, on the card against the CPU
    through ``test_utils.check_consistency([cuda, cpu])``: index and
    integer outputs exact, floats within 1e-5 of the largest magnitude;
    the ops held (with their aliases) and the worst error per reference
    file.  (b) Every sampler of ``nd.random`` and ``_sample_*``,
    ``OP_DRAWS`` (2^24) draws on the card: mean and variance within 6
    standard errors of the law's, a KS statistic (continuous) or a
    chi-squared (discrete) under the alpha = 0.001 limit, ``shuffle`` a
    permutation; one ``mx.random.seed`` twice bitwise, a ``get_state``
    / ``set_state`` round trip bitwise, two successive draws differ;
    ms per 2^24 uniform and normal draws (CUDA events).
25. **ResNet-50 through every optimizer.** ``resnet50_v1`` (NCHW, f32),
    phase 21's data and recipe at phase 5's batch: (a) ``gluon.Trainer``
    with each optimizer of ``OPT25`` (the thirteen the slice ported,
    RMSProp plain and centered, with ``sgd`` and ``adam`` as baselines),
    each from the same initial weights: 1 warm-up and 2 timed steps,
    images/s, peak memory, the update's device ms a step (CUDA events
    around ``Trainer.step``); losses finite, every parameter moved (but
    the zero-initialized ones under LBSGD and Ftrl, whose rules may hold
    them at zero), no B1-B10 launch.  (b) ``DataParallelTrainer`` with
    each elementwise optimizer, exact SGD (momentum 0.9) and Adam, 2
    steps each: B1
    (``fused_sgd_momentum``) and B3 (``fused_adam``) launched steps x
    buckets for those two and no hand kernel for any other; LBSGD and
    DCASGD raise ``ValueError``; SGLD from one ``mx.random.seed`` twice
    bitwise at ``engine.bulk(1)`` and ``engine.bulk(4)`` (cuDNN
    deterministic).  (c) One update of every optimizer on the card
    against the CPU over resnet50_v1's 193 trainable arrays in float64
    with seeded gradients: within 1e-12 of each array's largest
    magnitude (SGLD: its noise held to N(0, lr) instead).  (d)
    ``vgg16`` at batch 64, 2 Gluon SGD steps through its Dropout, twice
    from one ``mx.random.seed`` bitwise equal (cuDNN deterministic), a
    third seed different.
26. **The data pipeline.** (a) The probe: ``nproc``, ``python -c
    'import cv2'`` and ``'import PIL'``, whether ``mxnet_tpu_torch._native``
    builds (``jpeglib.h``, ``-ljpeg``; ``_native.available()`` must agree),
    ``df -h /dev/shm`` and the native decoder's threads per worker
    (``min(nproc, 16)``: ``ImageRecordIter`` takes ``preprocess_threads``
    as the worker count); the most workers W and the ring depth that fit
    ``P26_SHM_SHARE`` of the free ``/dev/shm`` (W x depth slots of one
    38.5 MB batch).  (b) ``io.bench.run`` over a ``.rec`` of 1,792
    records (7 batches of 256; 3,328 until the script neared its time
    limit) packed from the JPEG fixtures of
    ``tests/data/torch_io/`` (500 x 375), resize 256, crop 224: images/s
    fed to the host at W = 0, 4, 8 ... up to the most that fit, over a
    warm-up and a timed epoch, and the best W; W = 0 and W = best give the same
    seeded uint8 stream, bitwise, and the first batch is bitwise an
    in-process native decode of its records.  (c) The main path, phase 22
    (c)'s recipe (``resnet50_v1(layout="NHWC")``,
    ``DataParallelTrainer(dtype="bf16")``, SGD with momentum, inside
    ``engine.bulk(4)``), fed by ``ImageRecordIter(resize=256, ImageNet
    mean / std, seed=0, preprocess_threads=W)`` two ways: (c1)
    ``device_tail=True`` (the iterator's ``DeviceFeedIter`` runs the tail,
    to bf16 NHWC) and (c2) uint8 NHWC through ``PrefetchToDeviceIter``
    into ``DataParallelTrainer(input_transform=make_device_tail(mean, std,
    "bfloat16", "NHWC"))``; then the same trainer on device-resident
    synthetic uint8 batches.  Each 2 warm-up and 10 timed steps (images/s
    over the flushed window, step p50/p99, peak memory; the window is fed
    in part from batches the workers decoded while the net was built),
    the rest of that epoch, one whole epoch timed from an empty ring (the
    sustained images/s) and a profiled window of 3 (the device's idle
    share); the feed thread's seconds per
    batch and the pipeline's stall share; every decoder in use printed and
    held to the probe's; ``fused_sgd_momentum`` launched steps x buckets
    times in each (the kernels line's ``launches_phase26``, counted from
    0 at (c)); the tail on the card bitwise its plain CPU version on batch
    0 in f32 and bf16, NHWC and NCHW; no worker initialised CUDA (each
    worker checks after every batch).  (d) Gluon ResNet-50 (phase 21's
    recipe) fed by ``DataLoader(batch_size=256, shuffle=True,
    num_workers=W)``: ``ImageRecordDataset`` with ``RandomResizedCrop``,
    ``RandomFlipLeftRight``, ``ToTensor`` and ``Normalize`` where OpenCV
    is installed, else the native decoder's uint8 images through
    ``ArrayDataset`` with ``ToTensor`` and ``Normalize``; 1 warm-up and 3
    timed steps, images/s beside phase 21's, finite losses, no B1-B10
    launch, a ``DataLoader`` probe whose workers report CUDA
    uninitialised, and the rate of one batch-sized message through a
    multiprocessing pipe from a worker (the loader's result path).  Without any decoder on the host, (b) is skipped and
    (c) runs from seeded uint8 batches through ``NDArrayIter``, said so.
27. **Module training.** (a) ``tools/train_imagenet.main`` (the port of
    ``examples/image_classification/train_imagenet.py``) on a JPEG
    ``.rec`` of ``P27_RECORDS`` records made by ``io.bench.fixture_rec``:
    ``get_symbol(1000, 50, "3,224,224")`` (the symbolic pre-activation
    ResNet-50, f32 NCHW) through ``Module.fit``, batch 128 (the tool's
    default; halved on out-of-memory, said so), one epoch, SGD momentum
    0.9, wd 1e-4, ``MultiFactorScheduler``, ``Xavier(gaussian, in, 2)``,
    ``Speedometer`` and ``do_checkpoint``, decoded by up to 8 workers
    (``--data-nthreads``; OpenCV on the card's host): every loss finite,
    images/s fed over steps 2 on (the host clock after a sync per
    step).  ``Module.load`` of the checkpoint it wrote (parameters and
    moving statistics bitwise the trained module's), ``score`` and
    ``predict`` (finite rows summing to 1).  Then 2 + 10 timed
    ``forward`` / ``backward`` / ``update`` on one fixed uint8 batch on
    the card (cast to f32 by the executor's feed): images/s, the ms of
    each stage between CUDA events, the device's idle share over 3 more
    (``torch.profiler``), peak memory, losses finite and the last below
    the first, beside phase 5's ``DataParallelTrainer`` f32 rate (no gain
    claimed); the precision flags and the host's load average as found.  (b) The same symbol at batch 2 x 224^2,
    weights drawn once: one ``forward_backward`` on the card and with
    ``context="cpu"``, TF32 off: outputs within 1e-4, gradients within
    10x the rounding floor a CPU run from weights one ulp up measures
    (phase 6's rule; a one-ulp input change is normalized away by
    ``bn_data``), fix_gamma's gamma a zero gradient; in float64 through
    ``simple_bind(type_dict=...)``, outputs and gradients within 1e-4.
    (c) ``tools/train_mnist.main``, MLP and LeNet, 3 epochs on the card
    over idx files of a seeded learnable 10-class set: validation
    accuracy above 0.8.  (d) ``BucketingModule`` (two keys sharing one
    FC), ``SequentialModule`` (two modules, input gradients) and a
    ``CustomOp`` softmax through ``nd.Custom`` under ``autograd``, on
    the card against the CPU, TF32 off, within 1e-5.  No B1-B10 counter
    moves over the phase.  Prints the phase's seconds and the script's.
28. **LSTM + CTC.** (a) The ``RNN`` op (``ops/rnn.py``) on the card
    (cuDNN through torch's fused RNN functions) against the CPU, TF32
    off: every mode x 1 and 2 layers x one and two directions with
    ``state_outputs``, and LSTM with the cell clip; outputs, final
    states and the gradients of the data, the flat vector and both
    states, each difference over the larger of 1 and the largest
    magnitude: within 1e-10 in float64 and 1e-4 in float32 (cuDNN's f32
    recurrence sits ~1e-5 off a float64 run, the CPU's under 1e-6; both
    printed); the route counters show every case without clip or
    dropout on the fused route.  (b) ``ctc_loss`` (``ops/contrib.py``),
    both blank labels, lengths given and inferred: losses and the
    gradients of the activations within 1e-10 in float64 and 1e-4 in
    float32 (each beside its distance from a float64 CPU run); the CTC
    kernels the profile names.  (c)
    ``tools/train_ctc.main()`` at its defaults (the repo's config 3:
    batch 16, two bi-LSTM layers of 64, 39 features, 28 symbols, buckets
    40 / 80, Adam 2e-3, 60 batches): its seconds; the loss falls at both
    bucket keys, both bound, one fused RNN call a batch.  (d) The same
    ``sym_gen`` at ``P28_SPEECH`` (the tool's own flags at widths that
    make the card work, not a published configuration), a fixed batch
    at bucket 400: 2 + 10 steps, utterances/s and frames/s, forward /
    backward / update ms between CUDA events, device ms by category
    over 3 more (``torch.profiler``; the update in its own window), the
    flat-weight copy timed alone, the idle share, peak memory.  (e) Three
    ``gluon.Trainer`` steps of ``gluon.rnn.LSTM`` (2 layers,
    bidirectional) + ``Dense`` under ``gluon.loss.CTCLoss`` on the card
    against the CPU, and ``mx.rnn.FusedRNNCell`` against its unfused
    ``LSTMCell`` stack on the card, TF32 off, within 1e-4 (cuDNN's f32
    recurrence, as in (a)).  No B1-B10
    counter moves over the phase.  Prints the flags as found, the
    phase's seconds and the script's.
29. **Detection.** (a) Every op of ``ops/contrib.py``'s box, SSD and
    RCNN families on the card against the CPU at the published sizes,
    TF32 off, in float32 and float64: ``MultiBoxPrior`` over SSD300's six
    maps (38^2 ... 1^2, MXNet ``example/ssd``'s ``ssd_300`` sizes, ratios
    and steps: 8,732 anchors), ``MultiBoxTarget`` at batch 32 (21
    classes, 1-20 seeded truths padded to 20, the training config's
    thresholds, mining ratio 3), ``MultiBoxDetection`` at batch 32 (the
    deploy settings: NMS 0.45, ``nms_topk`` 400, threshold 0.01),
    ``box_nms`` over its rows at topk 400 and over all 8,732 rows,
    ``bipartite_matching`` over 32 x 8,732 x 20 IoUs, ``Proposal`` at
    Faster R-CNN's VGG16 test settings (38 x 63 at stride 16, 9 anchors:
    21,546; 6,000 pre-NMS, 300 post, NMS 0.7, min size 16) and
    ``MultiProposal`` at batch 2, ``ROIAlign`` forward and backward (300
    rois over (1, 512, 38, 63), 7 x 7, sample_ratio 2, both ``aligned``).
    Integer, index and keep outputs equal; floats within 1e-5 of the
    larger of 1 and the largest magnitude in float32 and 1e-10 in
    float64; an image whose decision flips in float32 is counted and
    printed, is allowed only downstream of ``exp`` (the mining softmax,
    the decodes) and must not flip in float64.  Each op's ms a call
    (CUDA events), kernels and copies a call (profiler) and host syncs a
    call (``torch.cuda.set_sync_debug_mode``, beside the NMS's own
    counter).  (b) ``tools/train_ssd.main()`` at its defaults (the
    repo's config 4): seconds, the loss falling, the detections kept;
    then its step at batch 256 fed from 8 x 256 records through
    ``ImageDetRecordIter``: images/s fed and on a decoded batch, forward
    / target / loss / backward / update ms between CUDA events, device
    ms by category and the idle share (profiler), peak memory.  (c) One
    SSD step from the same weights, card against CPU, TF32 off: outputs
    within 1e-4, ``MultiBoxTarget`` equal on the same inputs, gradients
    within 10x the CPU's rounding floor (weights one ulp up).  (d)
    ``tools/train_rcnn_lite.main()`` at its defaults after
    ``mx.random.seed(P29_RCNN_SEED)``, its own asserts (head accuracy >=
    0.8, recall >= 0.5), and the figures at ``P29_RCNN_SEEDS`` (ROADMAP.md
    C9).  (e) ``ImageDetRecordIter`` over 256 detection records of the
    JPEG fixtures, batch 32 at 300^2 with shuffle, rand_crop 0.5 and
    mirror: batches/s, the first batch bitwise an in-process
    ``ImageDetIter``'s from the same ``random`` seed, labels padded with
    -1 rows to the estimated shape.  No B1-B10 counter moves over the
    phase; whether PIL is on the host is printed.  Prints the phase's
    seconds and the script's.
30. **Sparse storage** (A10(c); no hand kernel: the reference's sparse
    code reaches no ``pallas_call``).  (a) At Avazu's shapes (MXNet
    ``example/sparse/linear_classification`` on avazu-app: a CSR batch of
    8,192 rows over 1,000,001 columns, 15 seeded nonzeros a row): ``dot``
    with a (1,000,001, 1) and a (1,000,001, 64) rhs, plain and
    ``transpose_a``, each beside ``torch.sparse.mm`` on the same CSR;
    ``cast_storage`` of the transposed product to row_sparse and of a
    1,024 x 65,536 dense slice to csr; ``retain`` to the batch's unique
    rows; ``add_rsp``; the row-sparse SGD (with and without momentum),
    Adam and AdaGrad updates; the registered ``_sparse_adagrad_update``,
    ``cast_storage`` (capacity 0) and ``_sparse_retain``.  Card against
    CPU in float32 and float64 (indices, indptr and nnz equal; floats
    within 1e-5 / 1e-10 of the larger of 1 and the largest magnitude),
    then ms a call (CUDA events), kernels a call (profiler) and host
    syncs a call (``torch.cuda.set_sync_debug_mode``): fails where an op
    syncs more than the reference does (once for ``cast_storage`` and
    ``add_rsp``, else never).  (b) ``tools/train_sparse_linear.main()``
    at its defaults, the example's assert inside; then its step at
    Avazu's width over 32 batches of 8,192 from a LibSVM file written in
    bulk from the seed: samples/s, the file's and the parse's seconds,
    the iterator's batch assembly, each part of the step between CUDA
    events (``STEP_PARTS``), host syncs a step, device ms by category and
    the idle share (profiler), peak memory.  (c) One step at that width,
    card against CPU from the same weights, TF32 off: scores within
    1e-5, the row-sparse gradient's indices equal and values within
    1e-5, the weight after the update within 1e-6.  (d)
    ``tools/train_wide_deep.main()`` and ``tools/matrix_fact.main()`` at
    their defaults with their asserts; matrix factorization at
    MovieLens-10M's id ranges (71,569 users, 65,135 items, rank 128), 200
    batches of 256 synthetic ratings: samples/s and the Adam update's ms
    a step.  (e) ``Embedding(sparse_grad=True)`` and
    ``contrib.nn.SparseEmbedding``, one step each, card against CPU:
    outputs, dense gradients and weights within 1e-5.  No B1-B10 counter
    moves over the phase.  Prints the phase's seconds and the script's.
31. **The rest of the op set and contrib/** (A10(d), A10(e); no hand
    kernel: the reference's code there reaches no ``pallas_call``).
    (a) Every name the slice registers (59, each alias through its
    op): the linalg ops at a batch of 16 matrices of 1,024 x 1,024 (the
    CPU computes the first 2, against which the card's first 2 are held),
    ``count_sketch`` and the FFTs at compact bilinear pooling's sizes
    (25,088 x 512 -> 8,192; the CPU computes the FFTs' first 784 rows,
    one image's),
    the rest at the reference's op-sweep shapes with a batch of 256; card
    against CPU, forward and gradients, float32
    (TF32 off) and float64: f64 within 1e-10, f32 elementwise within
    1e-6 and the rest within 10 times the float32 floor the phase
    measures (CPU float32 against CPU float64), integer outputs,
    histogram counts and determinant signs equal; ``gelqf`` and
    ``syevd`` held after taking the CPU's sign a row, and by their
    sign-free residuals; then ms a call, kernels a call and host syncs a
    call: fails on any sync but ``syevd``'s one (torch's ``eigh`` reads
    cuSOLVER's status).  (b) ``tools/train_ae.main()`` at its defaults
    with its asserts; the sparse autoencoder at MNIST's stacked widths
    (784-500-500-2000-10, the KL penalty on the code, batch 256 of seeded
    pixels): samples/s, the idle share, peak memory, the KL backward's
    ms.  (c) A Deformable R-FCN head at its published sizes: the 3 x 3
    deformable convolution 512 -> 512 (dilation 2) on the 38 x 63 map with
    4 deformable groups and with 1, PS RoI pooling and its deformable form
    on the 1,029- and 392-channel maps over 300 RoIs; forward and
    backward card against CPU as (a), ms of each, the im2col's bytes.
    (d) An LSTM as ``nd.contrib.foreach`` over ``gluon.rnn.LSTMCell`` at
    phase 28 (d)'s widths against the fused ``RNN`` op on the same
    weights (1e-4 f32, 1e-10 f64: outputs, final states, gradients),
    both timed; ``while_loop`` and ``cond`` with one host sync a test of
    the condition and one a ``cond``.  (e) A GloVe-format file of
    100,000 tokens x 300 from the seed through ``CustomEmbedding``, a
    ``Vocabulary`` and a Gluon ``Embedding`` on the card (lookups
    bitwise); ``DataLoaderIter`` feeding ``Module.fit`` for an epoch;
    the old ``contrib.autograd`` API card against CPU;
    ``LogMetricsCallback``'s writer gate.  No B1-B10 counter moves over
    the phase.  Phases 7 and 17 re-time a (kernel, head dim) pair whose
    chosen design missed, both designs in turns, and fail only if it
    misses again.

32. **Data parallelism in process** (A6(a)): ZeRO-1 ResNet-50 over 4
    ranks through ``fit``, the TransformerLM at ``MeshPlan(data=2,
    sequence=2)``, sharded restores and NCCL at world size 1.
33. **The parameter server and the launcher** (A6(b), C17).  (a)
    ``python -m mxnet_tpu_torch.tools.launch -n 2 --launcher local``:
    two workers train ``resnet50_v1`` (f32, NCHW, 224 x 224, batch 128
    each) through ``DataParallelTrainer(kvstore="dist_sync")`` on the one
    card for 8 steps; their trainable parameters are bitwise equal after
    every step, each launches B1 once a step, and B1 is held to its plain
    version on the card (1e-7).  A one-process replay of the reference's
    ``_dist_step`` (two halves, the mean gradient, rank 0's running
    statistics; it runs beside (b) and (c)) holds every step's loss
    (relative) and parameters within 1e-4.  Prints
    images/s, peak memory a worker, the reduction's backend and its ms a
    step.  (b) ``launch -n 2 -s 1 --ps-state-dir D`` of
    ``tools/train_imagenet`` with ``--kv-store dist_async`` (ResNet-50,
    2 batches of 32 fixture records a worker; (b) and (c) run side by
    side): the server process (a
    host role, by design) logs each push once (its WAL sequence is the
    inits, optimizers, incarnations and pushes sent), both workers pull
    identical weights after the final barrier, and SIGTERM leaves a
    final snapshot holding them.  (c) ``tools/train_mnist`` (phase
    27's learnable MNIST-layout files) with ``--kv-store dist_async``
    under ``launch -n 1 -s 1 --restart-failed 1`` and
    ``MXTPU_CHAOS=kvstore.server_apply:13:kill`` on the server:
    the final pulled parameters are byte-identical to an uncrashed run;
    prints the recovery time and the WAL records replayed.  (d)
    ``tools/bandwidth``: in-process comm at K = 2 and 4, NCCL at world
    size 1, gloo at 2 processes (a CUDA buffer through a host copy and
    handed over directly), kvstore push + pull at 64 MB.  (e) C17 on the
    card: ``with mx.cpu():`` makes host arrays, ``with mx.gpu(0):`` card
    arrays, and ``gpu_memory_info(0)`` agrees with
    ``torch.cuda.mem_get_info``.  The kernels line's B1 record gains
    ``launches_phase33``.
34. **Model-axis tensor parallelism** (A7(a)).  (a)
    ``tools/train_transformer_lm``'s ``train()`` at the documented width
    over ``MeshPlan(data=2, model=2, sequence=2)``, ring attention,
    batch 32, 6 steps with ``zero=0`` and then ``zero=1``: tokens/s (and
    after the first step), peak memory, the loss drop, and the launches
    a step of B1, B4 and B5-B7, each held equal to its formula (B1 =
    data x zero, B4 = data x (2 layers + 1), B5-B7 = data x layers x
    sequence each, on the wgmma design); the two runs' losses agree
    within 2e-5.  (b) At one layer, two steps of ``{model: 2}`` and
    ``{data: 2, model: 2, sequence: 2}`` against the collapsed plan on
    the card (2e-5) and against the CPU (losses 1e-4, parameters 2e-5),
    and of the latter at ``zero=1`` (B1 4 launches) against its
    ``zero=0`` run (2e-5) and the CPU; B1 at one data rank's ``(Km *
    shard,)`` ZeRO-1 length and offsets, B4 at one data rank's ``(Km,
    Ks, B, T/Ks, d)`` rows and B5-B7 (both designs) at the layout's hop
    pairings against their plain versions, timed beside plain, the
    library call and the bound.  (c) ``DecodeProgram(plan=MeshPlan(data=1,
    model=2))`` behind ``ModelFleet.register_decode`` and ``Server``: 8
    concurrent ``POST /decode``, every answer equal to the collapsed
    program's ``reference_decode``; B4 launched.  The kernels line's B1,
    B4 and B5-B7 records gain ``launches_phase34`` ((a)'s two runs).
35. **The front-end names** (A1(f)).  (a) A symbolic ResNet-50
    checkpoint saved by the port (``Module.save_checkpoint``) run as
    ``gluon.SymbolBlock.imports`` on the card, equal to
    ``Module.predict`` on the same batch (1e-5).  (b) An FCN-32s style
    upsampler initialized by ``Mixed([".*upsampling.*", ".*"],
    [Bilinear(), Xavier()])`` on the card: the deconvolution's weights
    Bilinear's exactly.  (c) ``tools/op_bench`` over the card, one JSON
    line an op.

Output: per-phase lines, then a ``{"kernels": [...]}`` JSON line (B4's
at (1024, 128), ``prev_ms`` the design it replaced in the same turns; the
flash kernels' ``ms``/``plain_ms``/``bound_ms`` are per layer, both
pairings, on the wgmma design (``source`` ``csrc/flash_fwd_wgmma.cu`` or
``csrc/flash_bwd_wgmma.cu``, ``bound_ms`` the split-TF32 tensor-core
bound, ``simt_ms`` the CUDA-core design's time, ``launches_by_design``;
phase 7 prints both bounds);
``qmm_requant``'s per forward, its 16 launches summed, on the
wgmma design (``source`` ``csrc/qmm_wgmma.cu``);
``conv3x3_epilogue[int8]``/``[bf16]``'s per pass of the four harness
stages on the wgmma design (``source`` ``csrc/conv3x3_wgmma.cu``),
``launches`` from phase 14; the ``_gen_*`` kernels' per call,
``launches`` from phase 16, ``library_ms`` that of ``torch._fused_sgd_``
for ``_gen_zero1_top2`` and null for the other five, which no single
PyTorch call computes; ``plan`` and ``cluster`` as lowered, ``plan_ms``
the row plan's time at each cluster size or the flat plan's at each
size, and the group plan's); the bf16 flash kernels ``flash_*[bf16]``
per layer at the path's pairings on the design the path takes
(``design``: all three on ``wgmma_bf16``, ``source``
``csrc/flash_bf16_wgmma.cu``, with ``cuda_core_ms`` the CUDA-core
route's time in the same turns; dq's also ``key_tile_ms``, its time at
each key tile),
``launches`` and ``launches_by_design`` from phase 19, ``max_abs_err``
and ``max_bf16_ulps`` from phase 17, ``bound_ms`` the tensor-core bound
on bf16 operands and ``simt_bound_ms`` that of the f32 CUDA-core
arithmetic; the
card's name and power limit from
``nvidia-smi``, and as the last line ``{"ok": true, "device": {...}}``.
"""
import concurrent.futures
import contextlib
import json
import re
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense f32
# CUDA-core FLOP/s and dense int8, bf16 and TF32 tensor-core operations/s,
# for the bound of a kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
INT8_OPS_PER_S = 1.979e15
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12

LN_TOL = 1e-5
# B4's aims, against one tiny kernel's launch floor timed in the same
# phase: at the decode step's shapes and at the prefill's (1024, 128)
LN_AIM_DECODE, LN_AIM_PREFILL = 1.25, 1.40
# the design B4 replaced may be this much faster than B4 before phase 1
# fails
LN_PREV_SLACK = 0.10
LOGIT_TOL = 1e-4
OPT_TOL = 1e-6
TRAIN_TOL = 1e-4
NOISE_FACTOR = 10
CFG = dict(vocab_size=256, d_model=128, n_heads=8, n_layers=4, d_ff=512,
           seq_len=1024)
PAGE_SIZE, SLOTS = 8, 8
# B4's decode-step shapes: the slot batch, a prefill bucket of 8, one
# position
LN_DECODE_SHAPES = [(SLOTS, 1, CFG["d_model"]), (1, 8, CFG["d_model"]),
                    (1, 1, CFG["d_model"])]
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
# edges of B8's wgmma design (128 rows x 64 or 128 columns, K in
# 64- or 128-byte steps), (M, K, N, ldx): M not a multiple of 128 (1,000,
# 333, 1), N = 200 and 17 (ragged N tiles, byte stores), K = 48 and 208 (a
# K tail inside a swizzle row), a row-strided x (ldx = K + 16), and a lone
# row against a streamed weight (K = 2048)
QMM_EDGES = [(1000, 256, 64, 256), (1, 64, 64, 64), (1000, 128, 200, 128),
             (300, 256, 17, 256), (333, 48, 128, 48), (517, 208, 200, 208),
             (1000, 256, 128, 272), (130, 1024, 512, 1040),
             (1, 2048, 512, 2048)]
# the per-forward sum B8's wgmma design is held to: half the 2.556 ms of the
# mma.sync design measured on an H100 80GB HBM3 at 700 W (PERF.md)
QMM_TARGET_MS = 1.28
PARITY_IMAGES, CALIB_PARITY_IMAGES = 2, 8
PROB_TOL, RANGE_RTOL = 1e-5, 1e-4
# slice 5: conv3x3_epilogue (B9) and the conv A/B harness (phases 13-14);
# ((N, H, W, Cin), Cout) of the ragged checks and the float32 check
CONV_BATCH, CONV_ITERS = 256, 20
CONV_RAGGED = [((2, 8, 8, 16), 32), ((4, 6, 6, 16), 32), ((1, 14, 14, 8), 16),
               ((2, 6, 6, 8), 24), ((2, 9, 11, 3), 5), ((1, 7, 7, 512), 512)]
# edges of the wgmma design's tiles (128 positions x 64 or 128 channels):
# M = 189 and Cout 96, Cout 200 over two 128-wide tiles, a tile over two
# images (M = 198, 99 positions each)
CONV_EDGES = [((3, 7, 9, 64), 96), ((1, 5, 5, 128), 200), ((2, 9, 11, 64), 64)]
CONV_F32 = ((2, 28, 28, 512), 128)
# the phases 5 and 8 numbers phases 18 and 19 print beside their own
RUNS = {}
T_START = time.monotonic()
# slice 6: the mxgen kernels (B10) and codegen_bench (phases 15-16)
GEN_TOL = 1e-5          # codegen.EQUIV_TOL: rtol = atol, ints/bools exact
GEN_TIMED = 200
GEN_CLUSTER_SLACK = 0.10    # another cluster size may be this much faster
CONV_F32_TOL = 1e-4
# bf16 outputs are held to one bf16 ulp at their magnitude, counted no
# finer than at 1/64 of the outputs' RMS (see _bf16_ulps)
CONV_BF16_FLOOR = 2.0 ** -6
# (clip_gradient, wd, rescale_grad, inv_scale, ok)
OPT_CASES = [(None, 0.0, 1.0, 1.0, 1.0), (0.5, 1e-4, 1.0, 1.0, 1.0),
             (None, 1e-4, 0.25, 1.0, 1.0), (0.3, 0.0, 1.0, 1.0 / 1024, 1.0),
             (0.5, 1e-4, 0.5, 0.5, 0.0)]
# slice 16: Gluon ResNet-50 training through the imperative loop (phase
# 21); the reference's Gluon recipe, and the tolerances of its parities:
# float64 card vs CPU after two steps (the f32 rounding floor, amplified
# ~1e6 by two chaotic steps per phase 6, is ~1e-10 in float64); the two
# training routes on the card, the first-step loss (one forward) and the
# parameters after one step in float32 ulps at max(|w0|, |w1|) (the same
# gradients under cuDNN's deterministic algorithms, so the update's
# rounding alone: a missing wd is 84 ulps on a BatchNorm gamma)
GLUON_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
GLUON_WARMUP = 2
GLUON_F64_TOL = 1e-5
GLUON_ROUTE_LOSS_TOL = 1e-5
GLUON_ROUTE_ULPS = 4
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


# the sources whose every kernel instantiation phase 1 reports from
# ptxas -v (registers, spills, C75xx advisories)
PTXAS_SOURCES = ("flash_bf16_wgmma", "flash_bwd_wgmma")


def _short_kernel(name):
    """A kernel's demangled name without its namespace and arguments."""
    name = name.split("(anonymous namespace)::")[-1]
    cut = name.find(">(")
    return name[:cut + 1] if cut >= 0 else name


def _advisories(texts):
    """ptxas's C75xx advisories of one kernel, each kind once with its
    count (the PTX line numbers dropped)."""
    kinds = {}
    for text in texts:
        kind = re.sub(r" in around line \d+", "", text)
        kinds[kind] = kinds.get(kind, 0) + 1
    return "; ".join("%s (x%d)" % kv for kv in kinds.items()) or "none"


def _dq_tile_name(bt):
    return "flash_bf16_wgmma_dq%d" % bt


def _dq_tile_sources():
    """``{library name: source}`` of dq's bf16 wgmma kernel at each key
    tile of ``flash_ablate.DQ_TILES`` but the shipped one (phase 17 times
    them against each other)."""
    from mxnet_tpu_torch.tools import flash_ablate
    out = {}
    for bt in flash_ablate.DQ_TILES:
        text, shipped = flash_ablate.dq_tile_source(bt)
        if bt != shipped:
            out[_dq_tile_name(bt)] = text
    return out


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import build
    from mxnet_tpu_torch.ops import fused_optimizer as fo

    from mxnet_tpu_torch.analysis import codegen as cg

    t0 = time.monotonic()
    emitted = {lk.symbol: lk.src for lk in cg.shipped_lowered()}
    emitted.update(_dq_tile_sources())
    # phase 15's variants too, so every nvcc of the script starts here
    variants = _gen_variant_sources()
    t1 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ptxas = pool.submit(build.ptxas_report, PTXAS_SOURCES)
        libs = build.build_all(build.KERNEL_SOURCES,
                               dict(emitted, **variants))
        report = ptxas.result()
    print("phase 1: lowered the 6 shipped mxgen chains to CUDA in %.2f s; "
          "built %s and phase 15's %d variants in %.2f s (one nvcc each, "
          "started together, beside ptxas -v of %s)"
          % (t1 - t0, sorted(n for n in libs if n not in variants),
             len(variants), time.monotonic() - t1, list(PTXAS_SOURCES)))
    for source, rows in report.items():
        for r in rows:
            print("phase 1: ptxas %s.cu %s: %s registers, spill stores %s "
                  "B, spill loads %s B, advisories: %s"
                  % (source, _short_kernel(r["kernel"]), r["registers"],
                     r["spill_stores"], r["spill_loads"],
                     _advisories(r["advisories"])))
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
        again = fo.fused_layer_norm(x, s, b)
        torch.cuda.synchronize()
        want = fo.layer_norm_reference(x, s, b)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        torch.testing.assert_close(got, want, rtol=LN_TOL, atol=LN_TOL)
        if not torch.equal(got, again):
            raise RuntimeError("fused_layer_norm %s: a rerun is not "
                               "bitwise equal" % (shape,))
        print("phase 1: fused_layer_norm %s max_abs_err %.3g, reruns "
              "bitwise" % (tuple(shape), err))
    # the prefill shape (the largest the path gives it): plain, and the
    # eager calls with the host's launch cost
    rows, width = 1024, d
    x = torch.randn(rows, width, device="cuda", generator=gen)
    s = torch.randn(width, device="cuda", generator=gen)
    b = torch.randn(width, device="cuda", generator=gen)
    fns = {"kernel": lambda: fo.fused_layer_norm(x, s, b),
           "plain": lambda: fo.layer_norm_reference(x, s, b),
           "library": lambda: F.layer_norm(x, (width,), s, b, 1e-5)}
    plain_ms = _time_ms(fns["plain"])
    print("phase 1: eager call incl. host launch: kernel %.5f ms, plain "
          "%.5f ms, F.layer_norm %.5f ms"
          % tuple(_call_ms(fns[k]) for k in ("kernel", "plain", "library")))
    times, bounds = _ln_times(torch, F, fo, gen,
                              LN_DECODE_SHAPES + [(rows, width)])
    t = times[(rows, width)]
    bytes_ms, ops_ms = bounds[(rows, width)]
    print("phase 1: fused_layer_norm (%d, %d) device time: kernel %.5f ms, "
          "plain %.5f ms, F.layer_norm %.5f ms, the design it replaced "
          "%.5f ms; bound %.6f ms"
          % (rows, width, t["kernel"], plain_ms, t["library"],
             t["previous"], max(bytes_ms, ops_ms)))
    return {"name": "fused_layer_norm", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/fused_ln.cu",
            "replaces": "mxnet_tpu/ops/fused_optimizer.py:315",
            "launches": None, "max_abs_err": worst, "ms": t["kernel"],
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": t["library"], "prev_ms": t["previous"]}


def _ln_times(torch, F, fo, gen, shapes):
    """B4 at the decode step's shapes (the slot batch, one request's
    prefill bucket of 8, one position) and the prefill's, in turns with
    the design it replaced (held to plain first), ``F.layer_norm`` and
    one tiny kernel's launch floor: CUDA graphs, a warm round, then two
    rounds in turn and in reverse, the lesser time.  Prints each beside
    the bound and the aims; fails where the replaced design is more than
    LN_PREV_SLACK faster.  Returns ``({shape: {variant: ms}}, {shape:
    (bytes ms, operations ms)})``."""
    tiny = torch.zeros(1, device="cuda")
    times, bounds, slow = {}, {}, []
    for shape in shapes:
        width = shape[-1]
        x = torch.randn(shape, device="cuda", generator=gen)
        s = torch.randn(width, device="cuda", generator=gen)
        b = torch.randn(width, device="cuda", generator=gen)
        torch.testing.assert_close(
            fo._fused_layer_norm_parts(x, s, b, ()),
            fo.layer_norm_reference(x, s, b), rtol=LN_TOL, atol=LN_TOL)
        calls = {"kernel": lambda: fo.fused_layer_norm(x, s, b),
                 "previous": lambda: fo._fused_layer_norm_parts(x, s, b,
                                                                ()),
                 "library": lambda: F.layer_norm(x, (width,), s, b, 1e-5),
                 "floor": tiny.zero_}
        keys = list(calls)
        runs = {k: [] for k in keys}
        for i, k in enumerate(keys * 2 + keys[::-1]):
            ms = _time_ms(calls[k])
            if i >= len(keys):          # the first round warms up
                runs[k].append(ms)
        t = times[shape] = {k: min(r) for k, r in runs.items()}
        rows = x.numel() // width
        nbytes = 4 * (2 * rows * width + 2 * width)
        bounds[shape] = (nbytes / HBM_BYTES_PER_S * 1e3,
                         8 * rows * width / F32_FLOPS_PER_S * 1e3)
        aim = LN_AIM_DECODE if shape in LN_DECODE_SHAPES else LN_AIM_PREFILL
        ratio = t["kernel"] / t["floor"]
        print("phase 1: fused_layer_norm %s device time: kernel %.5f ms "
              "(%.2fx the launch floor: aim <= %.2fx %s), the design it "
              "replaced %.5f ms (%.2fx), F.layer_norm %.5f ms; launch "
              "floor %.5f ms; bound %.7f ms (%d bytes)"
              % (shape, t["kernel"], ratio, aim,
                 "met" if ratio <= aim else "missed", t["previous"],
                 t["previous"] / t["floor"], t["library"], t["floor"],
                 max(bounds[shape]), nbytes))
        if t["kernel"] > (1 + LN_PREV_SLACK) * t["previous"]:
            slow.append("%s: %.5f ms against %.5f ms"
                        % (shape, t["kernel"], t["previous"]))
    if slow:
        raise RuntimeError("fused_layer_norm is more than %d %% slower than "
                           "the design it replaced: %s"
                           % (100 * LN_PREV_SLACK, "; ".join(slow)))
    return times, bounds


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
    return sum(p.tensor().numel() for p in net.collect_params().values()
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
                                 "flash_dkv_kernel",
                                 "flash_fwd_wgmma_kernel",
                                 "flash_bwd_wgmma_kernel",
                                 "flash_fwd_bf16_kernel",
                                 "flash_dq_bf16_kernel",
                                 "flash_dkv_bf16_kernel")),
    ("layer norm (B4)", ("ln_fwd",)),
    ("matmul", ("gemm", "cutlass")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _category(kernel, categories):
    """The first category whose fragments the kernel's name holds."""
    name = kernel.lower()
    return next((c for c, frags in categories
                 if any(f in name for f in frags)), "other")


def profile_train(trainer, x, y, steps=2, label="phase 5",
                  categories=PROFILE_CATEGORIES, split=None):
    """Device time by kernel category over ``steps`` training steps
    (``torch.profiler``), and the device's idle share of the window; the
    kernels of category ``split`` (a name, or a tuple of names) each on a
    line of their own."""
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
        cat = _category(e.key, categories)
        cats[cat] = cats.get(cat, 0.0) + e.self_device_time_total
    print("%s profile: %d steps, wall %.2f ms, device busy %.2f ms, "
          "idle share %.4f" % (label, steps, wall_us / 1e3, busy / 1e3,
                               1 - busy / wall_us))
    for cat, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        print("%s profile: %-24s %9.3f ms per step (%.4f of busy)"
              % (label, cat, us / steps / 1e3, us / busy))
    for cat in ((split,) if isinstance(split, str) else split or ()):
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
            if _category(e.key, categories) == cat:
                print("%s profile: %s split: %9.3f ms per step x%-3d %s"
                      % (label, cat, e.self_device_time_total / steps / 1e3,
                         e.count // steps, _short_kernel(e.key)))
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
    RUNS["phase 5"] = dict(
        batch=batch, images_s=batch * TIMED / (timed.sum() / 1e3),
        p50=np.percentile(timed, 50), p99=np.percentile(timed, 99),
        peak_gib=peak / 2 ** 30)
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
    return max((float((pa[name].tensor().detach().cpu().double()
                       - pb[rb[rel]].tensor().detach().cpu().double())
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
    arrays = {n: p.tensor().detach().numpy().copy()
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
# head dims above 128 on the CUDA-core design (the 192- and 256-wide
# builds, and D = 320 in chunks of 256): causal and not, ragged T, Tq !=
# Tk both ways
FLASH_WIDE = [(3, 197, 203, 160, True), (2, 130, 61, 160, False),
              (3, 130, 130, 256, True), (2, 61, 130, 256, False),
              (2, 77, 150, 320, True), (3, 150, 77, 320, False)]
FLASH_WIDE_TIMED = (32, 512, 512, True)     # (BH, Tq, Tk, causal)
# a q of more than 2^31 elements (forward and dq, both designs, held to
# plain on the first and last FLASH_BIG_SLICES heads): (T, D)
FLASH_BIG = (128, 16)
FLASH_BIG_SLICES = 4
# edges of the wgmma design of dq and dk/dv (own tiles of 128 rows,
# streamed tiles of 64 keys or 32 queries, D % 4 == 0 up to 32): T not a
# multiple of the tiles, Tq != Tk both ways (dk/dv blocks with no query to
# visit), T = 1, D = 32, 12 and 8; both designs are held at each
FLASH_WGMMA_EDGES = [(3, 997, 1000, 16, True), (3, 997, 1000, 32, False),
                     (2, 130, 70, 16, True), (2, 70, 130, 16, True),
                     (2, 70, 130, 32, True), (2, 70, 256, 16, True),
                     (2, 1, 1, 32, False), (4, 1, 300, 16, False),
                     (2, 33, 97, 12, True), (2, 200, 200, 8, True),
                     (2, 130, 70, 4, False), (2, 97, 33, 20, True),
                     (2, 64, 64, 24, False), (2, 200, 130, 28, True)]
# head dims the two designs are timed at besides the path's 16 (the path's
# pairings with D replaced): the measurement behind flash_design's choice
FLASH_DIMS = (4, 8, 12, 20, 24, 28, 32)
# wrapper -> (TPU kernel replaced, f32 operations per visible (q, k) pair
# and head-dim element; each pair adds one expf)
FLASH_KERNELS = {
    "flash_forward_with_lse": ("mxnet_tpu/ops/pallas_kernels.py:62", 4),
    "flash_dq": ("mxnet_tpu/ops/pallas_kernels.py:171", 6),
    "flash_dkv": ("mxnet_tpu/ops/pallas_kernels.py:226", 8),
}
# the tensor-core bound of a split-TF32 design (csrc/flash_fwd_wgmma.cu,
# csrc/flash_bwd_wgmma.cu): each product in three TF32 passes at the dense
# TF32 rate, and the non-matrix f32 operations per visible pair, counted
# from those sources.  Backward: s * scale - lse (an FMA, 2), expf (1), dp
# - delta (1), p (dp - delta) (1), and each register operand split into
# hi / lo (and, subtract, and: 3): ds for dq, p and ds for dk/dv.  Forward
# (softmax_tile): s * scale (1), the running max (1), the exponent's FMA
# (1), 2^x (1), the row sum (1), the split of p (3).
TF32_PASSES = 3
FLASH_NONMATRIX = {"flash_forward_with_lse": 8, "flash_dq": 8,
                   "flash_dkv": 11}
FLASH_SPEEDUP = 1.5     # the wgmma design against the CUDA-core one
# slice 13: the bf16 routes of B5-B7 (phase 17) at the ring path's hop
# pairings and at D = 64 and 128, causal and full: (BH, Tq, Tk, D, causal)
FLASH_BF16_CHECK = FLASH_PATH + [(64, 512, 512, 64, True),
                                 (64, 512, 512, 64, False),
                                 (32, 512, 512, 128, True),
                                 (32, 512, 512, 128, False),
                                 (3, 997, 1000, 64, True),
                                 (2, 130, 61, 320, False)]
FLASH_BF16_TIMED = [(64, 512, 512, 64, True), (32, 512, 512, 128, True)]
# the bf16 design each flash kernel takes at the path's D = 16 (phase 19)
PATH_BF16_ROUTES = {"flash_forward_with_lse": "wgmma_bf16",
                    "flash_dq": "wgmma_bf16", "flash_dkv": "wgmma_bf16"}


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


def _flash_tc_bound(name, cases):
    """(bound ms, bound_by, TF32 flops, f32 operations, bytes) of kernel
    ``name`` on the tensor cores in split TF32 over ``cases``: the largest
    of the bytes (as in :func:`_flash_bound`), three TF32 passes of every
    product over 495 TFLOP/s dense, and the non-matrix f32 operations per
    visible pair (``FLASH_NONMATRIX``) over 67 TFLOP/s."""
    tf32 = ops = 0
    for bh, tq, tk, d, causal in cases:
        pairs = bh * _pairs(tq, tk, causal)
        tf32 += pairs * FLASH_KERNELS[name][1] * d * TF32_PASSES
        ops += pairs * FLASH_NONMATRIX[name]
    nbytes = _flash_bound(name, cases)[3]
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": max(tf32 / TF32_FLOPS_PER_S,
                               ops / F32_FLOPS_PER_S) * 1e3}
    by = max(times, key=times.get)
    return times[by], by, tf32, ops, nbytes


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


def _flash_call(name, design):
    """A call of one flash kernel on its forced design, on one pairing's
    args (q, k, v, dO, lse, delta, causal, scale)."""
    from mxnet_tpu_torch.ops import pallas_kernels as pk
    if name == "flash_forward_with_lse":
        return lambda a: pk._flash_forward_with_lse(*a[:3], a[6], a[7],
                                                    design=design)
    fn = pk._flash_dq if name == "flash_dq" else pk._flash_dkv
    return lambda a: fn(*a, design=design)


def _flash_bwd_args(cases, gen):
    """Seeded (q, k, v, dO, lse, delta, causal, scale) of each pairing."""
    from mxnet_tpu_torch.ops import pallas_kernels as pk
    out = []
    for case in cases:
        q, k, v, do, causal, scale = _flash_inputs(case, gen)
        o, lse = pk.flash_forward_with_lse_reference(q, k, v, causal, scale)
        out.append((q, k, v, do, lse, pk.flash_delta(o, do), causal, scale))
    return out


def _design_hops(bwd, name, iters=20, designs=("wgmma", "simt")):
    """{design: [ms per pairing]} of one flash kernel on each of two
    designs over the pairings' args ``bwd``, timed in turns (a, b, b, a)
    and the two times of each averaged."""
    runs = {d: [] for d in designs}
    for design in designs + designs[::-1]:
        call = _flash_call(name, design)
        runs[design].append([_event_ms(lambda a=a: call(a), iters)
                             for a in bwd])
    return {design: [(x + y) / 2 for x, y in zip(*r)]
            for design, r in runs.items()}


def _flash_check(case, gen, worst):
    """Hold each design of the forward, dq and dk/dv that takes the head
    dim (routed to it or not) against their plain versions at one pairing;
    reruns bitwise, every launch counted on its design.  Returns the
    printed errors."""
    import torch
    from mxnet_tpu_torch.ops import pallas_kernels as pk
    q, k, v, do, causal, scale = _flash_inputs(case, gen)
    want_o, want_lse = pk.flash_forward_with_lse_reference(q, k, v, causal,
                                                           scale)
    delta = pk.flash_delta(want_o, do)
    args = (q, k, v, do, want_lse, delta, causal, scale)
    want = {"flash_forward_with_lse": (want_o, want_lse),
            "flash_dq": (pk.flash_dq_reference(*args),),
            "flash_dkv": pk.flash_dkv_reference(*args)}
    designs = ["simt"] + (["wgmma"] if pk.wgmma_takes(case[3]) else [])
    errs = {}
    for design in designs:
        for name in FLASH_KERNELS:
            tol = FLASH_FWD_TOL if name == "flash_forward_with_lse" \
                else FLASH_BWD_TOL
            before = pk.launch_counts()[name + "/" + design]
            call = _flash_call(name, design)
            runs = [call(args) for _ in range(2)]
            runs = [r if isinstance(r, tuple) else (r,) for r in runs]
            torch.cuda.synchronize()
            if pk.launch_counts()[name + "/" + design] != before + 2:
                raise RuntimeError("%s %s: not launched on the %s design"
                                   % (name, case, design))
            for got, again, w in zip(runs[0], runs[1], want[name]):
                if not torch.equal(got, again):
                    raise RuntimeError("%s %s on the %s design: two runs "
                                       "differ" % (name, case, design))
                torch.testing.assert_close(got, w, rtol=tol, atol=tol)
                e = float((got - w).abs().max())
                errs.setdefault((name, design), []).append(e)
                worst[(name, design)] = max(worst.get((name, design), 0.0),
                                            e)
    return errs


def phase_flash_kernels():
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import pallas_kernels as pk

    # the plain versions and the library yardstick in full f32: no TF32
    # matmuls, whatever the process had set; restored after
    saved = torch.backends.cuda.matmul.allow_tf32
    print("phase 7: precision flags as found: matmul.allow_tf32=%s "
          "cudnn.allow_tf32=%s float32_matmul_precision=%s; matmul TF32 "
          "off for this phase" % (saved, torch.backends.cudnn.allow_tf32,
                                  torch.get_float32_matmul_precision()))
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _phase_flash_kernels(torch, F, pk)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _phase_flash_kernels(torch, F, pk):
    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = {}
    for d in sorted({c[3] for c in FLASH_CHECK + FLASH_WGMMA_EDGES
                     + FLASH_WIDE} | set(FLASH_DIMS)):
        if pk._simt_shape_built(d) != pk.simt_launch_shape(d)[:4]:
            raise RuntimeError("head dim %d: csrc/flash_attention.cu "
                               "launches %s, simt_launch_shape says %s"
                               % (d, pk._simt_shape_built(d),
                                  pk.simt_launch_shape(d)))
    for case in FLASH_CHECK + FLASH_WGMMA_EDGES + FLASH_WIDE:
        errs = _flash_check(case, gen, worst)
        print("phase 7: %s max_abs_err %s, reruns bitwise"
              % (case, {"%s/%s" % k: ["%.3g" % e for e in v]
                        for k, v in errs.items()}))
        torch.cuda.empty_cache()

    # timing at the path's shapes: one layer's pairings (hop 0 + hop 1),
    # both designs of each kernel on the same inputs, in turns
    bwd = _flash_bwd_args(FLASH_PATH, gen)
    design_hops = {(name, design): per_hop for name in FLASH_KERNELS
                   for design, per_hop in _design_hops(bwd, name).items()}
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
        plain_ms = _event_ms(plain[name], iters=5)
        bound_ms, bound_by, flops, nbytes = _flash_bound(name, FLASH_PATH)
        tc_ms, tc_by, tf32, ops, _ = _flash_tc_bound(name, FLASH_PATH)
        wg_hops, simt_hops = (design_hops[(name, "wgmma")],
                              design_hops[(name, "simt")])
        ms, simt_ms = sum(wg_hops), sum(simt_hops)
        speedup = simt_ms / ms
        print("phase 7: %s per layer %s: wgmma %.5f ms (hops %s), CUDA-core "
              "(simt) %.5f ms (hops %s): %.2fx, target %.1fx %s; plain %.5f "
              "ms, library %.5f ms (%s)"
              % (name, FLASH_PATH, ms, ["%.5f" % x for x in wg_hops],
                 simt_ms, ["%.5f" % x for x in simt_hops], speedup,
                 FLASH_SPEEDUP, "met" if speedup >= FLASH_SPEEDUP
                 else "missed", plain_ms, library[name],
                 "its forward" if name == "flash_forward_with_lse"
                 else "its backward: B6+B7 together"))
        print("phase 7: %s bounds: split-TF32 tensor-core %.5f ms (%s: %d "
              "TF32 flops, %d f32 operations, %d bytes), wgmma at %.1f %% "
              "of it; f32 CUDA-core %.5f ms (%s: %d flops), simt at %.1f %% "
              "of it, wgmma at %.1f %%"
              % (name, tc_ms, tc_by, tf32, ops, nbytes, 100 * tc_ms / ms,
                 bound_ms, bound_by, flops, 100 * bound_ms / simt_ms,
                 100 * bound_ms / ms))
        out.append({"name": name, "route": "cuda",
                    "source": "mxnet_tpu_torch/csrc/%s.cu"
                    % pk._FLASH_DESIGNS["wgmma"][name][0],
                    "replaces": replaces, "design": "wgmma",
                    "launches": None,
                    "max_abs_err": worst[(name, "wgmma")], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": tc_ms,
                    "bound_by": tc_by, "library_ms": library[name],
                    "simt_ms": simt_ms, "simt_max_abs_err":
                    worst[(name, "simt")]})
    print("phase 7: library scaled_dot_product_attention (f32) ran %s"
          % backend)
    print("phase 7: tolerances out/lse %g, dq/dk/dv %g; worst %s"
          % (FLASH_FWD_TOL, FLASH_BWD_TOL,
             {"%s/%s" % k: "%.3g" % v for k, v in worst.items()}))
    del bwd, lib_in, outs
    torch.cuda.empty_cache()
    _flash_dim_sweep(torch, pk, gen, design_hops)
    _flash_wide_times(pk, gen)
    _flash_past_int32(torch, pk, gen)
    return out


def _flash_wide_times(pk, gen):
    """The CUDA-core design at the head dims above 128 (FLASH_WIDE's),
    timed at FLASH_WIDE_TIMED beside its f32 bound."""
    bh, tq, tk, causal = FLASH_WIDE_TIMED
    for d in sorted({c[3] for c in FLASH_WIDE}):
        case = (bh, tq, tk, d, causal)
        (args,) = _flash_bwd_args([case], gen)
        times = {name: _event_ms(lambda: _flash_call(name, "simt")(args))
                 for name in FLASH_KERNELS}
        print("phase 7: head dim %d on the CUDA-core design %s (shape %s): "
              "%s" % (d, case, pk.simt_launch_shape(d), ", ".join(
                  "%s %.5f ms (f32 bound %.5f ms)"
                  % (name, ms, _flash_bound(name, [case])[0])
                  for name, ms in times.items())))
        del args


def _flash_past_int32(torch, pk, gen):
    """A forward and a dq with q of more than 2^31 elements, on the
    design flash_design picks and on the CUDA-core one, held to plain on
    the first and last FLASH_BIG_SLICES heads (the kernels index in 64
    bits; nothing refuses the size)."""
    t, d = FLASH_BIG
    bh = 2 ** 31 // (t * d) + FLASH_BIG_SLICES
    q, k, v = (torch.randn(bh, t, d, device="cuda", generator=gen)
               for _ in range(3))
    do, scale = v, d ** -0.5
    ends = list(range(FLASH_BIG_SLICES)) + list(range(bh - FLASH_BIG_SLICES,
                                                      bh))
    errs = {}
    for design in (pk.flash_design(d, "flash_forward_with_lse"), "simt"):
        o, lse = pk._flash_forward_with_lse(q, k, v, True, scale,
                                            design=design)
        delta = torch.empty_like(lse)
        for b0 in range(0, bh, 65536):
            delta[b0:b0 + 65536] = pk.flash_delta(o[b0:b0 + 65536],
                                                  do[b0:b0 + 65536])
        dq = pk._flash_dq(q, k, v, do, lse, delta, True, scale,
                          design=design)
        torch.cuda.synchronize()
        sl = torch.tensor(ends, device="cuda")
        want_o, want_lse = pk.flash_forward_with_lse_reference(
            q[sl], k[sl], v[sl], True, scale)
        want_dq = pk.flash_dq_reference(q[sl], k[sl], v[sl], do[sl],
                                        lse[sl], delta[sl], True, scale)
        for got, want, tol in ((o[sl], want_o, FLASH_FWD_TOL),
                               (lse[sl], want_lse, FLASH_FWD_TOL),
                               (dq[sl], want_dq, FLASH_BWD_TOL)):
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            errs[design] = max(errs.get(design, 0.0),
                               float((got - want).abs().max()))
        del o, lse, delta, dq
        torch.cuda.empty_cache()
    print("phase 7: q of %d elements (%d x %d x %d, past 2^31): forward "
          "and dq on %s held to plain on heads %s, max_abs_err %s"
          % (bh * t * d, bh, t, d, sorted(errs), ends,
             {k: "%.3g" % e for k, e in errs.items()}))
    del q, k, v, do
    torch.cuda.empty_cache()


def _flash_dim_sweep(torch, pk, gen, design_hops):
    """Both designs of each flash kernel per layer at the path's pairings
    with each head dim of FLASH_DIMS, beside flash_design's choice there;
    fails where the chosen design is the slower one."""
    per_dim = {16: {key: sum(h) for key, h in design_hops.items()}}
    for d in FLASH_DIMS:
        bwd = _flash_bwd_args([c[:3] + (d,) + c[4:] for c in FLASH_PATH],
                              gen)
        per_dim[d] = {(name, design): sum(h) for name in FLASH_KERNELS
                      for design, h in _design_hops(bwd, name).items()}
        del bwd
        torch.cuda.empty_cache()
    wrong = []
    for d in sorted(per_dim):
        ms = per_dim[d]
        chosen = {name: pk.flash_design(d, name) for name in FLASH_KERNELS}
        print("phase 7: head dim %d per layer: %s" % (d, ", ".join(
            "%s wgmma %.5f / simt %.5f ms (%.2fx), flash_design %s"
            % (name, ms[(name, "wgmma")], ms[(name, "simt")],
               ms[(name, "simt")] / ms[(name, "wgmma")], chosen[name])
            for name in FLASH_KERNELS)))
        for name in FLASH_KERNELS:
            if ms[(name, chosen[name])] <= min(ms[(name, "wgmma")],
                                               ms[(name, "simt")]):
                continue
            # one timing outlier must not sink the run: time both
            # designs of this pair again, interleaved, and fail only if
            # the chosen one is still the slower
            bwd = _flash_bwd_args([c[:3] + (d,) + c[4:]
                                   for c in FLASH_PATH], gen)
            again = {x: sum(h) for x, h in _design_hops(bwd, name).items()}
            del bwd
            torch.cuda.empty_cache()
            print("phase 7: head dim %d %s missed (wgmma %.5f / simt %.5f "
                  "ms); re-timed: wgmma %.5f / simt %.5f ms, flash_design "
                  "%s" % (d, name, ms[(name, "wgmma")], ms[(name, "simt")],
                          again["wgmma"], again["simt"], chosen[name]))
            if again[chosen[name]] > min(again.values()):
                wrong.append("%s at D = %d" % (name, d))
    if wrong:
        raise RuntimeError("flash_design chose the slower design for %s"
                           % ", ".join(wrong))


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
    if any(flash[n + "/wgmma"] != want for n in FLASH_KERNELS):
        raise RuntimeError("flash launches by design %s, want all %d of "
                           "each kernel on the wgmma design"
                           % ({k: v for k, v in flash.items() if "/" in k
                               and k.startswith("flash")}, want))
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
          "fused_layer_norm %d (>= %d)"
          % ({k: v for k, v in flash.items() if k.startswith("flash")},
             steps, CFG["n_layers"], k_ranks, ln,
             steps * (2 * CFG["n_layers"] + 1)))
    RUNS["phase 8"] = dict(losses=losses,
                           tokens_s=tokens * TIMED / (timed.sum() / 1e3))
    if profile:
        x, y = batches[-1]
        profile_train(tr, x, y, label="phase 8",
                      split=LM_PROFILE_CATEGORIES[0][0],
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
def _qmm_bound(shapes):
    """(bound ms, bound_by) of B8 over ``shapes``: x, w, bias read once,
    the int8 output written once; 2 int8 operations per multiply-add."""
    nbytes = sum(m * k + n * k + 4 * n + m * n for m, k, n in shapes)
    ops = sum(2 * m * k * n for m, k, n in shapes)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT8_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, ops)


def _qmm_inputs(shape, gen, ldx=None):
    """Seeded ``(x, w, bias, scale)`` on the card; ``x`` is a view of
    row stride ``ldx`` (default K) when that is wider than K."""
    import torch
    m, k, n = shape
    x = torch.randint(-127, 128, (m, ldx or k), device="cuda",
                      dtype=torch.int8, generator=gen)[:, :k]
    w = torch.randint(-127, 128, (n, k), device="cuda", dtype=torch.int8,
                      generator=gen)
    bias = torch.randn(n, device="cuda", generator=gen) * 10
    # codes spread over the int8 range: acc has std ~ sqrt(K) * 127**2 / 3
    scale = 60.0 / (np.sqrt(k) * 127 * 127 / 3)
    return x, w, bias, scale


def _qmm_check(pk, shape, relu, gen, ldx=None, design=None):
    """B8 on ``design`` (default: the one ``qmm_design`` names) against
    its plain version, bitwise, and a rerun bitwise; the two launches
    counted on that design.  Returns the design."""
    import torch
    x, w, bias, scale = _qmm_inputs(shape, gen, ldx)
    chosen = pk.qmm_design(shape[1], x.stride(0), x.data_ptr() % 16 == 0)
    design = design or chosen
    key = "qmm_requant/" + design
    before = pk.launch_counts()[key]
    got = pk._qmm_requant(x, w, bias, scale, relu, design=design)
    again = pk._qmm_requant(x, w, bias, scale, relu, design=design)
    want = pk.qmm_requant_reference(x, w, bias, scale, relu=relu)
    torch.cuda.synchronize()
    if pk.launch_counts()[key] != before + 2:
        raise RuntimeError("qmm_requant %s: not launched on the %s design"
                           % (shape, design))
    if not torch.equal(got, want) or not torch.equal(got, again):
        raise RuntimeError("qmm_requant %s ldx=%s relu=%s on the %s design: "
                           "%d codes differ from the plain version, rerun "
                           "equal %s" % (shape, ldx, relu, design,
                                         int((got != want).sum()),
                                         torch.equal(got, again)))
    return design


def phase_qmm_kernel():
    """Phase 10: B8 against its plain version on the wgmma design at the
    16 path shapes and the design's edges, on the mma.sync design at
    QMM_RAGGED; then each stage of one forward timed on both designs
    beside plain, library and bound."""
    import torch
    from mxnet_tpu_torch.ops import pallas_kernels as pk
    from mxnet_tpu_torch.ops.quantization import int8_dot
    from mxnet_tpu_torch.tools import qmm_ablate

    gen = torch.Generator(device="cuda").manual_seed(10)
    stages = qmm_ablate.path_stages(QBATCH)
    path = [shape for shapes in stages for shape in shapes]
    designs = {}
    for shape, ldx in [(s, None) for s in path] + [
            (e[:3], e[3]) for e in QMM_EDGES]:
        for relu in (True, False):
            design = _qmm_check(pk, shape, relu, gen, ldx)
            designs.setdefault(design, set()).add((shape, ldx))
        torch.cuda.empty_cache()
    if set(designs) != {"wgmma"}:
        raise RuntimeError("not on the wgmma design: %s"
                           % sorted(designs.get("mma", ())))
    for shape in QMM_RAGGED:
        for relu in (True, False):
            _qmm_check(pk, shape, relu, gen, design="mma")
            _qmm_check(pk, shape, relu, gen)
    print("phase 10: qmm_requant bitwise equal to its plain version and to "
          "a rerun, relu on and off: on the wgmma design at the %d path "
          "shapes of batch %d and the edges (M, K, N, ldx) %s; on the "
          "mma.sync design at %s (routed there: %s)"
          % (len(path), QBATCH, QMM_EDGES, QMM_RAGGED,
             [s for s in QMM_RAGGED
              if pk.qmm_design(s[1], s[1]) == "mma"]))
    keys = ("kernel", "mma", "eager", "plain", "library")
    times = dict.fromkeys(keys, 0.0)
    for number, shapes in enumerate(stages, 1):
        stage = dict.fromkeys(keys, 0.0)
        for shape in shapes:
            x, w, bias, scale = _qmm_inputs(shape, gen)
            fns = {"kernel": lambda: pk.qmm_requant(x, w, bias, scale),
                   "mma": lambda: pk._qmm_requant(x, w, bias, scale,
                                                  design="mma"),
                   "plain": lambda: pk.qmm_requant_reference(x, w, bias,
                                                             scale),
                   "library": lambda: pk._requant(int8_dot(x, w), scale,
                                                  bias, True)}
            # the two designs: device time (CUDA graphs); the kernel also
            # in eager calls between CUDA events, host launch cost included
            stage["kernel"] += _time_ms(fns["kernel"], iters=20, replays=5)
            stage["mma"] += _time_ms(fns["mma"], iters=20, replays=5)
            stage["eager"] += _event_ms(fns["kernel"], iters=10)
            stage["plain"] += _event_ms(fns["plain"], iters=2)
            stage["library"] += _event_ms(fns["library"], iters=10)
            del x, w, fns
            torch.cuda.empty_cache()
        bound = _qmm_bound(shapes)
        print("phase 10: stage %d (M %d, (K, N) %s): wgmma %.5f ms (%.1f %% "
              "of bound), mma.sync %.5f ms (%.1f %%), wgmma no slower %s; "
              "eager %.5f ms, plain %.5f ms, library %.5f ms, bound %.5f "
              "ms (%s)" % (number, shapes[0][0],
                           [s[1:] for s in shapes], stage["kernel"],
                           100 * bound[0] / stage["kernel"], stage["mma"],
                           100 * bound[0] / stage["mma"],
                           stage["kernel"] <= stage["mma"], stage["eager"],
                           stage["plain"], stage["library"], bound[0],
                           bound[1]))
        for key in keys:
            times[key] += stage[key]
    bound_ms, bound_by, nbytes, ops = _qmm_bound(path)
    print("phase 10: one forward's 16 launches (batch %d), device time: "
          "kernel (wgmma) %.5f ms (%.1f %% of the bound; at most %.2f ms "
          "%s), mma.sync design %.5f ms (%.1f %%), kernel in eager calls "
          "%.5f ms, plain %.5f ms, torch._int_mm + torch epilogue %.5f ms; "
          "bound %.5f ms (%s: %d bytes, %d int8 operations)"
          % (QBATCH, times["kernel"], 100 * bound_ms / times["kernel"],
             QMM_TARGET_MS, "met" if times["kernel"] <= QMM_TARGET_MS
             else "MISSED", times["mma"], 100 * bound_ms / times["mma"],
             times["eager"], times["plain"], times["library"], bound_ms,
             bound_by, nbytes, ops))
    return {"name": "qmm_requant", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/qmm_wgmma.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:436",
            "launches": None, "max_abs_err": 0, "ms": times["kernel"],
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
    ("qmm_requant (B8)", ("qmm_requant_kernel", "qmm_wgmma_kernel")),
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
        cat = _category(e.key, categories)
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
    if counts["qmm_requant"] != 16 * forwards \
            or counts["qmm_requant/wgmma"] != 16 * forwards \
            or counts["qmm_requant/mma"] != 0:
        raise RuntimeError("qmm_requant launched %s times, want 16 x %d "
                           "forwards, all on the wgmma design"
                           % ({k: v for k, v in counts.items()
                               if k.startswith("qmm")}, forwards))
    timed = np.asarray(times[WARMUP:])
    print("phase 11: batch %d: %.1f images/s over %d timed forwards; p50 "
          "%.2f ms, p99 %.2f ms; warm-up %s ms; peak memory %.2f GiB"
          % (QBATCH, QBATCH * QTIMED / (timed.sum() / 1e3), QTIMED,
             np.percentile(timed, 50), np.percentile(timed, 99),
             ["%.1f" % t for t in times[:WARMUP]], peak / 2 ** 30))
    print("phase 11: launches %s (qmm_requant = qmm_requant/wgmma = 16 x %d "
          "forwards: %d served batches + %d)"
          % (counts, forwards, served_batches, WARMUP + QTIMED))
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
    within CONV_F32_TOL relative; a rerun bitwise equal; the launch on
    the design ``conv3x3_design`` names for the shape.  Returns (max
    absolute error, bf16 ulps or 0, outputs beyond one strict bf16 ulp,
    design)."""
    import torch
    x, w, scale, shift = _conv_inputs(shape, cout, route, gen)
    design = pk.conv3x3_design(shape[-1], x.dtype, x.data_ptr() % 16 == 0)
    before = pk.launch_counts()["conv3x3_epilogue/" + design]
    got = pk.conv3x3_epilogue(x, w, scale, shift, relu=relu)
    again = pk.conv3x3_epilogue(x, w, scale, shift, relu=relu)
    want = pk.conv3x3_epilogue_reference(x, w, scale, shift, relu=relu)
    torch.cuda.synchronize()
    case = "conv3x3_epilogue %s -> %d %s relu=%s" % (shape, cout, route,
                                                     relu)
    if pk.launch_counts()["conv3x3_epilogue/" + design] != before + 2:
        raise RuntimeError("%s: not launched on the %s design"
                           % (case, design))
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
        return err, 0.0, 0, design
    if route == "bf16":
        ulps = float(_bf16_ulps(got, want).max())
        strict = int((diff > _bf16_ulp(torch.maximum(
            got.float().abs(), want.float().abs()))).sum())
        if ulps > 1.0:
            raise RuntimeError("%s: outputs beyond one bf16 ulp (worst %.3g "
                               "ulps, %.3g absolute)" % (case, ulps, err))
        return err, ulps, strict, design
    tol = CONV_F32_TOL * max(1.0, float(want.abs().max()))
    if err > tol:
        raise RuntimeError("%s: max |diff| %.3g above %.3g"
                           % (case, err, tol))
    return err, 0.0, 0, design


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
    ("conv3x3_epilogue (B9)", ("conv3x3_kernel", "conv3x3_wgmma_kernel")),
    ("cuDNN convolution", ("fprop", "conv", "implicit")),
    ("int8 GEMM (torch._int_mm)", ("gemm", "cutlass", "imma", "xmma")),
    ("im2col / layout copies", ("cat", "copy", "pad")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def phase_conv_kernel(profile=False):
    """Phase 13: B9 against its plain version, on the design each shape is
    routed to, then the four harness stages timed per route: the wgmma
    design (the main path), the mma.sync design on the same inputs, plain,
    library, bound and the weight repack.  With ``profile``, the device
    time by category of one pass of the library route and of B9."""
    import torch
    from mxnet_tpu_torch.ops import pallas_kernels as pk
    from mxnet_tpu_torch.tools import conv_ab

    gen = torch.Generator(device="cuda").manual_seed(13)
    worst = {"int8": 0.0, "bf16": 0.0, "float32": 0.0}
    ulps = strict = outputs = 0
    designs = {}
    stages = [((CONV_BATCH, h, w, c), c) for h, w, c in conv_ab.STAGES]
    checks = [(r, shape, cout) for r in ("int8", "bf16")
              for shape, cout in stages + CONV_RAGGED + CONV_EDGES]
    for route, shape, cout in checks + [("float32",) + CONV_F32]:
        for relu in (True, False):
            err, u, n, design = _conv_check(pk, shape, cout, route, relu,
                                            gen)
            designs.setdefault(design, set()).add((route, tuple(shape),
                                                   cout))
            worst[route] = max(worst[route], err)
            if route == "bf16":
                ulps, strict = max(ulps, u), strict + n
                outputs += int(np.prod(shape[:-1])) * cout
        torch.cuda.empty_cache()
    wanted = {(r, tuple(s), c) for r in ("int8", "bf16")
              for s, c in stages + CONV_EDGES + [CONV_RAGGED[-1]]}
    if not wanted <= designs.get("wgmma", set()):
        raise RuntimeError("not on the wgmma design: %s"
                           % sorted(wanted - designs.get("wgmma", set())))
    print("phase 13: conv3x3_epilogue int8 bitwise equal to its plain "
          "version and to a rerun at the 4 harness stages of batch %d, "
          "%s and the tile edges %s, relu on and off (worst code "
          "difference %g)"
          % (CONV_BATCH, [(tuple(s), c) for s, c in CONV_RAGGED],
             [(tuple(s), c) for s, c in CONV_EDGES], worst["int8"]))
    print("phase 13: bf16 there within one bf16 ulp (floor %g x rms): worst "
          "%.4g ulps, max |diff| %.4g; %d of %d outputs beyond one ulp at "
          "their own magnitude; reruns bitwise"
          % (CONV_BF16_FLOOR, ulps, worst["bf16"], strict, outputs))
    print("phase 13: float32 at %s within %g relative: max |diff| %.4g"
          % (CONV_F32, CONV_F32_TOL, worst["float32"]))
    for design in sorted(designs):
        print("phase 13: on the %s design: %s"
              % (design, sorted(designs[design])))
    library = {"int8": conv_ab.library_int8, "bf16": conv_ab.library_bf16}
    out = []
    for route in ("int8", "bf16"):
        keys = ("kernel", "mma", "plain", "library", "repack")
        times = dict.fromkeys(keys, 0.0)
        for shape, cout in stages:
            x, w, scale, shift = _conv_inputs(shape, cout, route, gen)
            fns = {"kernel": lambda: pk.conv3x3_epilogue(x, w, scale, shift),
                   "mma": lambda: pk._conv3x3_epilogue(
                       x, w, scale, shift, design="mma"),
                   "plain": lambda: pk.conv3x3_epilogue_reference(
                       x, w, scale, shift),
                   "library": lambda: library[route](x, w, scale, shift)}
            stage = {key: _event_ms(fn, iters=2 if key == "plain" else 10)
                     for key, fn in fns.items()}
            # the wrapper's per-call weight repack, device time alone
            stage["repack"] = _time_ms(
                lambda: w.permute(3, 0, 1, 2).contiguous(), iters=20,
                replays=5)
            for key in keys:
                times[key] += stage[key]
            bound = _conv_bound([shape[1:]], CONV_BATCH, route)[0]
            print("phase 13: %s %s -> %d: wgmma %.5f ms (%.1f %% of bound), "
                  "mma.sync %.5f ms, plain %.5f ms, library %.5f ms, bound "
                  "%.5f ms, repack %.5f ms"
                  % (route, tuple(shape), cout, stage["kernel"],
                     100 * bound / stage["kernel"], stage["mma"],
                     stage["plain"], stage["library"], bound,
                     stage["repack"]))
            del x, w, fns
            torch.cuda.empty_cache()
        bound_ms, bound_by, nbytes, ops = _conv_bound(conv_ab.STAGES,
                                                      CONV_BATCH, route)
        print("phase 13: %s, one pass of the 4 stages (batch %d), device "
              "time: kernel (wgmma) %.5f ms, mma.sync design %.5f ms, plain "
              "%.5f ms, library %s %.5f ms; bound %.5f ms (%s: %d bytes, %d "
              "operations); %.1f %% of the bound (mma.sync %.1f %%); the "
              "weight repack %.5f ms, %.1f %% of the kernel's time"
              % (route, CONV_BATCH, times["kernel"], times["mma"],
                 times["plain"],
                 "int8_conv (im2col + torch._int_mm) + torch epilogue"
                 if route == "int8" else "F.conv2d (cuDNN, bf16 sums "
                 "rounded before the epilogue) + torch epilogue",
                 times["library"], bound_ms, bound_by, nbytes, ops,
                 100 * bound_ms / times["kernel"],
                 100 * bound_ms / times["mma"], times["repack"],
                 100 * times["repack"] / times["kernel"]))
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
                    "source": "mxnet_tpu_torch/csrc/conv3x3_wgmma.cu",
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
            or any(v != per_route for v in launches.values()) \
            or counts["conv3x3_epilogue/wgmma"] != 2 * per_route \
            or counts["conv3x3_epilogue/mma"] != 0:
        raise RuntimeError("conv3x3_epilogue launched %s times in the "
                           "harness, want %d per route, all on the wgmma "
                           "design" % (counts, per_route))
    for lib, ker in zip(recs[::2], recs[1::2]):
        print("phase 14: %s %s: kernel %.5f ms, library %.5f ms (%.2fx), "
              "%.1f images/s" % (tuple(ker["stage"]), ker["dtype"],
                                 ker["ms"], lib["ms"], lib["ms"] / ker["ms"],
                                 ker["img_per_s"]))
    print("phase 14: conv_ab %s: %d records in %.2f s; conv3x3_epilogue "
          "launched %d times (int8 %d, bf16 %d = 4 stages x (1 warm-up + "
          "%d)), %d on the wgmma design, %d on the mma.sync design"
          % (" ".join(argv), len(recs), wall, counts["conv3x3_epilogue"],
             launches["int8"], launches["bf16"], CONV_ITERS,
             counts["conv3x3_epilogue/wgmma"],
             counts["conv3x3_epilogue/mma"]))
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


def _rows_sweep_ir():
    """A synthetic chain for the row plan over rows (3, 4) of 40 columns
    (a ragged second lane group): a column mean read back by every row
    (a second phase), sums across rows in the second phase too (a second
    exchange), reductions across rows of every kind (sum, max, min, prod,
    and, or; f32, int32, bool), one keeping a row axis, one of a (…, 1)
    value and one to a scalar read back by the rows; every value the
    kernel must write is an output."""
    avals, lits, ops = {}, {}, []

    def val(shape, dtype):
        k = str(len(avals))
        avals[k] = [list(shape), dtype]
        return int(k)

    def op(prim, ins, out_shape, out_dtype="float32", **params):
        out = val(out_shape, out_dtype)
        ops.append({"prim": prim, "in": ins, "out": [out],
                    "params": params})
        return out

    R, C, f = (3, 4), 40, "float32"
    S, S1 = R + (C,), R + (1,)
    x, g, i, b, t = (val(S, f), val((C,), f), val(S, "int32"),
                     val(S, "bool"), val(S1, f))
    inv = val((), f)
    lits[str(inv)] = {"dtype": f, "shape": [], "values": ["0x3daaaaab"]}
    col = op("reduce_sum", [x], (C,), axes=[0, 1])
    mean = op("mul", [col, inv], (C,))
    cen = op("sub", [x, op("broadcast_in_dim", [mean], (1, 1, C),
                           shape=[1, 1, C], broadcast_dimensions=[2])], S)
    y = op("mul", [cen, op("broadcast_in_dim", [g], (1, 1, C),
                           shape=[1, 1, C], broadcast_dimensions=[2])], S)
    tot = op("reduce_sum", [t], (), axes=[0, 1, 2])
    z = op("mul", [y, op("broadcast_in_dim", [tot], S, shape=list(S),
                         broadcast_dimensions=[])], S)
    outs = [col, y, z, tot,
            op("reduce_max", [y], R, axes=[2]),
            op("reduce_sum", [y], (C,), axes=[0, 1]),
            op("reduce_max", [z], (), axes=[0, 1, 2]),
            op("reduce_min", [x], (4, C), axes=[0]),
            op("reduce_prod", [t], (), axes=[0, 1, 2]),
            op("reduce_sum", [i], (C,), "int32", axes=[0, 1]),
            op("reduce_and", [b], (C,), "bool", axes=[0, 1]),
            op("reduce_or", [b], (), "bool", axes=[0, 1, 2])]
    return {"name": "_gen_rows_sweep", "kind": "normalization",
            "ext_in": [x, g, i, b, t], "ext_out": outs, "avals": avals,
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
        print("phase 15: %s (%s, %d eqns, %d in / %d out; plan %s, "
              "cluster %d, %d threads, %d B shared, workspace %d B %s): "
              "whole-array%s within %g of its twin, max |diff| %.3g, "
              "reruns bitwise"
              % (gk.name, gk.kind, gk.n_ops, len(xs), len(gk.out_avals),
                 lk.plan, lk.cluster, lk.threads, lk.layout.smem_bytes,
                 lk.ws_bytes, "shared" if lk.ws_shared else "global",
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
    rows_sweep = {c: cg.lower_chain(_rows_sweep_ir(),
                                    "_gen_rows_sweep_c%d" % c, cluster=c)
                  for c in cg._ROW_CLUSTERS}
    build.build_all((), {lk.symbol: lk.src for lk in rows_sweep.values()})
    for c, lk in rows_sweep.items():
        ok, err = cg.equivalence_check(lk, "cuda")
        if not ok:
            raise RuntimeError("the row sweep at cluster %d differs from "
                               "its twin: max |diff| %g" % (c, err))
    print("phase 15: row sweep (%d eqns, %d phases, %d exchanges, ragged "
          "columns, f32/int32/bool reductions across rows) on the row "
          "plan at clusters %s within %g of its twin"
          % (lk.n_ops, lk.layout.n_phases, lk.layout.exchanges,
             sorted(rows_sweep), GEN_TOL))
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

    # the row plan at each cluster size, the flat plan at each size and
    # the group plan, held to the twin and timed in turns: codegen must
    # pin the fastest size, and the flat plan beat the group plan
    tiny = torch.zeros(1, device="cuda")
    floor_ms = _time_ms(lambda: tiny.zero_())
    by_plan = _gen_plan_times(kernels, worst, floor_ms)

    # times: the kernel's device time (CUDA graph of GEN_TIMED calls),
    # its eager call with the host's launch cost, and the eager twin
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
                    else "operations", "library_ms": library_ms,
                    "plan": gk.lowered.plan, "cluster": gk.lowered.cluster,
                    "plan_ms": by_plan.get(gk.name)})
    return out


def _gen_variant_sources():
    """``{symbol: CUDA text}`` of every kernel phase 15 builds beyond the
    shipped six (the seam's mutants, the two sweeps, each plan variant of
    ``_gen_plan_times``), lowered as phase 15 lowers them: phase 1 builds
    them in its one parallel ``nvcc`` batch, and phase 15 finds them
    built (a library is named by the hash of its text)."""
    from mxnet_tpu_torch.analysis import codegen as cg
    out = {}
    chains = {lk.name: lk.chain for lk in cg.shipped_lowered()}
    cg.MXGEN_LOWER_EXACT = False
    try:
        for n, c in chains.items():
            if "sub" in c.prims:
                lk = cg.lower_chain(c)
                out[lk.symbol] = lk.src
    finally:
        cg.MXGEN_LOWER_EXACT = True
    sweep = cg.lower_chain(_sweep_ir())
    if sweep.src is not None:
        out[sweep.symbol] = sweep.src
    for c in cg._ROW_CLUSTERS:
        lk = cg.lower_chain(_rows_sweep_ir(), "_gen_rows_sweep_c%d" % c,
                            cluster=c)
        out[lk.symbol] = lk.src
    for lk in cg.shipped_lowered():
        for v in _gen_plan_variants(lk).values():
            out[v.symbol] = v.src
    return out


def _gen_plan_variants(lk):
    """``{variant: lowered kernel}`` of one shipped kernel for
    ``_gen_plan_times``: the group plan, and each cluster size (row
    plan) or each flat size (flat plan); empty on another plan."""
    from mxnet_tpu_torch.analysis import codegen as cg
    if lk.plan not in ("rows", "flat"):
        return {}
    vs = {"groups": cg.lower_chain(lk.chain, lk.name + "_groups",
                                   plan="groups")}
    if lk.plan == "rows":
        for c in cg._ROW_CLUSTERS:
            if lk.layout.fits(c) is None:
                vs["c%d" % c] = cg.lower_chain(
                    lk.chain, "%s_c%d" % (lk.name, c), plan="rows",
                    cluster=c)
    else:
        for t, e in cg._FLAT_SIZES:
            vs["t%d_e%d" % (t, e)] = cg.lower_chain(
                lk.chain, "%s_t%d_e%d" % (lk.name, t, e), flat=(t, e))
    return vs


def _gen_plan_times(kernels, worst, floor_ms):
    """Each row-plan kernel emitted at every cluster size it takes, and
    each flat-plan kernel at every size of ``codegen._FLAT_SIZES``
    (threads a block x elements a thread), and both on the group plan
    (the design they replaced), all built at once, each held to the twin
    (reruns bitwise; a flat kernel's outputs also bitwise the group
    plan's) and timed in turns (CUDA graphs; a warm round, then two
    rounds in turn and in reverse, the lesser time).  Fails when another
    size is more than GEN_CLUSTER_SLACK faster than the one
    codegen.ROW_CLUSTER or codegen.FLAT_THREADS / FLAT_PER_THREAD pins,
    or the group plan than the flat plan.  Returns {kernel name:
    {variant: ms}}."""
    import torch
    from mxnet_tpu_torch.ops import build
    from mxnet_tpu_torch.ops import generated_kernels as gen

    variants, pinned = {}, {}
    for gk in kernels:
        lk = gk.lowered
        vs = _gen_plan_variants(lk)
        if not vs:
            continue
        pinned[gk.name] = "c%d" % lk.cluster if lk.plan == "rows" else \
            "t%d_e%d" % (lk.threads, lk.layout.per_thread)
        variants[gk.name] = vs
    build.build_all((), {v.symbol: v.src for vs in variants.values()
                         for v in vs.values()})
    out, slow = {}, []
    for name, vs in variants.items():
        xs = _gen_inputs(vs["groups"])
        gks = {k: gen.GeneratedKernel(v) for k, v in vs.items()}
        for k, g in gks.items():
            worst[name] = max(worst[name], _gen_check(g, xs))
        flat = pinned[name].startswith("t")
        if flat:
            want = gen.generated_call(gks["groups"], *xs)
            for k, g in gks.items():
                got = gen.generated_call(g, *xs)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise RuntimeError("%s on the flat plan at %s is not "
                                       "bitwise the group plan" % (name, k))
        keys = list(gks)
        runs = {k: [] for k in keys}
        for i, k in enumerate(keys * 2 + keys[::-1]):
            ms = _time_ms(lambda g=gks[k]: gen.generated_call(g, *xs),
                          iters=GEN_TIMED)
            if i >= len(keys):
                runs[k].append(ms)
        times = {k: min(r) for k, r in runs.items()}
        pin = pinned[name]
        best = min((k for k in times if k != "groups"), key=times.get)
        sizes = {k: round(t, 5) for k, t in times.items() if k != "groups"}
        print("phase 15: %s on the %s plan, %s pinned: %.5f ms; per size "
              "%s; the group plan %.5f ms (%.2fx the pinned); launch floor "
              "%.5f ms; every variant within %g of the twin, reruns "
              "bitwise%s"
              % (name, "flat" if flat else "row", pin, times[pin], sizes,
                 times["groups"], times["groups"] / times[pin], floor_ms,
                 GEN_TOL, ", outputs bitwise the group plan's"
                 if flat else ""))
        if times[pin] > (1 + GEN_CLUSTER_SLACK) * times[best]:
            slow.append("%s: %s %.5f ms, %s %.5f ms"
                        % (name, pin, times[pin], best, times[best]))
        if flat and times[pin] > (1 + GEN_CLUSTER_SLACK) * times["groups"]:
            slow.append("%s: the flat plan %.5f ms, the group plan %.5f ms"
                        % (name, times[pin], times["groups"]))
        out[name] = times
    if slow:
        raise RuntimeError("codegen pins a plan or size more than %d %% "
                           "slower than another: %s"
                           % (100 * GEN_CLUSTER_SLACK, "; ".join(slow)))
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


# -- slice 13: bf16 mixed precision and the run-ahead window ------------------
# the products of each kernel on bf16 operands: (exact, with f32): q k^T
# and dO v^T are products of bf16 operands, exact in one bf16 tensor-core
# pass with f32 accumulation; p v, ds k, p^T dO and ds^T q take an f32
# operand (p or ds), exact as FLASH_BF16_PARTS bf16 parts against the bf16
# operand (the split of csrc/flash_bf16_wgmma.cu, which
# tests/test_torch_flash_bf16_wgmma.py holds to the contract) or as two
# TF32 parts, whichever the card does sooner
FLASH_BF16_PRODUCTS = {"flash_forward_with_lse": (1, 1), "flash_dq": (2, 1),
                       "flash_dkv": (2, 2)}
FLASH_BF16_PARTS = 2
# the bf16 designs (the bf16 wgmma design of the forward and
# dk/dv, csrc/flash_bf16_wgmma.cu, and the CUDA-core route of all three),
# and the edges of the wgmma one (key tiles of 64, query tiles of 32, own
# tiles of 128, D % 8 == 0 up to 32): T not a multiple of the tiles, Tq !=
# Tk both ways (dk/dv blocks with no query to visit), T = 1, D = 8, 24, 32
BF16_DESIGNS = ("wgmma_bf16", "bf16")
FLASH_BF16_WGMMA_EDGES = [(3, 997, 1000, 16, True), (2, 130, 70, 16, True),
                          (2, 70, 130, 16, True), (4, 1, 300, 16, False),
                          (2, 1, 1, 16, False), (2, 200, 200, 8, True),
                          (2, 97, 33, 24, True), (3, 997, 1000, 32, False),
                          (2, 64, 64, 32, True)]
# head dims both bf16 designs are timed at besides the path's 16 (the
# path's pairings with D replaced): the measurement behind flash_design's
# choice on bf16
FLASH_BF16_DIMS = (8, 24, 32)
# dq's key tile: another width may be this much faster than the shipped
# one before phase 17 fails
DQ_TILE_SLACK = 0.05


def _flash_bf16_bound(name, cases):
    """(bound ms, bound_by, simt ms, simt_by) of a bf16 design over
    ``cases``.  Bytes: q, k, v, dO and the outputs at 2 bytes, lse and
    delta at 4, each read or written once.  Operations
    (``FLASH_BF16_PRODUCTS``): the exact products in one bf16 pass at 989
    TFLOP/s; each product with p or ds as ``FLASH_BF16_PARTS`` bf16 passes
    at 989 TFLOP/s or two TF32 passes at 495, the cheaper (the bf16 parts,
    which meet the contract); one after the other on the tensor cores,
    beside the non-matrix f32 operations per visible pair
    (``FLASH_NONMATRIX``) at 67 TFLOP/s; the larger of the two is the
    bound.  ``simt``: the same bytes against the f32 CUDA-core operations
    of :func:`_flash_bound`, the bound of the CUDA-core route's own
    arithmetic (it widens to f32 on the CUDA cores)."""
    exact, mixed = FLASH_BF16_PRODUCTS[name]
    per_mixed = min(FLASH_BF16_PARTS / BF16_FLOPS_PER_S,
                    2 / TF32_FLOPS_PER_S)
    tensor_s = ops = nbytes = 0
    for bh, tq, tk, d, causal in cases:
        pairs = bh * _pairs(tq, tk, causal)
        tensor_s += pairs * 2 * d * (exact / BF16_FLOPS_PER_S
                                     + mixed * per_mixed)
        ops += pairs * FLASH_NONMATRIX[name]
        qside, kside, rows = bh * tq * d, bh * tk * d, bh * tq
        nbytes += {"flash_forward_with_lse": 2 * (2 * qside + 2 * kside)
                   + 4 * rows,
                   "flash_dq": 2 * (3 * qside + 2 * kside) + 8 * rows,
                   "flash_dkv": 2 * (2 * qside + 4 * kside) + 8 * rows}[name]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(tensor_s, ops / F32_FLOPS_PER_S) * 1e3
    simt_ms = _flash_bound(name, cases)[2] / F32_FLOPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations",
            max(bytes_ms, simt_ms),
            "bytes" if bytes_ms >= simt_ms else "operations")


def _flash_bf16_args(cases, gen):
    """Seeded bf16 (q, k, v, dO, lse, delta, causal, scale) per pairing,
    lse and delta (f32) from the bf16 plain forward."""
    from mxnet_tpu_torch.ops import pallas_kernels as pk
    out = []
    for case in cases:
        q, k, v, do, causal, scale = _flash_inputs(case, gen)
        q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
        o, lse = pk.flash_forward_with_lse_reference(q, k, v, causal, scale)
        out.append((q, k, v, do, lse, pk.flash_delta(o, do), causal, scale))
    return out


def _flash_bf16_plain(pk, a):
    """{wrapper: call} of the three bf16 plain versions on one pairing's
    args."""
    return {"flash_forward_with_lse": lambda: (
                pk.flash_forward_with_lse_reference(*a[:3], a[6], a[7])),
            "flash_dq": lambda: (pk.flash_dq_reference(*a),),
            "flash_dkv": lambda: pk.flash_dkv_reference(*a)}


def _flash_bf16_designs(pk, name, d):
    """The bf16 designs of wrapper ``name`` that take head dim ``d``."""
    return [x for x in BF16_DESIGNS if name in pk._FLASH_DESIGNS[x]
            and (x != "wgmma_bf16" or pk.wgmma_bf16_takes(d))]


def _flash_bf16_check(torch, pk, case, gen, worst):
    """Each bf16 design of the forward, dq and dk/dv that takes the head
    dim (routed to it or not) against the bf16 plain version at one
    pairing: one bf16 ulp, lse 1e-5, reruns bitwise, every launch counted
    on its design.  Returns {wrapper/design: worst ulps}."""
    (a,) = _flash_bf16_args([case], gen)
    want = {n: list(f()) for n, f in _flash_bf16_plain(pk, a).items()}
    errs = {}
    for name in FLASH_KERNELS:
        for design in _flash_bf16_designs(pk, name, case[3]):
            key = name + "/" + design
            call = _flash_call(name, design)
            before = pk.launch_counts()[key]
            runs = [call(a), call(a)]
            runs = [r if isinstance(r, tuple) else (r,) for r in runs]
            torch.cuda.synchronize()
            if pk.launch_counts()[key] != before + 2:
                raise RuntimeError("%s %s: not launched on the %s design"
                                   % (name, case, design))
            for got, again, w in zip(runs[0], runs[1], want[name]):
                if not torch.equal(got, again):
                    raise RuntimeError("%s %s %s: two runs differ"
                                       % (name, case, design))
                if got.dtype != w.dtype or got.shape != w.shape:
                    raise RuntimeError("%s %s %s: %s %s against %s %s"
                                       % (name, case, design, got.dtype,
                                          tuple(got.shape), w.dtype,
                                          tuple(w.shape)))
                if got.dtype == torch.float32:      # lse
                    torch.testing.assert_close(got, w, rtol=FLASH_FWD_TOL,
                                               atol=FLASH_FWD_TOL)
                    continue
                u = float(_bf16_ulps(got, w).max())
                e = float((got.float() - w.float()).abs().max())
                errs[key] = max(errs.get(key, 0.0), u)
                ulps, abs_err = worst.get(key, (0.0, 0.0))
                worst[key] = (max(ulps, u), max(abs_err, e))
                if u > 1.0:
                    raise RuntimeError("%s %s %s: %.2f bf16 ulps from "
                                       "plain" % (name, case, design, u))
    del a, want
    return errs


def _flash_bf16_hops(pk, args):
    """{(wrapper, design): [ms per pairing]} of every bf16 design of the
    three kernels over the pairings' args, the two designs of the forward
    and dk/dv timed in turns."""
    out = {}
    for name in FLASH_KERNELS:
        designs = tuple(_flash_bf16_designs(pk, name, args[0][0].shape[2]))
        if len(designs) == 2:
            hops = _design_hops(args, name, designs=designs)
        else:
            call = _flash_call(name, designs[0])
            hops = {designs[0]: [_event_ms(lambda a=a: call(a))
                                 for a in args]}
        out.update({(name, d): h for d, h in hops.items()})
    return out


def _flash_bf16_dim_sweep(torch, pk, gen, path_ms):
    """Both bf16 designs of the forward and dk/dv per layer at the path's
    pairings with each head dim of FLASH_BF16_DIMS (and the path's 16,
    ``path_ms``), beside flash_design's choice; fails where the chosen
    design is the slower one."""
    per_dim = {16: path_ms}
    for d in FLASH_BF16_DIMS:
        args = _flash_bf16_args([c[:3] + (d,) + c[4:] for c in FLASH_PATH],
                                gen)
        per_dim[d] = {key: sum(h) for key, h in
                      _flash_bf16_hops(pk, args).items()}
        del args
        torch.cuda.empty_cache()
    wrong = []
    for d in sorted(per_dim):
        ms = per_dim[d]
        names = [n for n in FLASH_KERNELS if (n, "wgmma_bf16") in ms]
        chosen = {n: pk.flash_design(d, n, dtype=torch.bfloat16)
                  for n in names}
        print("phase 17: head dim %d per layer: %s" % (d, ", ".join(
            "%s wgmma_bf16 %.5f / bf16 %.5f ms (%.2fx), flash_design %s"
            % (n, ms[(n, "wgmma_bf16")], ms[(n, "bf16")],
               ms[(n, "bf16")] / ms[(n, "wgmma_bf16")], chosen[n])
            for n in names)))
        for n in names:
            if ms[(n, chosen[n])] <= min(ms[(n, x)] for x in BF16_DESIGNS):
                continue
            # re-time the missed pair, both designs interleaved, before
            # failing (one timing outlier must not sink the run)
            args = _flash_bf16_args([c[:3] + (d,) + c[4:]
                                     for c in FLASH_PATH], gen)
            again = {x: sum(h) for x, h in _design_hops(
                args, n, designs=BF16_DESIGNS).items()}
            del args
            torch.cuda.empty_cache()
            print("phase 17: head dim %d %s missed (wgmma_bf16 %.5f / bf16 "
                  "%.5f ms); re-timed: wgmma_bf16 %.5f / bf16 %.5f ms, "
                  "flash_design %s"
                  % (d, n, ms[(n, "wgmma_bf16")], ms[(n, "bf16")],
                     again["wgmma_bf16"], again["bf16"], chosen[n]))
            if again[chosen[n]] > min(again.values()):
                wrong.append("%s at D = %d" % (n, d))
    if wrong:
        raise RuntimeError("flash_design chose the slower bf16 design for %s"
                           % ", ".join(wrong))


def _dq_tile_call(torch, pk, bt):
    """A call of dq's bf16 wgmma kernel on key tiles of ``bt`` rows on one
    pairing's args: the shipped width through ``_flash_dq`` (counted),
    another through its source built in phase 1 (uncounted)."""
    import ctypes
    from mxnet_tpu_torch.ops import build
    from mxnet_tpu_torch.tools import flash_ablate
    text, shipped = flash_ablate.dq_tile_source(bt)
    if bt == shipped:
        return _flash_call("flash_dq", "wgmma_bf16")
    entry = "mxtt_flash_dq_wgmma_bf16"
    fn = getattr(build.load_source(_dq_tile_name(bt), text), entry)
    fn.argtypes = pk._ARGTYPES[entry]
    fn.restype = ctypes.c_int

    def call(a):
        q, k, v, do, lse, delta, causal, scale = a
        dq = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (q, k, v, do, lse, delta, dq)),
                 q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                 float(scale), int(causal), stream)
        if err != 0:
            raise RuntimeError("dq key tile %d: cudaError %d" % (bt, err))
        return dq
    return call


def _flash_dq_tiles(torch, pk, args):
    """dq's bf16 wgmma kernel at each key tile of ``DQ_TILES`` at the
    path's pairings: one bf16 ulp of plain, reruns bitwise, then timed per
    layer in turns (each width, then in reverse, averaged); fails where
    the shipped width is more than ``DQ_TILE_SLACK`` slower than another.
    Returns {width: ms per layer}."""
    from mxnet_tpu_torch.tools import flash_ablate
    shipped = flash_ablate.dq_tile_source(flash_ablate.DQ_TILES[0])[1]
    calls = {bt: _dq_tile_call(torch, pk, bt)
             for bt in flash_ablate.DQ_TILES}
    for a in args:
        want = pk.flash_dq_reference(*a)
        for bt, call in calls.items():
            got, again = call(a), call(a)
            if not torch.equal(got, again):
                raise RuntimeError("dq key tile %d: two runs differ" % bt)
            u = float(_bf16_ulps(got, want).max())
            if u > 1.0:
                raise RuntimeError("dq key tile %d: %.2f bf16 ulps from "
                                   "plain" % (bt, u))
    runs = {bt: [] for bt in calls}
    for bt in list(calls) + list(calls)[::-1]:
        runs[bt].append(sum(_event_ms(lambda a=a: calls[bt](a))
                            for a in args))
    ms = {bt: sum(r) / len(r) for bt, r in runs.items()}
    print("phase 17: flash_dq wgmma_bf16 per layer at path by key tile: %s "
          "(shipped %d; each within one bf16 ulp of plain, reruns bitwise)"
          % (", ".join("%d keys %.5f ms" % kv for kv in ms.items()),
             shipped))
    if ms[shipped] > (1 + DQ_TILE_SLACK) * min(ms.values()):
        raise RuntimeError("dq's shipped key tile %d is slower than %s"
                           % (shipped, ms))
    return ms


def phase_flash_bf16():
    """Phase 17: the bf16 designs of B5-B7 against their bf16 plain
    versions; timed per layer beside the bound, plain and SDPA in bf16."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import pallas_kernels as pk

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = torch.Generator(device="cuda").manual_seed(17)
        worst = {}          # wrapper/design -> (ulps, abs)
        for case in FLASH_BF16_CHECK + FLASH_BF16_WGMMA_EDGES:
            errs = _flash_bf16_check(torch, pk, case, gen, worst)
            print("phase 17: %s within %s bf16 ulps of plain, lse %g, reruns "
                  "bitwise" % (case, {k: "%.2f" % v for k, v in errs.items()},
                               FLASH_FWD_TOL))
            torch.cuda.empty_cache()
        out = []
        path_ms = None
        for label, cases in (("path", FLASH_PATH),
                             ("D=64", FLASH_BF16_TIMED[:1]),
                             ("D=128", FLASH_BF16_TIMED[1:])):
            args = _flash_bf16_args(cases, gen)
            lib_in = [tuple(t[None].clone().requires_grad_() for t in a[:3])
                      + (a[3][None], a[6]) for a in args]
            with torch.no_grad():
                lib_fwd = _event_ms(lambda: [F.scaled_dot_product_attention(
                    *a[:3], is_causal=a[4]) for a in lib_in])
            outs = [F.scaled_dot_product_attention(*a[:3], is_causal=a[4])
                    for a in lib_in]
            lib_bwd = _event_ms(lambda: [torch.autograd.grad(
                o, a[:3], a[3], retain_graph=True)
                for o, a in zip(outs, lib_in)])
            backend = _sdpa_backend(*lib_in[0][:3], lib_in[0][4])
            hops = _flash_bf16_hops(pk, args)
            if label == "path":
                path_ms = {key: sum(h) for key, h in hops.items()}
                dq_tiles = _flash_dq_tiles(torch, pk, args)
                bwd = sum(path_ms[(n, pk.flash_design(
                    cases[0][3], n, dtype=torch.bfloat16))]
                    for n in ("flash_dq", "flash_dkv"))
                print("phase 17: B6 + B7 bf16 per layer at path on their "
                      "routed designs %.5f ms against SDPA bf16's backward "
                      "%.5f ms (%.2fx)" % (bwd, lib_bwd, bwd / lib_bwd))
            for name, (replaces, _) in FLASH_KERNELS.items():
                plains = [_flash_bf16_plain(pk, a)[name] for a in args]
                plain_ms = _event_ms(lambda: [c() for c in plains], iters=5)
                bound_ms, bound_by, simt_ms, simt_by = _flash_bf16_bound(
                    name, cases)
                lib = lib_fwd if name == "flash_forward_with_lse" else lib_bwd
                routed = pk.flash_design(cases[0][3], name,
                                         dtype=torch.bfloat16)
                for design in BF16_DESIGNS:
                    if (name, design) not in hops:
                        continue
                    ms = sum(hops[(name, design)])
                    print("phase 17: %s %s per layer at %s %s: %.5f ms (hops "
                          "%s)%s, tensor-core bound %.5f ms (%s) = %.1f %% of "
                          "it, f32 CUDA-core bound %.5f ms (%s) = %.1f %%, "
                          "plain %.5f ms, library %.5f ms (%s, %s)"
                          % (name, design, label, cases, ms,
                             ["%.5f" % x for x in hops[(name, design)]],
                             " [routed]" if design == routed else "",
                             bound_ms, bound_by, 100 * bound_ms / ms,
                             simt_ms, simt_by, 100 * simt_ms / ms, plain_ms,
                             lib, backend,
                             "its forward" if name == "flash_forward_with_lse"
                             else "its backward: B6+B7 together"))
                if label != "path":
                    continue
                ulps, abs_err = worst[name + "/" + routed]
                row = {"name": name + "[bf16]", "route": "cuda",
                       "source": "mxnet_tpu_torch/csrc/%s.cu"
                       % pk._FLASH_DESIGNS[routed][name][0],
                       "replaces": replaces, "design": routed,
                       "launches": None, "max_abs_err": abs_err,
                       "max_bf16_ulps": ulps,
                       "ms": sum(hops[(name, routed)]),
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "simt_bound_ms": simt_ms,
                       "library_ms": lib}
                if routed != "bf16":
                    row["cuda_core_ms"] = sum(hops[(name, "bf16")])
                    row["cuda_core_max_bf16_ulps"] = worst[name + "/bf16"][0]
                if name == "flash_dq":
                    row["key_tile_ms"] = dq_tiles
                out.append(row)
            del args, lib_in, outs
            torch.cuda.empty_cache()
        _flash_bf16_dim_sweep(torch, pk, gen, path_ms)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _resnet50(dtype="bf16"):
    """A fresh ResNet-50 v1 (Xavier, RandomState(0)) under a
    DataParallelTrainer of ``dtype`` with phase 5's SGD."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.parallel import DataParallelTrainer
    net = vision.resnet50_v1()
    net.initialize(initializer.Xavier(), rng=np.random.RandomState(0))
    return net, DataParallelTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                                    dict(SGD_PARAMS), dtype=dtype)


def _bn_half_check():
    """The half-precision BatchNorm of a bf16 training step on the card
    (moving statistics from the forward kernel's saved f32 mean and
    inverse std) against the same op on the CPU (statistics over the data
    widened to f32) and against the f32 spelling, on the same bf16 data:
    moving statistics within rtol 1e-4 / atol 1e-6 of the CPU's, the
    output within one bf16 ulp of the f32 spelling rounded once (the CPU
    kernel normalizes with statistics rounded to bf16, so its output is
    not the yardstick)."""
    import torch
    from mxnet_tpu_torch.ops import nn as N
    gen = torch.Generator().manual_seed(18)
    x = (torch.randn(64, 32, 14, 14, generator=gen) * 3 + 1).bfloat16()
    got = {}
    for dev in ("cpu", "cuda"):
        mm = torch.full((32,), 0.5, device=dev)
        mv = torch.ones(32, device=dev)
        g = torch.ones(32, dtype=torch.bfloat16, device=dev)
        out = N.BatchNorm(x.to(dev), g, torch.zeros_like(g), mm, mv,
                          eps=1e-5, momentum=0.9, fix_gamma=False,
                          _train=True)
        got[dev] = (out.cpu(), mm.cpu(), mv.cpu())
    x32 = x.double()
    mu = x32.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    want = ((x32 - mu) / torch.sqrt(var + 1e-5)).bfloat16()
    ulps = float(_bf16_ulps(got["cuda"][0], want).max())
    errs = [float((a - b).abs().max()) for a, b in zip(got["cuda"][1:],
                                                     got["cpu"][1:])]
    print("phase 18: half BatchNorm on the card: output within %.2f bf16 "
          "ulps of the f64 spelling; moving mean / var against the CPU's "
          "max |diff| %.3g / %.3g" % (ulps, *errs))
    if ulps > 1.0:
        raise RuntimeError("half BatchNorm output %.2f ulps off" % ulps)
    for a, b in zip(got["cuda"][1:], got["cpu"][1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def _multi_precision_check():
    """``Optimizer(multi_precision=True)`` over ``Parameter.cast(
    "bfloat16")`` weights on the card against the same on the CPU: 3
    SGD-momentum updates of a Dense layer from seeded bf16 gradients; the
    f32 masters and the rounded weights within rtol 1e-6."""
    import torch
    from mxnet_tpu_torch import gluon, initializer
    from mxnet_tpu_torch import optimizer as topt
    got = {}
    for dev in ("cpu", "cuda"):
        net = gluon.nn.Dense(64, in_units=32)
        net.initialize(initializer.Xavier(), ctx=dev,
                       rng=np.random.RandomState(3))
        net.cast("bfloat16")
        opt = topt.create("sgd", learning_rate=0.1, momentum=0.9, wd=1e-4,
                          multi_precision=True)
        params = [p.tensor() for p in net.collect_params().values()]
        states = [opt.create_state_multi_precision(i, w)
                  for i, w in enumerate(params)]
        rng = np.random.RandomState(4)
        for _ in range(3):
            for i, w in enumerate(params):
                g = torch.from_numpy(rng.randn(*w.shape).astype(np.float32))
                opt.update_multi_precision(i, w, g.to(dev).bfloat16(),
                                           states[i])
        if any(w.dtype != torch.bfloat16 or s[0].dtype != torch.float32
               for w, s in zip(params, states)):
            raise RuntimeError("multi_precision: weights %s, masters %s"
                               % ([w.dtype for w in params],
                                  [s[0].dtype for s in states]))
        got[dev] = [w.float().cpu() for w in params] + [s[0].cpu()
                                                         for s in states]
    same = all(torch.equal(a, b) for a, b in zip(got["cuda"], got["cpu"]))
    for a, b in zip(got["cuda"], got["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    print("phase 18: multi_precision SGD over bf16 (Parameter.cast) weights "
          "on the card: masters and weights %s the CPU's"
          % ("bitwise" if same else "within 1e-6 of"))


def _window_run(tr, x, y):
    """(losses, (images/s, p50 ms, p99 ms, peak GiB)) of ``WARMUP`` +
    ``TIMED`` steps of ``tr`` inside ``engine.bulk(4)``: the warm-up
    flushed, the timed steps' intervals as the host dispatched them, the
    rate over the flushed window."""
    import torch
    from mxnet_tpu_torch import engine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, marks = [], []
    with engine.bulk(4):
        for _ in range(WARMUP):
            losses.append(tr.step(x, y))
        tr.flush()
        t0 = time.perf_counter()
        for _ in range(TIMED):
            losses.append(tr.step(x, y))
            marks.append(time.perf_counter())
        tr.flush()
        t1 = time.perf_counter()
    gaps = np.diff([t0] + marks) * 1e3
    return [float(v) for v in losses], (
        x.shape[0] * TIMED / (t1 - t0), np.percentile(gaps, 50),
        np.percentile(gaps, 99),
        torch.cuda.max_memory_allocated() / 2 ** 30)


def phase_train_bf16():
    """Phase 18: ResNet-50 training in bf16 inside ``engine.bulk(4)``."""
    import gc
    import torch
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.ops import fused_optimizer as fo

    _bn_half_check()
    _multi_precision_check()

    batch = RUNS["phase 5"]["batch"]
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(batch, 3, 224, 224).astype(np.float32)
                         ).cuda()
    y = torch.from_numpy((rng.rand(batch) * 1000).astype(np.int64)).cuda()
    net, tr = _resnet50()
    steps = WARMUP + TIMED
    fo.reset_launch_counts()
    losses, timing = _window_run(tr, x, y)
    counts = fo.launch_counts()
    scale, good, skipped = tr.loss_scale_state()
    n_buckets = len(tr._groups)
    if counts["fused_sgd_momentum"] != steps * n_buckets:
        raise RuntimeError("fused_sgd_momentum launched %d times in the bf16 "
                           "run, want %d" % (counts["fused_sgd_momentum"],
                                             steps * n_buckets))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise RuntimeError("bf16 losses %r" % losses)
    if skipped or tr.dispatch_stats.snapshot()["inflight_max"] > 4:
        raise RuntimeError("bf16 run: %d skipped steps, ring %s" % (
            skipped, tr.dispatch_stats.snapshot()))
    print("phase 18: resnet50_v1 bf16 batch %d inside engine.bulk(4); "
          "losses %s" % (batch, ["%.4f" % v for v in losses]))
    print("phase 18: loss scale %.1f, good steps %d, skipped %d; "
          "fused_sgd_momentum launches %d (= %d steps x %d bucket); "
          "dispatch %s" % (scale, good, skipped,
                           counts["fused_sgd_momentum"], steps, n_buckets,
                           tr.dispatch_stats.snapshot()))
    launches = {"fused_sgd_momentum": counts["fused_sgd_momentum"]}

    # one step under sync debug "error", the batch already on the card
    # (the mode is off again before the window's flush synchronizes)
    torch.cuda.synchronize()
    with engine.bulk(4):
        torch.cuda.set_sync_debug_mode("error")
        try:
            tr.step(x, y)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    print("phase 18: one bf16 step under set_sync_debug_mode('error'): no "
          "synchronizing call")
    # the inf batch: masters and momentum bitwise untouched, one skip
    masters = [w.clone() for w in tr._w_flat] + [s.clone() for s in
                                                 tr._states]
    bad = x.clone()
    bad[0, 0, 0, 0] = float("inf")
    before = tr.loss_scale_state()
    tr.step(bad, y)
    tr.flush()
    after = tr.loss_scale_state()
    if not all(torch.equal(a, b) for a, b in
               zip(masters, list(tr._w_flat) + list(tr._states))):
        raise RuntimeError("the inf batch moved the masters")
    if after != (before[0] * 0.5, 0, before[2] + 1):
        raise RuntimeError("inf batch: loss-scale state %s -> %s"
                           % (before, after))
    print("phase 18: inf batch: masters and momentum bitwise untouched, "
          "loss-scale state %s -> %s" % (before, after))
    del tr, net, masters
    gc.collect()
    torch.cuda.empty_cache()
    # f32 in the same window, so the two rates differ only in dtype
    net, t32 = _resnet50(None)
    losses32, timing32 = _window_run(t32, x, y)
    if not losses32[-1] < losses32[0]:
        raise RuntimeError("f32 losses in the window %r" % losses32)
    f32 = RUNS["phase 5"]
    RUNS["phase 18"] = dict(batch=x.shape[0], images_s=timing[0],
                            p50=timing[1], p99=timing[2], peak_gib=timing[3])
    print("phase 18: %d timed steps each inside engine.bulk(4), flushed: "
          "bf16 %.1f images/s, step intervals p50 %.2f ms, p99 %.2f ms, "
          "peak memory %.2f GiB | f32 %.1f images/s, p50 %.2f ms, p99 %.2f "
          "ms, peak %.2f GiB | bf16 / f32 %.4f | phase 5 f32 (no window) "
          "in this call: %.1f images/s, p50 %.2f ms, p99 %.2f ms"
          % ((TIMED,) + tuple(timing) + tuple(timing32)
             + (timing[0] / timing32[0], f32["images_s"], f32["p50"],
                f32["p99"])))
    # the f32 step under sync debug, to name a synchronizing op if any
    with engine.bulk(4):
        torch.cuda.set_sync_debug_mode("error")
        try:
            t32.step(x, y)
            print("phase 18: one f32 step under set_sync_debug_mode("
                  "'error'): no synchronizing call")
        except RuntimeError as e:
            print("phase 18: the f32 step synchronizes: %s" % str(e)[:200])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    del t32, net
    gc.collect()
    torch.cuda.empty_cache()

    # bitwise: depth 1 and depth 4, 3 steps each on the same batch tensors,
    # deterministic cuDNN algorithms for both
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for depth in (1, 4):
            net, t = _resnet50()
            with engine.bulk(depth):
                ls = [t.step(x, y) for _ in range(3)]
                if len(t._inflight) > depth:
                    raise RuntimeError("ring %d > %d" % (len(t._inflight),
                                                         depth))
            runs.append(([float(v) for v in ls],
                         [w.clone() for w in t._w_flat]))
            del net, t
            gc.collect()
        same = runs[0][0] == runs[1][0] and all(
            torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
        print("phase 18: depth 1 vs depth 4 (cudnn.deterministic), 3 steps: "
              "losses %s / %s, masters bitwise %s"
              % (runs[0][0], runs[1][0], same))
        if not same:
            raise RuntimeError("run-ahead depth changed the numbers")
    finally:
        torch.backends.cudnn.deterministic = saved
    del runs, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_lm_bf16(profile=False):
    """Phase 19: the TransformerLM in bf16 on phase 8's batches."""
    import torch
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    from mxnet_tpu_torch.ops import pallas_kernels as pk
    from mxnet_tpu_torch.parallel import DataParallelTrainer, MeshPlan
    from mxnet_tpu_torch.transformer import TransformerLM, TransformerLMConfig

    k_ranks = 2
    steps = WARMUP + TIMED
    batches = [tuple(torch.from_numpy(a).cuda() for a in b)
               for b in _lm_batches(steps, TRAIN_LM_BATCH)]
    tr = DataParallelTrainer(
        TransformerLM(TransformerLMConfig(**CFG, attention="ring")), None,
        "sgd", dict(LM_SGD), mesh_plan=MeshPlan(sequence=k_ranks),
        dtype="bf16")
    torch.cuda.synchronize()
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
    flash = pk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = steps * CFG["n_layers"] * k_ranks
    d = CFG["d_model"] // CFG["n_heads"]
    routes = {n: pk.flash_design(d, n, dtype=torch.bfloat16)
              for n in FLASH_KERNELS}
    if routes != PATH_BF16_ROUTES or any(
            flash[n] != want or flash[n + "/" + routes[n]] != want
            for n in FLASH_KERNELS):
        raise RuntimeError("bf16 flash launches %s, want %d each on %s"
                           % (flash, want, PATH_BF16_ROUTES))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise RuntimeError("bf16 LM losses %r" % losses)
    f32 = RUNS["phase 8"]
    delta = max(abs(a - b) for a, b in zip(losses, f32["losses"]))
    timed = np.asarray(times[WARMUP:])
    tokens = TRAIN_LM_BATCH * CFG["seq_len"]
    print("phase 19: TransformerLM bf16 (compute_dtype), MeshPlan(sequence="
          "%d), batch %d x %d; losses %s" % (k_ranks, TRAIN_LM_BATCH,
                                             CFG["seq_len"],
                                             ["%.4f" % v for v in losses]))
    print("phase 19: %.1f tokens/s over %d timed steps (phase 8 f32 in this "
          "call: %.1f); step p50 %.2f ms, p99 %.2f ms; peak memory %.3f GiB; "
          "max |loss_bf16 - loss_f32| over %d steps %.5f"
          % (tokens * TIMED / (timed.sum() / 1e3), TIMED, f32["tokens_s"],
             np.percentile(timed, 50), np.percentile(timed, 99),
             peak / 2 ** 30, steps, delta))
    print("phase 19: launches %s = %d steps x %d layers x %d hops each on "
          "%s; fused_layer_norm %d (bf16 takes the plain spelling)"
          % ({k: v for k, v in flash.items() if k.startswith("flash")},
             steps, CFG["n_layers"], k_ranks, routes,
             fo.launch_counts()["fused_layer_norm"]))
    if profile:
        x, y = batches[-1]
        profile_train(tr, x, y, label="phase 19",
                      categories=LM_PROFILE_CATEGORIES,
                      split=LM_PROFILE_CATEGORIES[0][0])
    del tr, batches
    torch.cuda.empty_cache()
    return flash


def phase_benches():
    """Phase 20: ``engine_bench`` and ``precision_bench`` on the card."""
    import contextlib
    import io
    from mxnet_tpu_torch import engine_bench, precision_bench
    lines = {}
    for name, mod in (("engine_bench", engine_bench),
                      ("precision_bench", precision_bench)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main([])
        line = buf.getvalue().strip().splitlines()[-1]
        print("phase 20: %s %s" % (name, line))
        lines[name] = json.loads(line)
        if rc != 0:
            raise RuntimeError("%s exited %d" % (name, rc))
    eb, pb = lines["engine_bench"], lines["precision_bench"]
    if not 1 <= eb["overlap_inflight_max"] <= eb["dispatch_depth"] \
            or eb["overlap_prefetch_slots_max"] > 2:
        raise RuntimeError("engine_bench ring bounds: %s" % eb)
    if pb["precision_numerics_ok"] != 1.0:
        raise RuntimeError("precision_bench numerics: %s" % pb)
    return lines


# -- slice 16: the Gluon imperative training path ----------------------------
def _hand_counters():
    from mxnet_tpu_torch.ops import fused_optimizer, generated_kernels
    from mxnet_tpu_torch.ops import pallas_kernels
    return (fused_optimizer, pallas_kernels, generated_kernels)


def _hand_launches():
    """{counter: launches} of every B1-B10 wrapper that launched since the
    last reset (empty when none did)."""
    out = {}
    for m in _hand_counters():
        out.update({k: v for k, v in m.launch_counts().items() if v})
    return out


def _gluon_step(net, trainer, loss_fn, x, y, metrics=(), cast=False):
    """One step of the reference's loop; returns the per-sample losses.
    ``cast``: the logits of a half-precision net go to float32 before the
    loss, as the reference's bf16 recipe does."""
    from mxnet_tpu_torch import autograd, nd
    with autograd.record():
        out = net(x)
        if cast:
            out = out.astype("float32")
        loss = loss_fn(out, y)
    loss.backward()
    trainer.step(x.shape[0])
    if metrics:
        probs = nd.softmax(out)
        for m in metrics:
            m.update([y], [probs])
    return loss


def _gluon_net(arrays, device, dtype="float32", layout="NCHW"):
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.utils import from_jax_params
    net = from_jax_params(vision.resnet50_v1(layout=layout), arrays,
                          device=device)
    net.cast(dtype)
    return net


def _gluon_train(arrays, device, x, y, dtype="float32", steps=2,
                 layout="NCHW"):
    """``steps`` Gluon steps from ``arrays`` on ``device``: (net, trainer,
    losses, the parameters after the first step)."""
    from mxnet_tpu_torch import gluon, nd
    net = _gluon_net(arrays, device, dtype, layout)
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(GLUON_SGD),
                       kvstore="device")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    xs = nd.array(x, ctx=device, dtype=dtype)
    ys = nd.array(y, ctx=device)
    losses, first = [], None
    for _ in range(steps):
        losses.append(float(_gluon_step(net, tr, loss_fn, xs, ys).mean()
                            .asscalar()))
        if first is None:
            first = _rel_params(net)
    if not np.isfinite(losses).all():
        raise RuntimeError("non-finite Gluon loss on %s: %r" % (device,
                                                                losses))
    return net, tr, losses, first


def _rel_params(net):
    """{name relative to the block prefix: a float64 host copy} of every
    parameter and moving statistic."""
    from mxnet_tpu_torch.gluon.utils import relative_names
    ps = net.collect_params()
    return {rel: ps[n].tensor().detach().cpu().double()
            for rel, n in relative_names(list(ps.keys()), net.prefix).items()}


def _worst_diff(a, b):
    """(max |a - b| over the arrays of two ``_rel_params``, its name)."""
    return max((float((a[rel] - b[rel]).abs().max()), rel) for rel in a)


def _f32_ulp(v):
    """One float32 ulp at |v|: 2^(exponent - 24), normals only."""
    import torch
    _, e = torch.frexp(v.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v), e - 24)


def _worst_ulps(a, b, w0):
    """(max over every element of two ``_rel_params`` one step from
    ``w0`` of |a - b| in float32 ulps at max(|w0|, |a|), its name)."""
    import torch
    return max((float(((a[rel] - b[rel]).abs() / _f32_ulp(
        torch.maximum(w0[rel].abs(), a[rel].abs()))).max()), rel)
        for rel in a)


def phase_gluon_train():
    """Phase 21, the timed run: Gluon ResNet-50 through the imperative
    loop at phase 5's batch."""
    import gc
    import torch
    from mxnet_tpu_torch import context, gluon, initializer, metric, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision

    ctx = context.gpu()
    batch = RUNS["phase 5"]["batch"]
    rng = np.random.RandomState(21)
    while True:
        net = tr = x = y = None
        try:
            net = vision.resnet50_v1()
            net.initialize(initializer.Xavier(), rng=np.random.RandomState(0))
            tr = gluon.Trainer(net.collect_params(), "sgd", dict(GLUON_SGD),
                               kvstore="device")
            loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
            metrics = [metric.Accuracy(), metric.TopKAccuracy(5),
                       metric.CrossEntropy()]
            x = nd.array(rng.rand(batch, 3, 224, 224))
            y = nd.array(rng.randint(0, 1000, batch))
            if x.context.type != "cuda":
                raise RuntimeError("nd.array made %s, not the card"
                                   % x.context)
            torch.cuda.reset_peak_memory_stats()
            for m in _hand_counters():
                m.reset_launch_counts()
            losses, times = [], []
            for _ in range(GLUON_WARMUP + TIMED):
                t0 = time.perf_counter()
                loss = _gluon_step(net, tr, loss_fn, x, y, metrics)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss.mean().asscalar()))
            launched = _hand_launches()
            break
        except torch.cuda.OutOfMemoryError:
            if batch <= 8:
                raise
            del net, tr, x, y
            gc.collect()
            torch.cuda.empty_cache()
            batch //= 2
            print("phase 21: out of memory, batch halved to %d" % batch)
    peak = torch.cuda.max_memory_allocated()
    devices = {p.data().context.type for p in net.collect_params().values()}
    if devices != {"cuda"}:
        raise RuntimeError("parameters on %s, not the card" % devices)
    if launched:
        raise RuntimeError("the Gluon steps launched hand kernels: %s"
                           % launched)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise RuntimeError("Gluon loss not finite or not falling: %r"
                           % losses)
    timed = np.asarray(times[GLUON_WARMUP:])
    ips = batch * TIMED / (timed.sum() / 1e3)
    print("phase 21: Gluon resnet50_v1 batch %d on %s, losses %s"
          % (batch, ctx, ["%.4f" % v for v in losses]))
    print("phase 21: %.1f images/s over %d timed steps (phase 5's "
          "DataParallelTrainer: %.1f images/s, same call); step p50 %.2f "
          "ms, p99 %.2f ms; warm-up steps %s ms; peak memory %.2f GiB"
          % (ips, TIMED, RUNS["phase 5"]["images_s"],
             np.percentile(timed, 50), np.percentile(timed, 99),
             ["%.1f" % t for t in times[:GLUON_WARMUP]], peak / 2 ** 30))
    print("phase 21: metrics %s" % [m.get() for m in metrics])
    print("phase 21: B1-B10 launches during the Gluon steps: %s (none)"
          % launched)
    RUNS["phase 21"] = dict(batch=batch, images_s=ips,
                            p50=np.percentile(timed, 50),
                            p99=np.percentile(timed, 99),
                            peak_gib=peak / 2 ** 30)
    del net, tr, x, y
    gc.collect()
    torch.cuda.empty_cache()


def _arrays_of(net):
    return {n: p.tensor().detach().cpu().numpy().copy()
            for n, p in net.collect_params().items()}


def phase_gluon_parity():
    """Phase 21, parity and checkpoints at batch 2 x 224^2."""
    import tempfile
    import torch
    from mxnet_tpu_torch import autograd, gluon, initializer, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    from mxnet_tpu_torch.parallel import DataParallelTrainer

    net = vision.resnet50_v1()
    net.initialize(initializer.Xavier(), ctx="cpu",
                   rng=np.random.RandomState(1))
    with torch.no_grad():
        net(torch.zeros(1, 3, 224, 224))
    arrays = _arrays_of(net)
    rng = np.random.RandomState(2)
    x = rng.rand(2, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 1000, 2)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # cuDNN's deterministic algorithms: the two routes of (b) then take
    # the same gradients, and the checkpoints' reruns are bitwise
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    w0 = _rel_params(net)
    try:
        cpu64, _, l_cpu64, _ = _gluon_train(arrays, "cpu", x, y, "float64")
        gpu64, _, l_gpu64, _ = _gluon_train(arrays, None, x, y, "float64")
        _, _, l_cpu, cpu1 = _gluon_train(arrays, "cpu", x, y, steps=1)
        gpu, gtr, l_gpu, gpu1 = _gluon_train(arrays, None, x, y)
        # (b) one step of the fused route on the same weights and batch
        dnet = _gluon_net(arrays, None)
        dtr = DataParallelTrainer(dnet, gluon.loss.SoftmaxCrossEntropyLoss(),
                                  "sgd", dict(GLUON_SGD))
        fo.reset_launch_counts()
        l_dpt = float(dtr.step(x, y))
        b1 = fo.launch_counts()["fused_sgd_momentum"]
        d_64, at_64 = _worst_param_diff(cpu64, gpu64)
        d_gpu, at_gpu = _worst_diff(cpu1, gpu1)
        dpt1 = _rel_params(dnet)
        d_route, at_route = _worst_diff(gpu1, dpt1)
        u_route, uat_route = _worst_ulps(gpu1, dpt1, w0)
        ckpt = _gluon_checkpoints(gpu, gtr, x, y, tempfile, autograd, gluon,
                                  nd)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    dl_64 = max(abs(a - b) for a, b in zip(l_cpu64, l_gpu64))
    first = abs(l_cpu[0] - l_gpu[0])
    first_route = abs(l_gpu[0] - l_dpt)
    print("phase 21: (a) f64 losses cpu %s, cuda %s; max |dloss| %.3g, "
          "max |dparam| after 2 steps %.3g (%s) (tol %g)"
          % (["%.9f" % v for v in l_cpu64], ["%.9f" % v for v in l_gpu64],
             dl_64, d_64, at_64, GLUON_F64_TOL))
    print("phase 21: (a) f32 TF32 off: losses cpu %s, cuda %s; first-step "
          "loss %.3g (tol %g); after 1 step max |dparam| %.3g (%s), not held "
          "(a max-pool or ReLU choice that f32 rounding flips moves a whole "
          "gradient term)"
          % (["%.6f" % v for v in l_cpu], ["%.6f" % v for v in l_gpu],
             first, TRAIN_TOL, d_gpu, at_gpu))
    print("phase 21: (b) Gluon %.6f vs DataParallelTrainer %.6f (B1 "
          "launched %d times, %d bucket(s)); first-step loss %.3g (tol %g); "
          "after 1 step max %.3g f32 ulps (%s) (tol %g), max |dparam| %.3g "
          "(%s)"
          % (l_gpu[0], l_dpt, b1, len(dtr._groups), first_route,
             GLUON_ROUTE_LOSS_TOL, u_route, uat_route, GLUON_ROUTE_ULPS,
             d_route, at_route))
    print("phase 21: checkpoints: %s" % ckpt)
    if dl_64 > GLUON_F64_TOL or d_64 > GLUON_F64_TOL:
        raise RuntimeError("f64 Gluon card vs CPU: loss %.3g, params %.3g"
                           % (dl_64, d_64))
    if first > TRAIN_TOL:
        raise RuntimeError("f32 Gluon card vs CPU: first loss %.3g" % first)
    if b1 != len(dtr._groups):
        raise RuntimeError("B1 launched %d times in the fused route" % b1)
    if first_route > GLUON_ROUTE_LOSS_TOL or u_route > GLUON_ROUTE_ULPS:
        raise RuntimeError("Gluon vs DataParallelTrainer: loss %.3g, params "
                           "after 1 step %.3g ulps" % (first_route, u_route))


def _gluon_checkpoints(net, tr, x, y, tempfile, autograd, gluon, nd):
    """``save_parameters`` in both formats, reloaded on the card and
    written on the CPU; ``save_states`` -> ``load_states``, one more step
    each way (see the module docstring)."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    xs, ys = nd.array(x), nd.array(y)
    with autograd.predict_mode():
        logits = net(xs).asnumpy()
    cpu_net = _gluon_net(_arrays_of(net), "cpu")
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for fmt in ("mxtpu", "mxnet"):
            card, host = "%s/card.%s" % (d, fmt), "%s/cpu.%s" % (d, fmt)
            net.save_parameters(card, format=fmt)
            cpu_net.save_parameters(host, format=fmt)
            with open(card, "rb") as a, open(host, "rb") as b:
                same_bytes = a.read() == b.read()
            fresh = vision.resnet50_v1()
            fresh.load_parameters(card)
            with autograd.predict_mode():
                again = fresh(xs).asnumpy()
            bitwise = np.array_equal(again, logits)
            out[fmt] = dict(bytes_equal_cpu=same_bytes,
                            logits_bitwise=bitwise)
            if not (same_bytes and bitwise):
                raise RuntimeError("checkpoint %s: %s" % (fmt, out[fmt]))
        net.save_parameters(d + "/resume.params")
        tr.save_states(d + "/resume.states")
        resumed = vision.resnet50_v1()
        resumed.load_parameters(d + "/resume.params")
        rtr = gluon.Trainer(resumed.collect_params(), "sgd",
                            dict(GLUON_SGD), kvstore="device")
        rtr.load_states(d + "/resume.states")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    la = _gluon_step(net, tr, loss_fn, xs, ys).asnumpy()
    lb = _gluon_step(resumed, rtr, loss_fn, xs, ys).asnumpy()
    worst = max(float((a.tensor().detach() - b.tensor().detach()).abs()
                      .max())
                for a, b in zip(net.collect_params().values(),
                                resumed.collect_params().values()))
    out["resume"] = dict(loss_bitwise=bool(np.array_equal(la, lb)),
                         max_abs_param_diff=worst)
    if worst != 0.0 or not np.array_equal(la, lb):
        raise RuntimeError("save_states -> load_states then a step is not "
                           "bitwise the uninterrupted step: %s"
                           % out["resume"])
    return out


# -- slice 17: channels-last ResNet-50 and the vision model zoo --------------
# layout transposes and copies first, so cuDNN's nchwToNhwc / nhwcToNchw
# kernels are not counted as convolution
LAYOUT_PROFILE_CATEGORIES = (
    ("layout transposes", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("copies", ("copy",)),
) + PROFILE_CATEGORIES
NHWC_F64_TOL = 1e-8      # NHWC against NCHW on the card, float64, 1 step
# NHWC against NCHW on the card in float32: predict-mode logits, as a share
# of the largest; one step, each array as a share of the step's largest
# move, past STEP_ULPS ulps of the value
NHWC_F32_LOGIT_TOL = 1e-5
NHWC_F32_STEP_TOL = 0.1
STEP_ULPS = 2
ZOO_F64_TOL = 1e-9       # the zoo's logits, card against CPU, float64
ZOO_ITERS, ZOO_WARMUP = 3, 1     # benchmark_score's 20 / 5, cut for time
ZOO_SWEEP_ROUNDS, ZOO_SWEEP_S = 3, 0.3    # the resnet50_v1 layout sweep
ZOO_INIT_NAMES = ("vgg19_bn", "resnet152_v1", "densenet201")
ZOO_TRAIN_BATCH = 32
ZOO_SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
ZOO_FAMILIES = ("resnet18_v2", "vgg11_bn", "alexnet", "squeezenet1.1",
                "mobilenet1.0", "mobilenetv2_1.0", "densenet121",
                "inceptionv3")


def _gluon_timed(label, layout="NCHW", dtype="float32"):
    """Phase 21's loop (Gluon ``resnet50_v1(layout=...)``, 1000 classes,
    its SGD, the three metrics) at phase 5's batch (halved on
    out-of-memory), in ``dtype`` (bf16: ``net.cast`` and
    ``multi_precision=True``): GLUON_WARMUP + TIMED steps; the rates and
    the B1-B10 launches in them."""
    import gc
    import torch
    from mxnet_tpu_torch import gluon, initializer, metric, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision
    batch = RUNS["phase 5"]["batch"]
    rng = np.random.RandomState(21)
    half = dtype != "float32"
    while True:
        net = tr = x = y = None
        try:
            net = vision.resnet50_v1(layout=layout)
            net.initialize(initializer.Xavier(), rng=np.random.RandomState(0))
            net.cast(dtype)
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               dict(GLUON_SGD, multi_precision=half),
                               kvstore="device")
            loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
            metrics = [metric.Accuracy(), metric.TopKAccuracy(5),
                       metric.CrossEntropy()]
            shape = (batch, 3, 224, 224) if layout == "NCHW" \
                else (batch, 224, 224, 3)
            x = nd.array(rng.rand(*shape), dtype=dtype)
            y = nd.array(rng.randint(0, 1000, batch))
            torch.cuda.reset_peak_memory_stats()
            for m in _hand_counters():
                m.reset_launch_counts()
            losses, times = [], []
            for _ in range(GLUON_WARMUP + TIMED):
                t0 = time.perf_counter()
                loss = _gluon_step(net, tr, loss_fn, x, y, metrics,
                                   cast=half)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss.mean().asscalar()))
            launched = _hand_launches()
            break
        except torch.cuda.OutOfMemoryError:
            if batch <= 8:
                raise
            del net, tr, x, y
            gc.collect()
            torch.cuda.empty_cache()
            batch //= 2
            print("%s: out of memory, batch halved to %d" % (label, batch))
    peak = torch.cuda.max_memory_allocated()
    if launched:
        raise RuntimeError("%s launched hand kernels: %s" % (label, launched))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise RuntimeError("%s: loss not finite or not falling: %r"
                           % (label, losses))
    w = net.collect_params()[net.prefix + "conv2d0_weight"].tensor()
    if w.dim() != 4 or (layout == "NHWC" and w.shape[-1] != 3):
        raise RuntimeError("%s: first conv weight %s" % (label,
                                                         tuple(w.shape)))
    timed = np.asarray(times[GLUON_WARMUP:])
    out = dict(batch=batch, images_s=batch * TIMED / (timed.sum() / 1e3),
               p50=np.percentile(timed, 50), p99=np.percentile(timed, 99),
               peak_gib=peak / 2 ** 30, losses=losses)
    print("%s: Gluon resnet50_v1 %s %s batch %d, losses %s" % (
        label, layout, dtype, batch, ["%.4f" % v for v in losses]))
    del net, tr, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _print_rates(label, what, got, beside, beside_name):
    print("%s: %s %.1f images/s, step p50 %.2f ms, p99 %.2f ms, peak "
          "memory %.2f GiB | %s in this call: %.1f images/s, p50 %.2f ms, "
          "p99 %.2f ms, peak %.2f GiB | ratio %.4f"
          % (label, what, got["images_s"], got["p50"], got["p99"],
             got["peak_gib"], beside_name, beside["images_s"], beside["p50"],
             beside["p99"], beside["peak_gib"],
             got["images_s"] / beside["images_s"]))


def phase_nhwc_train(profile=False):
    """Phase 22, the timed runs: channels-last ResNet-50 through the Gluon
    loop in float32 and bf16, and through ``DataParallelTrainer(dtype=
    "bf16")`` inside ``engine.bulk(4)``; returns B1's launches there."""
    import gc
    import torch
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    from mxnet_tpu_torch.parallel import DataParallelTrainer

    f32 = _gluon_timed("phase 22 (a)", "NHWC")
    _print_rates("phase 22 (a)", "NHWC f32 Gluon", f32, RUNS["phase 21"],
                 "phase 21 NCHW f32")
    b16 = _gluon_timed("phase 22 (b)", "NHWC", "bfloat16")
    _print_rates("phase 22 (b)", "NHWC bf16 Gluon", b16, f32,
                 "(a) NHWC f32")
    print("phase 22 (a)-(b): B1-B10 launches during the Gluon steps: none")

    batch = RUNS["phase 18"]["batch"]
    rng = np.random.RandomState(0)
    xc = torch.from_numpy(rng.rand(batch, 3, 224, 224).astype(np.float32)
                          ).cuda()
    y = torch.from_numpy((rng.rand(batch) * 1000).astype(np.int64)).cuda()
    x = xc.permute(0, 2, 3, 1).contiguous()
    net = vision.resnet50_v1(layout="NHWC")
    net.initialize(initializer.Xavier(), rng=np.random.RandomState(0))
    tr = DataParallelTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                             dict(SGD_PARAMS), dtype="bf16")
    fo.reset_launch_counts()
    losses, timing = _window_run(tr, x, y)
    counts = fo.launch_counts()
    steps, n_buckets = WARMUP + TIMED, len(tr._groups)
    if counts["fused_sgd_momentum"] != steps * n_buckets:
        raise RuntimeError("fused_sgd_momentum launched %d times in the NHWC "
                           "bf16 run, want %d"
                           % (counts["fused_sgd_momentum"],
                              steps * n_buckets))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise RuntimeError("NHWC bf16 losses %r" % losses)
    scale, good, skipped = tr.loss_scale_state()
    got = dict(zip(("images_s", "p50", "p99", "peak_gib"), timing))
    print("phase 22 (c): DataParallelTrainer(dtype='bf16') NHWC batch %d "
          "inside engine.bulk(4); losses %s; loss scale %.1f, skipped %d; "
          "fused_sgd_momentum launches %d (= %d steps x %d bucket)"
          % (batch, ["%.4f" % v for v in losses], scale, skipped,
             counts["fused_sgd_momentum"], steps, n_buckets))
    _print_rates("phase 22 (c)", "NHWC bf16 DataParallelTrainer", got,
                 RUNS["phase 18"], "phase 18 NCHW bf16")
    RUNS["phase 22"] = dict(f32=f32, bf16=b16, dpt=got)
    if profile:
        profile_train(tr, x, y, label="phase 22 (c) NHWC bf16",
                      categories=LAYOUT_PROFILE_CATEGORIES,
                      split=("layout transposes", "copies"))
        del tr, net
        gc.collect()
        net, t18 = _resnet50()
        profile_train(t18, xc, y, label="phase 18 recipe NCHW bf16",
                      categories=LAYOUT_PROFILE_CATEGORIES,
                      split=("layout transposes", "copies"))
        del t18
    else:
        del tr
    del net, x, xc, y
    gc.collect()
    torch.cuda.empty_cache()
    return counts["fused_sgd_momentum"]


def _predict(net, x, device, dtype="float64"):
    """Predict-mode logits of ``net`` on ``x`` in ``dtype`` (numpy)."""
    from mxnet_tpu_torch import autograd, nd
    with autograd.predict_mode():
        return net(nd.array(x, ctx=device, dtype=dtype)).asnumpy()


def _conv_formats():
    """{dtype: the memory format of a cuDNN convolution's output} for a
    channels-last input and weight on the card, as the NHWC layers hand
    them to ``F.conv2d``."""
    import torch
    import torch.nn.functional as TF
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = torch.randn(2, 64, 56, 56, device="cuda", generator=gen)
    w = torch.randn(64, 64, 3, 3, device="cuda", generator=gen)
    out = {}
    for dt in (torch.float32, torch.float64):
        y = TF.conv2d(x.to(dt).movedim(1, -1).contiguous().movedim(-1, 1),
                      w.to(dt).movedim(1, -1).contiguous().movedim(-1, 1),
                      padding=1)
        out[str(dt).split(".")[1]] = (
            "channels_last" if y.is_contiguous(
                memory_format=torch.channels_last)
            else "contiguous" if y.is_contiguous() else "strided")
    return out


def _moved(params):
    """``_rel_params`` of an NHWC net with its 4-D arrays moved to OIHW."""
    return {r: v.movedim(-1, 1) if v.dim() == 4 else v
            for r, v in params.items()}


def phase_nhwc_parity():
    """Phase 22, parity and checkpoints at batch 2 x 224^2."""
    import tempfile
    import torch
    from mxnet_tpu_torch import autograd, initializer, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.resnet50_v1()
    net.initialize(initializer.Xavier(), ctx="cpu",
                   rng=np.random.RandomState(1))
    with torch.no_grad():
        net(torch.zeros(1, 3, 224, 224))
    arrays = _arrays_of(net)
    nhwc = {n: np.ascontiguousarray(np.moveaxis(a, 1, -1))
            if a.ndim == 4 else a for n, a in arrays.items()}
    rng = np.random.RandomState(2)
    x = rng.rand(2, 3, 224, 224).astype(np.float32)
    xl = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    y = rng.randint(0, 1000, 2)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        # NHWC against NCHW on the card: float64 logits, one step
        lg_l = _predict(_gluon_net(nhwc, None, "float64", "NHWC"), xl, None)
        lg_c = _predict(_gluon_net(arrays, None, "float64"), x, None)
        lf_l = _predict(_gluon_net(nhwc, None, "float32", "NHWC"), xl, None,
                        "float32")
        lf_c = _predict(_gluon_net(arrays, None, "float32"), x, None,
                        "float32")
        _, _, l64l, p64l = _gluon_train(nhwc, None, xl, y, "float64", 1,
                                        "NHWC")
        _, _, l64c, p64c = _gluon_train(arrays, None, x, y, "float64", 1)
        _, _, l32l, p32l = _gluon_train(nhwc, None, xl, y, steps=1,
                                        layout="NHWC")
        _, _, l32c, p32c = _gluon_train(arrays, None, x, y, steps=1)
        w0 = _rel_params(_gluon_net(arrays, "cpu"))
        # NHWC card against NHWC CPU, float64, two steps
        gpu64, gtr, lg64, _ = _gluon_train(nhwc, None, xl, y, "float64",
                                           layout="NHWC")
        cpu64, _, lc64, _ = _gluon_train(nhwc, "cpu", xl, y, "float64",
                                         layout="NHWC")
        ckpt = _nhwc_checkpoints(nhwc, xl, y, tempfile)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    d_logits = float(np.abs(lg_l - lg_c).max())
    scale = float(np.abs(lg_c).max())
    d_step64, at64 = _worst_diff(_moved(p64l), p64c)
    d_lf = float(np.abs(lf_l - lf_c).max()) / float(np.abs(lf_c).max())
    moved = max(float((p32c[r] - w0[r]).abs().max()) for r in p32c)
    step32 = {r: float(((v - p32c[r]).abs() - STEP_ULPS * _f32_ulp(
        p32c[r])).max()) / moved for r, v in _moved(p32l).items()}
    d32, at32 = max((v, r) for r, v in step32.items())
    # each layout's float32 step against the float64 one (the two layouts'
    # float64 steps are bitwise equal): what float32 resolves per array
    to64 = {lay: max((float((v - p64c[r]).abs().max()) / moved, r)
                     for r, v in p.items())
            for lay, p in (("NCHW", p32c), ("NHWC", _moved(p32l)))}
    formats = _conv_formats()
    dl64 = max(abs(a - b) for a, b in zip(lg64, lc64))
    dp64, atp64 = _worst_param_diff(cpu64, gpu64)
    print("phase 22: a cuDNN convolution of channels-last data returns %s "
          "(float32 holds the channels-last kernels; float64 runs NCHW "
          "kernels whatever the layout, so its NHWC checks hold the layers' "
          "view and weight handling, not those kernels)" % formats)
    print("phase 22: NHWC vs NCHW on the card, float64 logits max |diff| "
          "%.3g (tol %g x %.3g); one float64 step: loss %.12f vs %.12f, max "
          "|dparam| %.3g (%s) (tol %g)"
          % (d_logits, NHWC_F64_TOL, scale, l64l[0], l64c[0], d_step64,
             at64, NHWC_F64_TOL))
    print("phase 22: NHWC vs NCHW on the card, float32 TF32 off: logits max "
          "|diff| %.3g of the largest (tol %g); one step: loss %.7f vs %.7f "
          "(tol %g); every array within %.3g of the step's largest move "
          "(%.3g), past %d ulps, worst at %s (tol %g; %d of %d arrays past "
          "1e-3); against the float64 step, NCHW float32 %.3g at %s, NHWC "
          "float32 %.3g at %s" % (
              d_lf, NHWC_F32_LOGIT_TOL, l32l[0], l32c[0], TRAIN_TOL, d32,
              moved, STEP_ULPS, at32, NHWC_F32_STEP_TOL,
              sum(v > 1e-3 for v in step32.values()), len(step32),
              to64["NCHW"][0], to64["NCHW"][1], to64["NHWC"][0],
              to64["NHWC"][1]))
    print("phase 22: NHWC card vs NHWC CPU, float64, two steps: losses %s / "
          "%s, max |dloss| %.3g, max |dparam| %.3g (%s) (tol %g)"
          % (["%.9f" % v for v in lg64], ["%.9f" % v for v in lc64], dl64,
             dp64, atp64, GLUON_F64_TOL))
    print("phase 22: NHWC checkpoints: %s" % ckpt)
    if d_logits > NHWC_F64_TOL * scale or d_step64 > NHWC_F64_TOL \
            or abs(l64l[0] - l64c[0]) > NHWC_F64_TOL:
        raise RuntimeError("NHWC vs NCHW float64: logits %.3g, params %.3g"
                           % (d_logits, d_step64))
    if formats["float32"] != "channels_last":
        raise RuntimeError("float32 NHWC convolution not channels-last: %s"
                           % formats)
    if abs(l32l[0] - l32c[0]) > TRAIN_TOL or d_lf > NHWC_F32_LOGIT_TOL \
            or d32 > NHWC_F32_STEP_TOL:
        raise RuntimeError("NHWC vs NCHW float32: loss %.3g, logits %.3g, "
                           "step %.3g at %s" % (abs(l32l[0] - l32c[0]), d_lf,
                                                d32, at32))
    if dl64 > GLUON_F64_TOL or dp64 > GLUON_F64_TOL:
        raise RuntimeError("NHWC card vs CPU float64: loss %.3g, params %.3g"
                           % (dl64, dp64))


def _nhwc_checkpoints(nhwc, xl, y, tempfile):
    """An NHWC net's ``.params`` written on the card, in both formats:
    byte-identical to the CPU's file of the same values, and reloaded
    into a fresh NHWC net on the card to bitwise logits."""
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision
    card = _gluon_net(nhwc, None, layout="NHWC")
    host = _gluon_net(nhwc, "cpu", layout="NHWC")
    xs = nd.array(xl)
    with autograd.predict_mode():
        logits = card(xs).asnumpy()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for fmt in ("mxtpu", "mxnet"):
            a, b = "%s/card.%s" % (d, fmt), "%s/cpu.%s" % (d, fmt)
            card.save_parameters(a, format=fmt)
            host.save_parameters(b, format=fmt)
            with open(a, "rb") as fa, open(b, "rb") as fb:
                same = fa.read() == fb.read()
            fresh = vision.resnet50_v1(layout="NHWC")
            fresh.load_parameters(a)
            with autograd.predict_mode():
                again = fresh(xs).asnumpy()
            out[fmt] = dict(bytes_equal_cpu=same,
                            logits_bitwise=bool(np.array_equal(again,
                                                               logits)))
            if not all(out[fmt].values()):
                raise RuntimeError("NHWC checkpoint %s: %s" % (fmt,
                                                               out[fmt]))
    return out


def _zoo_side(name):
    return 299 if name == "inceptionv3" else 224


def _zoo_net(name, seed, device=None, init=None, rng=None):
    """``get_model(name)`` (1000 classes), ``init`` (Xavier) drawn from
    ``rng`` (a seeded generator on ``device``), shapes resolved by one
    predict-mode forward at batch 1."""
    import torch
    from mxnet_tpu_torch import autograd, initializer, nd
    from mxnet_tpu_torch.base import resolve_device
    from mxnet_tpu_torch.gluon.model_zoo import vision
    dev = resolve_device(device)
    net = vision.get_model(name)
    net.initialize(init or initializer.Xavier(), ctx=dev,
                   rng=rng or torch.Generator(device=dev).manual_seed(seed))
    side = _zoo_side(name)
    with autograd.predict_mode():
        net(nd.zeros((1, 3, side, side), ctx=dev))
    return net


def _zoo_train(name):
    """Two Gluon SGD+momentum steps at batch 32 on the card: (losses,
    parameters with grad_req != null whose gradient is all zeros)."""
    import torch
    from mxnet_tpu_torch import gluon, nd
    net = _zoo_net(name, 3)
    side = _zoo_side(name)
    rng = np.random.RandomState(23)
    x = nd.array(rng.rand(ZOO_TRAIN_BATCH, 3, side, side))
    y = nd.array(rng.randint(0, 1000, ZOO_TRAIN_BATCH))
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(ZOO_SGD),
                       kvstore="device")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = [float(_gluon_step(net, tr, loss_fn, x, y).mean().asscalar())
              for _ in range(2)]
    zero = [n for n, p in net.collect_params().items()
            if p.grad_req != "null"
            and not bool((p.tensor().grad != 0).any())]
    torch.cuda.synchronize()
    return losses, zero


def _zoo_pretrained(name):
    """``get_model(name, pretrained=True, root=...)`` from a plain
    ``{name}.params`` and from a ``file://`` repo with a registered SHA-1;
    both give logits bitwise those of the net that wrote the file."""
    import hashlib
    import os
    import shutil
    import tempfile
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.gluon.model_zoo import model_store, vision
    net = _zoo_net(name, 4)
    side = _zoo_side(name)
    x = nd.array(np.random.RandomState(5).rand(2, 3, side, side))
    with autograd.predict_mode():
        want = net(x).asnumpy()
    out = {}
    old_repo = os.environ.get("MXNET_GLUON_REPO")
    with tempfile.TemporaryDirectory() as d:
        net.save_parameters(os.path.join(d, name + ".params"))
        with open(os.path.join(d, name + ".params"), "rb") as f:
            sha1 = hashlib.sha1(f.read()).hexdigest()
        model_store.register_model_sha1(name, sha1)
        try:
            repo = os.path.join(d, "repo", "gluon", "models")
            os.makedirs(repo)
            fname = "%s-%s.params" % (name, model_store.short_hash(name))
            shutil.copy(os.path.join(d, name + ".params"),
                        os.path.join(repo, fname))
            os.environ["MXNET_GLUON_REPO"] = "file://%s/repo/" % d
            for how, root in (("plain file", d),
                              ("file:// repo", os.path.join(d, "cache"))):
                again = vision.get_model(name, pretrained=True, root=root)
                with autograd.predict_mode():
                    got = again(x).asnumpy()
                out[how] = bool(np.array_equal(got, want))
            out["cached copy"] = os.path.exists(os.path.join(d, "cache",
                                                             fname))
        finally:
            model_store._model_sha1.pop(name, None)
            if old_repo is None:
                os.environ.pop("MXNET_GLUON_REPO", None)
            else:
                os.environ["MXNET_GLUON_REPO"] = old_repo
    if not all(out.values()):
        raise RuntimeError("pretrained %s: %s" % (name, out))
    return out


def _zoo_sweep(bs):
    """resnet50_v1 through ``benchmark_score`` in both layouts at batch
    1-32: {layout: {batch: [images/s per round]}}, printed with each
    layout's median and range."""
    import gc
    import torch
    out = {"NCHW": {}, "NHWC": {}}
    for b in (1, 2, 4, 8, 16, 32):
        nets = {lay: bs.setup("resnet50_v1", b, (3, 224, 224), layout=lay)
                for lay in out}
        iters = {}
        for lay, (net, x) in nets.items():
            once = b / bs.rate(net, x, iters=3, warmup=2)
            iters[lay] = max(5, int(ZOO_SWEEP_S / once))
            out[lay][b] = []
        for r in range(ZOO_SWEEP_ROUNDS):
            for lay in (("NCHW", "NHWC") if r % 2 == 0 else
                        ("NHWC", "NCHW")):
                out[lay][b].append(bs.rate(*nets[lay], iters=iters[lay],
                                           warmup=1))
        med = {lay: float(np.median(out[lay][b])) for lay in out}
        apart = (min(out["NHWC"][b]) > max(out["NCHW"][b])
                 or max(out["NHWC"][b]) < min(out["NCHW"][b]))
        print("phase 23: benchmark_score resnet50_v1 batch %2d, %d rounds of "
              "~%.2f s (%d / %d forwards): NCHW median %.1f [%.1f-%.1f], "
              "NHWC median %.1f [%.1f-%.1f] images/s, NHWC/NCHW %.4f, ranges "
              "%s" % (b, ZOO_SWEEP_ROUNDS, ZOO_SWEEP_S, iters["NCHW"],
                      iters["NHWC"], med["NCHW"], min(out["NCHW"][b]),
                      max(out["NCHW"][b]), med["NHWC"], min(out["NHWC"][b]),
                      max(out["NHWC"][b]), med["NHWC"] / med["NCHW"],
                      "apart" if apart else "overlap"))
        del nets
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _zoo_init_seconds():
    """{name: (parameters, s drawn on the card from a torch.Generator, s
    drawn on the host from a RandomState)}, each through ``_zoo_net`` (the
    init and the first forward that resolves the shapes), synchronized."""
    import gc
    import torch
    out = {}
    for name in ZOO_INIT_NAMES:
        secs = []
        for rng in (None, np.random.RandomState(0)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net = _zoo_net(name, 0, rng=rng)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            count = sum(p.tensor().numel()
                        for p in net.collect_params().values())
            del net
            gc.collect()
        out[name] = (count, secs[0], secs[1])
        print("phase 23: %s (%d parameters) initialized to its first "
              "forward: %.3f s drawn on the card (torch.Generator), %.3f s "
              "drawn on the host (RandomState) and copied"
              % (name, count, secs[0], secs[1]))
    torch.cuda.empty_cache()
    return out


def phase_zoo():
    """Phase 23: every zoo name through ``benchmark_score.score`` on the
    card, one net per family trained two steps, held against the CPU in
    float64 and loaded through ``pretrained=True``; no B1-B10 launch."""
    import gc
    import torch
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.utils import from_jax_params
    from mxnet_tpu_torch.tools import benchmark_score as bs

    for m in _hand_counters():
        m.reset_launch_counts()
    t0 = time.perf_counter()
    rates, drawn = {}, 0
    for name in sorted(vision._MODELS):
        side = _zoo_side(name)
        rates[name] = []
        for b in (1, 32):
            net, x = bs.setup(name, b, (3, side, side))
            rates[name].append(bs.rate(net, x, ZOO_ITERS, ZOO_WARMUP))
            drawn += sum(p.tensor().numel()
                         for p in net.collect_params().values())
            del net, x
        print("phase 23: benchmark_score %-17s %dx%d: batch 1 %9.1f "
              "images/s, batch 32 %9.1f images/s"
              % (name, side, side, rates[name][0], rates[name][1]))
        gc.collect()
        torch.cuda.empty_cache()
    print("phase 23: %d names scored (%d timed forwards after %d warm-up "
          "each, the tool's 20 / 5 cut for time; smoke readings, spread not "
          "measured) in %.1f s, %d parameters initialized"
          % (len(rates), ZOO_ITERS, ZOO_WARMUP, time.perf_counter() - t0,
             drawn))
    RUNS["phase 23 sweep"] = _zoo_sweep(bs)
    RUNS["phase 23 init"] = _zoo_init_seconds()
    for name in ZOO_FAMILIES:
        losses, zero = _zoo_train(name)
        print("phase 23: %s two Gluon steps at batch %d: losses %s, "
              "parameters with an all-zero gradient: %s"
              % (name, ZOO_TRAIN_BATCH, ["%.4f" % v for v in losses], zero))
        if not np.isfinite(losses).all() or zero:
            raise RuntimeError("%s training: losses %s, zero gradients %s"
                               % (name, losses, zero))
        gc.collect()
        torch.cuda.empty_cache()
    he = initializer.Xavier(rnd_type="gaussian", factor_type="in",
                            magnitude=2)
    for name in ZOO_FAMILIES:
        net = _zoo_net(name, 6, init=he)
        arrays = _arrays_of(net)
        side = _zoo_side(name)
        x = np.random.RandomState(7).rand(2, 3, side, side)
        got = {}
        for dev in (None, "cpu"):
            n64 = from_jax_params(vision.get_model(name), arrays, device=dev
                                  or "cuda")
            n64.cast("float64")
            got[dev] = _predict(n64, x, dev)
        diff = float(np.abs(got[None] - got["cpu"]).max())
        scale = float(np.abs(got["cpu"]).max())
        print("phase 23: %s card vs CPU, float64 logits at batch 2: max "
              "|diff| %.3g (tol %g x the largest |logit|, %.3g)"
              % (name, diff, ZOO_F64_TOL, scale))
        if not diff <= ZOO_F64_TOL * scale:
            raise RuntimeError("%s card vs CPU float64 logits %.3g"
                               % (name, diff))
        del net
        gc.collect()
        torch.cuda.empty_cache()
    for name in ("squeezenet1.1", "resnet50_v2"):
        print("phase 23: %s pretrained=True, logits bitwise the saving "
              "net's: %s" % (name, _zoo_pretrained(name)))
    launched = _hand_launches()
    print("phase 23: B1-B10 launches over the phase: %s (none)" % launched)
    if launched:
        raise RuntimeError("the zoo launched hand kernels: %s" % launched)
    RUNS["phase 23"] = rates


# -- slice 18: the op set, the seeded RNG and every optimizer ---------------
OP_DRAWS = 1 << 24
# label -> (registered name, optimizer parameters) of phase 25
OPT25 = {
    "sgd": ("sgd", GLUON_SGD),
    "adam": ("adam", {"learning_rate": 1e-3, "wd": 1e-4}),
    "signum": ("signum", {"learning_rate": 1e-4, "momentum": 0.9}),
    "ftml": ("ftml", {"learning_rate": 1e-3}),
    "lbsgd": ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9}),
    "dcasgd": ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9}),
    "nag": ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    "sgld": ("sgld", {"learning_rate": 1e-5}),
    "adagrad": ("adagrad", {"learning_rate": 0.01}),
    "rmsprop": ("rmsprop", {"learning_rate": 1e-3}),
    "rmsprop_centered": ("rmsprop", {"learning_rate": 1e-3,
                                     "centered": True}),
    "adadelta": ("adadelta", {}),
    "ftrl": ("ftrl", {"learning_rate": 0.1}),
    "adamax": ("adamax", {}),
    "nadam": ("nadam", {"learning_rate": 1e-3}),
    "test": ("test", {}),
}
OPT25_WARMUP, OPT25_TIMED = 1, 2
OPT25_DPT_STEPS = 2
# the reference's elementwise set, which DataParallelTrainer takes
OPT25_ELEMENTWISE = ("sgd", "nag", "signum", "ftml", "sgld", "adam",
                     "adagrad", "rmsprop", "rmsprop_centered", "adadelta",
                     "ftrl", "adamax", "nadam")
OPT25_F64_TOL = 1e-12
DROPOUT_BATCH = 64


def phase_ops():
    """Phase 24: every new op on the card against the CPU, the samplers
    against their laws, the seed checks."""
    import torch
    from mxnet_tpu_torch.tools import op_cases
    t0 = time.monotonic()
    worst, cases = {}, {}
    for case in op_cases.CASES:
        err, arrays = op_cases.run_case(case, "cuda")
        worst[case.file] = max(worst.get(case.file, 0.0), err)
        cases.setdefault(case.file, set()).add(case.name)
    t_ops = time.monotonic() - t0
    names = op_cases.held_names({c.name for c in op_cases.CASES})
    for f in sorted(worst):
        held = op_cases.held_names(cases[f])
        print("phase 24: ops/%s.py: %d ops held card vs CPU (%s), worst "
              "error %.3g of the largest magnitude" % (
                  f, len(held), ", ".join(held), worst[f]))
    print("phase 24: %d op names held forward and backward through "
          "check_consistency([cuda, cpu]) in %.1f s (limit: index outputs "
          "exact, floats %.0e)" % (len(names), t_ops, op_cases.REL_TOL))
    t0 = time.monotonic()
    rows = op_cases.sampler_checks("cuda", OP_DRAWS)
    for r in rows:
        print("phase 24: sampler %s" % json.dumps(r))
    seeds = op_cases.seed_checks("cuda")
    ms = op_cases.draw_ms("cuda", OP_DRAWS)
    print("phase 24: %d samplers held to their laws at %d draws each on "
          "the card in %.1f s; seeds %s; ms per 2^24 draws: uniform %.5f, "
          "normal %.5f" % (len(rows), OP_DRAWS, time.monotonic() - t0,
                           seeds, ms["uniform"], ms["normal"]))
    RUNS["phase 24"] = dict(ops=len(names), samplers=len(rows), ms=ms)
    torch.cuda.empty_cache()


def _snapshot(net):
    return {n: p.tensor().detach().clone()
            for n, p in net.collect_params().items()}


def _restore(net, snap):
    import torch
    with torch.no_grad():
        for n, p in net.collect_params().items():
            p.tensor().copy_(snap[n])


def _opt25_gluon(net, snap, label, x, y, batch):
    """(a): one optimizer's Gluon steps from the snapshot; returns the
    row it prints."""
    import torch
    from mxnet_tpu_torch import autograd, gluon
    name, params = OPT25[label]
    _restore(net, snap)
    tr = gluon.Trainer(net.collect_params(), name, dict(params),
                       kvstore="device")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in _hand_counters():
        m.reset_launch_counts()
    losses, times, update_ms = [], [], []
    for _ in range(OPT25_WARMUP + OPT25_TIMED):
        t0 = time.perf_counter()
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        tr.step(batch)
        e1.record()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        update_ms.append(e0.elapsed_time(e1))
        losses.append(float(loss.mean().asscalar()))
    launched = _hand_launches()
    # a zero-initialized parameter (BatchNorm's beta) may stay at zero
    # under LBSGD, whose LARS scale is its norm, and under Ftrl, whose L1
    # term holds it while |z| <= lamda1: the rules' own, as the reference's
    still = [n for n, p in net.collect_params().items()
             if p.grad_req != "null" and torch.equal(p.tensor(), snap[n])
             and not (name in ("lbsgd", "ftrl") and not bool(snap[n].any()))]
    if not np.isfinite(losses).all() or still or launched:
        raise RuntimeError("phase 25 (a) %s: losses %r, parameters that did "
                           "not move %s, hand-kernel launches %s"
                           % (label, losses, still[:5], launched))
    timed = np.asarray(times[OPT25_WARMUP:])
    return dict(optimizer=label, images_s=batch * OPT25_TIMED
                / (timed.sum() / 1e3),
                update_ms=float(np.mean(update_ms[OPT25_WARMUP:])),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                losses=[round(v, 5) for v in losses])


def _opt25_dpt(net, snap, label, x, y, depth=1, seed=None):
    """(b): one optimizer through DataParallelTrainer from the snapshot:
    (losses, the hand-kernel launches, the parameters after)."""
    import torch
    from mxnet_tpu_torch import engine, gluon
    from mxnet_tpu_torch import random as mxr
    from mxnet_tpu_torch.parallel import DataParallelTrainer
    name, params = OPT25[label]
    _restore(net, snap)
    if seed is not None:
        mxr.seed(seed)
    tr = DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                             name, dict(params))
    for m in _hand_counters():
        m.reset_launch_counts()
    with engine.bulk(depth):
        losses = [tr.step(x, y) for _ in range(OPT25_DPT_STEPS)]
    losses = [float(v) for v in losses]
    launched = _hand_launches()
    if not np.isfinite(losses).all():
        raise RuntimeError("phase 25 (b) %s: losses %r" % (label, losses))
    return losses, launched, len(tr._groups), {
        n: p.tensor().detach().clone()
        for n, p in net.collect_params().items()}


def _opt25_f64(net):
    """(c): one update of every optimizer over the net's parameter arrays
    in float64, on the card and on the CPU; returns {label: worst error
    relative to each array's largest magnitude}."""
    import torch
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch import random as mxr
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    rng = np.random.RandomState(25)
    w64 = [p.tensor().detach().double().cpu() for p in params]
    g64 = [torch.from_numpy(rng.randn(*w.shape)) for w in w64]
    out = {}
    for label, (name, kw) in OPT25.items():
        got = {}
        for dev in ("cuda", "cpu"):
            mxr.seed(25)
            up = topt.get_updater(topt.create(name, **kw))
            ws = [w.to(dev, copy=True) for w in w64]
            for i, (w, g) in enumerate(zip(ws, g64)):
                up(i, g.to(dev), w)
            got[dev] = ws
        if label == "sgld":
            lr = kw["learning_rate"]
            r = torch.cat([((a.cpu() - (w - lr / 2 * g)) / lr ** 0.5)
                           .reshape(-1) for a, w, g in
                           zip(got["cuda"], w64, g64)])
            n = r.numel()
            z_mean = float(r.mean()) * n ** 0.5
            z_var = (float(r.var()) - 1.0) / (2.0 / n) ** 0.5
            if abs(z_mean) > 6 or abs(z_var) > 6:
                raise RuntimeError("phase 25 (c): SGLD noise off N(0, lr): "
                                   "z %.2f / %.2f" % (z_mean, z_var))
            out[label] = "noise z %.2f / %.2f" % (z_mean, z_var)
            continue
        worst = max(float((a.cpu() - b).abs().max())
                    / max(float(b.abs().max()), 1e-300)
                    for a, b in zip(got["cuda"], got["cpu"]))
        if not worst <= OPT25_F64_TOL:
            raise RuntimeError("phase 25 (c): %s card vs CPU %.3g"
                               % (label, worst))
        out[label] = worst
    return out, len(params)


def _dropout_run(seed, x, y):
    """(d): vgg16 (fixed weights from a card generator) trained 2 Gluon
    SGD steps after ``mx.random.seed(seed)``; its parameters."""
    import torch
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch import random as mxr
    net = _zoo_net("vgg16", 3)
    mxr.seed(seed)
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(ZOO_SGD),
                       kvstore="device")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = [float(_gluon_step(net, tr, loss_fn, x, y).mean().asscalar())
              for _ in range(2)]
    torch.cuda.synchronize()
    return losses, [p.tensor().detach().clone()
                    for p in net.collect_params().values()]


def phase_optimizers():
    """Phase 25: ResNet-50 v1 through every optimizer on both trainer
    tiers, card against CPU updates, Dropout from a seed.  Returns the B1
    / B3 launches of (b)."""
    import gc
    import torch
    from mxnet_tpu_torch import initializer, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision
    t_phase = time.monotonic()
    batch = RUNS["phase 21"]["batch"]
    rng = np.random.RandomState(21)
    net = vision.resnet50_v1()
    net.initialize(initializer.Xavier(), rng=np.random.RandomState(0))
    x = nd.array(rng.rand(batch, 3, 224, 224))
    y = nd.array(rng.randint(0, 1000, batch))
    net(x[:1])
    snap = _snapshot(net)
    rows = [_opt25_gluon(net, snap, label, x, y, batch) for label in OPT25]
    base = {r["optimizer"]: r for r in rows}
    for r in rows:
        print("phase 25 (a): Gluon %-16s %8.1f images/s (%.3f of sgd), "
              "update %.3f ms a step, peak %.2f GiB, losses %s" % (
                  r["optimizer"], r["images_s"],
                  r["images_s"] / base["sgd"]["images_s"], r["update_ms"],
                  r["peak_gib"], r["losses"]))
    t_a = time.monotonic() - t_phase
    fused = {}
    for label in OPT25_ELEMENTWISE:
        losses, launched, groups, _ = _opt25_dpt(net, snap, label, x, y)
        exact = {"sgd": "fused_sgd_momentum", "adam": "fused_adam"}
        want = {exact[label]: OPT25_DPT_STEPS * groups} \
            if label in exact else {}
        if launched != want:
            raise RuntimeError("phase 25 (b) %s: hand-kernel launches %s, "
                               "want %s" % (label, launched, want))
        if label in exact:
            fused[exact[label]] = launched[exact[label]]
        print("phase 25 (b): DataParallelTrainer %-16s losses %s, %d "
              "groups, hand kernels %s" % (label, ["%.5f" % v for v in losses],
                                           groups, launched or "none"))
    for label in ("lbsgd", "dcasgd"):
        try:
            _opt25_dpt(net, snap, label, x, y)
        except ValueError as e:
            print("phase 25 (b): %s refused: %s" % (label, str(e)[:90]))
        else:
            raise RuntimeError("phase 25 (b): %s did not raise" % label)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = [_opt25_dpt(net, snap, "sgld", x, y, depth, seed=181)
                for depth in (1, 4)]
        other = _opt25_dpt(net, snap, "sgld", x, y, 1, seed=182)
    finally:
        torch.backends.cudnn.deterministic = saved
    same = runs[0][0] == runs[1][0] and all(
        torch.equal(runs[0][3][n], runs[1][3][n]) for n in runs[0][3])
    differs = any(not torch.equal(runs[0][3][n], other[3][n])
                  for n in runs[0][3])
    print("phase 25 (b): SGLD from one seed, bulk(1) vs bulk(4): bitwise %s; "
          "another seed differs %s" % (same, differs))
    if not (same and differs):
        raise RuntimeError("phase 25 (b): SGLD repeat bitwise %s, another "
                           "seed differs %s" % (same, differs))
    t_b = time.monotonic() - t_phase - t_a
    errs, arrays = _opt25_f64(net)
    print("phase 25 (c): one float64 update over resnet50_v1's %d parameter "
          "arrays, card vs CPU (limit %.0e of each array's largest): %s"
          % (arrays, OPT25_F64_TOL, {k: v if isinstance(v, str)
                                      else float("%.3g" % v)
                                      for k, v in errs.items()}))
    del net, snap, x, y
    gc.collect()
    torch.cuda.empty_cache()
    t_c = time.monotonic() - t_phase - t_a - t_b
    drng = np.random.RandomState(25)
    dx = nd.array(drng.rand(DROPOUT_BATCH, 3, 224, 224))
    dy = nd.array(drng.randint(0, 1000, DROPOUT_BATCH))
    torch.backends.cudnn.deterministic = True
    try:
        a_l, a_p = _dropout_run(5, dx, dy)
        b_l, b_p = _dropout_run(5, dx, dy)
        c_l, c_p = _dropout_run(6, dx, dy)
    finally:
        torch.backends.cudnn.deterministic = saved
    same = a_l == b_l and all(torch.equal(u, v) for u, v in zip(a_p, b_p))
    differs = any(not torch.equal(u, v) for u, v in zip(a_p, c_p))
    print("phase 25 (d): vgg16 batch %d, 2 SGD steps through Dropout: seed 5 "
          "twice bitwise %s (losses %s), seed 6 differs %s (losses %s)"
          % (DROPOUT_BATCH, same, a_l, differs, c_l))
    if not (same and differs):
        raise RuntimeError("phase 25 (d): Dropout repeat bitwise %s, other "
                           "seed differs %s" % (same, differs))
    print("phase 25: %.1f s ((a) %.1f, (b) %.1f, (c) %.1f, (d) %.1f)" % (
        time.monotonic() - t_phase, t_a, t_b, t_c,
        time.monotonic() - t_phase - t_a - t_b - t_c))
    RUNS["phase 25"] = dict(rows=rows)
    return fused


# slice 19: the data pipeline (phase 26).  The .rec holds P26_RECORDS
# records (7 batches of 256, cut from 13 to keep the script inside its
# time limit) cycling the 16 JPEG fixtures of
# tests/data/torch_io/ (500 x 375); the main path's recipe is phase 22
# (c)'s: NHWC bf16 DataParallelTrainer, SGD_PARAMS, engine.bulk(4)
P26_RECORDS, P26_BATCH, P26_SIDE, P26_RESIZE = 1792, 256, 224, 256
P26_WARMUP, P26_TIMED, P26_PROFILED = 2, 10, 3
P26_GLUON_WARMUP, P26_GLUON_TIMED = 1, 3
P26_DEPTH = 2            # the pipeline's ring: prefetch_buffer slots a worker
P26_SHM_SHARE = 0.8      # of the free /dev/shm the ring may take
P26_MEAN = (123.68, 116.28, 103.53)
P26_STD = (58.395, 57.12, 57.375)
P26_MEAN_STD = dict(mean_r=P26_MEAN[0], mean_g=P26_MEAN[1],
                    mean_b=P26_MEAN[2], std_r=P26_STD[0], std_g=P26_STD[1],
                    std_b=P26_STD[2])
# Gluon's ToTensor scales to [0, 1]: the same normalization over 255
P26_MEAN01 = tuple(m / 255 for m in P26_MEAN)
P26_STD01 = tuple(s / 255 for s in P26_STD)
P26_DEVICE = "cuda"


def _p26_cuda_probe(samples):
    """A DataLoader ``batchify_fn`` run in a worker: whether CUDA is
    initialised there, and the worker's pid (module-level, so the worker
    imports it)."""
    import os
    import torch
    return np.array([int(torch.cuda.is_initialized()), os.getpid()])


def _p26_pipe_send(conn, nbytes):
    """A child's end of ``_p26_pipe_rate``: a marker, then ``nbytes``."""
    payload = bytes(nbytes)
    conn.send_bytes(b"go")
    conn.send_bytes(payload)
    conn.close()


def _p26_pipe_rate():
    """Bytes/s of one batch-sized message through a multiprocessing pipe
    from a worker process (the DataLoader's result path)."""
    from mxnet_tpu_torch.io.pipeline import _mp_context
    ctx = _mp_context()
    nbytes = P26_BATCH * 3 * P26_SIDE * P26_SIDE * 4
    reader, writer = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_p26_pipe_send, args=(writer, nbytes))
    proc.start()
    writer.close()
    reader.recv_bytes()
    t0 = time.perf_counter()
    got = len(reader.recv_bytes())
    dt = time.perf_counter() - t0
    proc.join(timeout=60)
    if got != nbytes:
        raise RuntimeError("the pipe carried %d of %d bytes" % (got, nbytes))
    return nbytes / dt


def _p26_probe():
    """What the host offers the pipeline: cores, OpenCV, PIL, libjpeg (the
    native decoder's build) and /dev/shm."""
    import os
    import shutil
    from mxnet_tpu_torch import _native
    out = {"nproc": os.cpu_count(),
           "affinity": len(os.sched_getaffinity(0))}
    for mod in ("cv2", "PIL"):
        r = subprocess.run([sys.executable, "-c",
                            "import %s; print(%s.__version__)" % (mod, mod)],
                           capture_output=True, text=True, timeout=120)
        out[mod] = r.stdout.strip() if r.returncode == 0 else None
        print("phase 26 (a): python -c 'import %s': %s" % (
            mod, "version " + out[mod] if out[mod] else "fails: "
            + (r.stderr.strip().splitlines() or ["?"])[-1]))
    out["jpeglib_h"] = os.path.exists("/usr/include/jpeglib.h")
    out["native"] = _native.available()
    print("phase 26 (a): nproc %d (affinity %d); /usr/include/jpeglib.h %s;"
          " mxnet_tpu_torch._native builds: %s (%s)%s"
          % (out["nproc"], out["affinity"], out["jpeglib_h"], out["native"],
             _native.library_path(),
             "" if out["native"] else ": " + str(_native._BUILD_ERROR)))
    usage = shutil.disk_usage("/dev/shm")
    out["shm_free"] = usage.free
    df = subprocess.run(["df", "-h", "/dev/shm"], capture_output=True,
                        text=True, timeout=60).stdout.strip()
    print("phase 26 (a): df -h /dev/shm: %s" % " | ".join(df.splitlines()))
    print("phase 26 (a): %s" % (
        "native decode threads per worker %d (min(nproc, 16); "
        "ImageRecordIter takes preprocess_threads as the worker count)"
        % _native.default_threads() if out["native"] else
        "no native decoder: ImageIter decodes with OpenCV where it is "
        "installed, one image at a time per worker"))
    return out


def _p26_ring(probe):
    """(most workers, ring depth) that fit the free /dev/shm: W x depth
    slots of one batch each."""
    slot = P26_BATCH * P26_SIDE * P26_SIDE * 3 + P26_BATCH * 4
    budget = P26_SHM_SHARE * probe["shm_free"]
    for depth in range(P26_DEPTH, 0, -1):
        most = min(probe["affinity"], int(budget // (depth * slot)))
        if most >= 1:
            break
    print("phase 26 (a): ring slot %.1f MB; %.0f MB of /dev/shm free; up to "
          "%d workers at depth %d (%.0f MB)"
          % (slot / 1e6, probe["shm_free"] / 1e6, max(most, 0), depth,
             max(most, 0) * depth * slot / 1e6))
    return max(most, 0), depth


def _p26_pipe(rec, idx, workers, depth, **kw):
    """The pipeline over the phase's records: resize 256, center crop 224,
    seed 0, no shuffle (``kw`` adds dtype / layout)."""
    from mxnet_tpu_torch.io.pipeline import ImagePipelineIter
    return ImagePipelineIter(num_workers=workers, prefetch_buffer=depth,
                             seed=0, path_imgrec=rec, path_imgidx=idx,
                             batch_size=P26_BATCH,
                             data_shape=(3, P26_SIDE, P26_SIDE),
                             resize=P26_RESIZE, **kw)


def _p26_decode(bufs, native):
    """The records' images decoded in this process, as the pipeline's
    chain does: the native decoder, else OpenCV through the augmenters'
    functions (resize-short 256, center crop 224)."""
    from mxnet_tpu_torch import _native, image
    if native:
        out, fails = _native.decode_batch(bufs, P26_SIDE, P26_SIDE, 3,
                                          resize_short=P26_RESIZE)
        if fails:
            raise RuntimeError("%d native decode failures" % fails)
        return out
    imgs = []
    for b in bufs:
        img = image.resize_short(image.imdecode(b).asnumpy(), P26_RESIZE)
        imgs.append(image.center_crop(img, (P26_SIDE, P26_SIDE))[0])
    return np.stack(imgs)


def _p26_host_checks(rec, idx, best, depth, native):
    """W = 0 and W = best bitwise over the epoch; the first batch bitwise
    an in-process decode of its records by the same decoder.  Returns the
    first batch (uint8 NHWC)."""
    from mxnet_tpu_torch import recordio
    kw = dict(dtype="uint8", layout="NHWC")
    w0 = _p26_pipe(rec, idx, 0, depth, **kw)
    wb = _p26_pipe(rec, idx, best, depth, **kw)
    first, n = None, 0
    try:
        for a, b in zip(w0, wb):
            a, b = a.data[0].asnumpy(), b.data[0].asnumpy()
            if not np.array_equal(a, b):
                raise RuntimeError("W=0 and W=%d differ at batch %d"
                                   % (best, n))
            if first is None:
                first = a
            n += 1
    finally:
        wb.close()
    if n != P26_RECORDS // P26_BATCH:
        raise RuntimeError("%d batches in the epoch, want %d"
                           % (n, P26_RECORDS // P26_BATCH))
    r = recordio.MXIndexedRecordIO(idx, rec, "r")
    bufs = [recordio.unpack(r.read_idx(i))[1] for i in range(P26_BATCH)]
    r.close()
    if not np.array_equal(first, _p26_decode(bufs, native)):
        raise RuntimeError("the first batch is not the in-process decode")
    print("phase 26 (b): W=0 and W=%d give the same seeded stream, bitwise "
          "(%d batches of %d); the first batch is bitwise an in-process "
          "%s decode of records 0-%d"
          % (best, n, P26_BATCH, "native" if native else "OpenCV",
             P26_BATCH - 1))
    return first


def _p26_tail_check(first):
    """The tail on the card against its plain version on the CPU."""
    import torch
    from mxnet_tpu_torch.io import make_device_tail
    host = torch.from_numpy(first)
    for dtype in ("float32", "bfloat16"):
        for layout in ("NHWC", "NCHW"):
            tail = make_device_tail(P26_MEAN, P26_STD, dtype, layout)
            got = tail(host.to(P26_DEVICE)).cpu()
            want = tail(host)
            if not torch.equal(got, want):
                raise RuntimeError("the tail on the card (%s, %s) is not "
                                   "bitwise its plain version: max |d| %g"
                                   % (dtype, layout, float(
                                       (got.float() - want.float()).abs()
                                       .max())))
            print("phase 26 (c): tail %s %s on the card bitwise its plain "
                  "CPU version over batch 0 (%s)"
                  % (dtype, layout, tuple(got.shape)))


def _p26_next(it):
    """The next batch, starting a new epoch at the end of one."""
    try:
        return it.next()
    except StopIteration:
        it.reset()
        return it.next()


def _p26_idle(step, n):
    """The device's idle share over ``n`` calls of ``step`` (a profiler
    window), or None where it records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _p26_sync()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if P26_DEVICE == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        _p26_sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    return None if busy <= 0 else 1 - busy / wall_us


def _p26_sync():
    import torch
    if P26_DEVICE == "cuda":
        torch.cuda.synchronize()


def _p26_train(label, it=None, transform=None, synth=None):
    """``P26_WARMUP`` + ``P26_TIMED`` steps of phase 22 (c)'s trainer fed
    by the iterator ``it`` (or, ``synth``, device-resident batches in
    turn), inside ``engine.bulk(4)``, then a profiled window of
    ``P26_PROFILED`` steps.  Returns the rates and counts."""
    import gc
    import torch
    from mxnet_tpu_torch import engine, initializer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    from mxnet_tpu_torch.parallel import DataParallelTrainer
    net = vision.resnet50_v1(layout="NHWC")
    net.initialize(initializer.Xavier(), ctx=P26_DEVICE,
                   rng=np.random.RandomState(0))
    tr = DataParallelTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                             dict(SGD_PARAMS), dtype="bf16",
                             input_transform=transform, device=P26_DEVICE)
    turn = [0]

    def step(b=None):
        if synth is not None:
            turn[0] += 1
            x, y = synth[turn[0] % len(synth)]
        else:
            b = b or _p26_next(it)
            x, y = b.data[0], b.label[0]
        return tr.step(x, y)

    fo.reset_launch_counts()
    if P26_DEVICE == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, marks = [], []
    with engine.bulk(4):
        for _ in range(P26_WARMUP):
            losses.append(step())
        tr.flush()
        t0 = time.perf_counter()
        for _ in range(P26_TIMED):
            losses.append(step())
            marks.append(time.perf_counter())
        tr.flush()
        t1 = time.perf_counter()
        # the sustained rate: the window above is fed in part from batches
        # decoded while the net was built, so finish this epoch, then time
        # one whole epoch from an empty ring
        while synth is None:
            try:
                b = it.next()
            except StopIteration:
                it.reset()
                break
            losses.append(step(b))
        ts = time.perf_counter()
        for _ in range(P26_RECORDS // P26_BATCH):
            losses.append(step())
        tr.flush()
        sustained = P26_BATCH * (P26_RECORDS // P26_BATCH) / (
            time.perf_counter() - ts)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
            if P26_DEVICE == "cuda" else float("nan")
        idle = _p26_idle(lambda: losses.append(step()), P26_PROFILED)
        tr.flush()
    launches = fo.launch_counts()["fused_sgd_momentum"]
    steps, buckets = len(losses), len(tr._groups)
    losses = [float(v) for v in losses]
    if not np.isfinite(losses).all():
        raise RuntimeError("phase 26 (%s): losses %r" % (label, losses))
    if P26_DEVICE == "cuda" and launches != steps * buckets:
        raise RuntimeError("phase 26 (%s): fused_sgd_momentum launched %d "
                           "times, want %d steps x %d buckets"
                           % (label, launches, steps, buckets))
    gaps = np.diff([t0] + marks) * 1e3
    out = dict(images_s=P26_BATCH * P26_TIMED / (t1 - t0),
               sustained=sustained, p50=float(np.percentile(gaps, 50)),
               p99=float(np.percentile(gaps, 99)), peak_gib=peak, idle=idle,
               launches=launches, steps=steps, buckets=buckets,
               losses=losses)
    base = getattr(it, "base", None)
    if it is not None and hasattr(it, "stats"):
        snap = it.stats.snapshot()
        out["feed_s_per_batch"] = snap["worker_busy_s"] / max(
            1, snap["batches"])
        out["feed_stall_pct"] = snap["stall_pct"]
    if base is not None and hasattr(base, "stats"):
        snap = base.stats.snapshot()
        out["decode_stall_pct"] = snap["stall_pct"]
        out["decode_utilization"] = snap["worker_utilization"]
        out["respawns"] = snap["respawns"]
    if base is not None and hasattr(base, "close"):
        base.close()
    print("phase 26 (%s): %.1f images/s over the %d-step window, %.1f "
          "sustained over a whole epoch, step p50 %.2f ms, p99 %.2f ms, "
          "peak %.2f GiB, idle share %s, fused_sgd_momentum %d (= %d steps "
          "x %d bucket); losses %s%s"
          % (label, out["images_s"], P26_TIMED, sustained, out["p50"],
             out["p99"], peak,
             "not measured" if idle is None else "%.4f" % idle, launches,
             steps, buckets, ["%.4f" % v for v in losses[:3]],
             "".join(", %s %.5g" % (k, out[k]) for k in (
                 "feed_s_per_batch", "feed_stall_pct", "decode_stall_pct",
                 "decode_utilization") if k in out)))
    del tr, net, it
    gc.collect()
    if P26_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def _p26_gluon(rec, idx, probe, workers):
    """(d): Gluon ResNet-50 (phase 21's recipe) fed by ``DataLoader(...,
    batch_size=256, shuffle=True, num_workers=workers)`` over the records
    (``ImageRecordDataset`` with the augmenting transforms where OpenCV is
    installed, else the native decoder's uint8 images through
    ``ArrayDataset`` with ``ToTensor`` and ``Normalize``)."""
    import gc
    import torch
    from mxnet_tpu_torch import gluon, initializer, recordio
    from mxnet_tpu_torch.gluon import data
    from mxnet_tpu_torch.gluon.data.vision import transforms as T
    from mxnet_tpu_torch.gluon.model_zoo import vision
    n_steps = P26_GLUON_WARMUP + P26_GLUON_TIMED
    norm = [T.ToTensor(), T.Normalize(P26_MEAN01, P26_STD01)]
    if probe["cv2"]:
        ds = data.vision.ImageRecordDataset(rec).transform_first(T.Compose(
            [T.RandomResizedCrop(P26_SIDE), T.RandomFlipLeftRight()] + norm))
        what = ("ImageRecordDataset + RandomResizedCrop, "
                "RandomFlipLeftRight, ToTensor, Normalize (OpenCV)")
    else:
        n = n_steps * P26_BATCH
        r = recordio.MXIndexedRecordIO(idx, rec, "r")
        recs = [recordio.unpack(r.read_idx(i)) for i in range(n)]
        r.close()
        if probe["native"]:
            imgs = _p26_decode([s for _, s in recs], True)
            what = "no OpenCV: the native decoder's uint8 images"
        else:
            imgs = np.random.RandomState(26).randint(
                0, 256, (n, P26_SIDE, P26_SIDE, 3)).astype(np.uint8)
            what = "no decoder on this host: seeded uint8 images"
        labels = np.array([h.label for h, _ in recs], np.float32)
        ds = data.ArrayDataset(imgs, labels).transform_first(
            T.Compose(norm))
        what += " + ArrayDataset, ToTensor, Normalize"
    loader = data.DataLoader(ds, batch_size=P26_BATCH, shuffle=True,
                             num_workers=workers)
    probe_loader = data.DataLoader(data.SimpleDataset(list(range(
        2 * workers))), 1, batchify_fn=_p26_cuda_probe,
        num_workers=workers)
    try:
        probes = list(probe_loader)
        if any(p[0] for p in probes):
            raise RuntimeError("a DataLoader worker initialised CUDA: %r"
                               % probes)
        net = vision.resnet50_v1()
        net.initialize(initializer.Xavier(), ctx=P26_DEVICE,
                       rng=np.random.RandomState(0))
        tr = gluon.Trainer(net.collect_params(), "sgd", dict(GLUON_SGD),
                           kvstore="device")
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        for m in _hand_counters():
            m.reset_launch_counts()
        batches = iter(loader)
        losses = []
        for i in range(n_steps):
            if i == P26_GLUON_WARMUP:
                _p26_sync()
                t0 = time.perf_counter()
            x, y = next(batches)
            if x.context.type != P26_DEVICE:
                raise RuntimeError("a DataLoader batch on %s" % x.context)
            losses.append(float(_gluon_step(net, tr, loss_fn, x, y)
                                .mean().asscalar()))
        _p26_sync()
        ips = P26_BATCH * P26_GLUON_TIMED / (time.perf_counter() - t0)
        launched = _hand_launches()
    finally:
        loader.shutdown()
        probe_loader.shutdown()
    if launched:
        raise RuntimeError("phase 26 (d) launched hand kernels: %s"
                           % launched)
    if not np.isfinite(losses).all():
        raise RuntimeError("phase 26 (d): losses %r" % losses)
    pipe = _p26_pipe_rate()
    beside = RUNS.get("phase 21", {}).get("images_s")
    print("phase 26 (d): Gluon resnet50_v1 NCHW f32 fed by DataLoader(batch "
          "%d, shuffle, num_workers=%d) over %s: %.1f images/s over %d "
          "steps after %d (phase 21's synthetic batch in this call: %s); "
          "losses %s; B1-B10 launches none; %d DataLoader workers probed, "
          "none initialised CUDA"
          % (P26_BATCH, workers, what, ips, P26_GLUON_TIMED,
             P26_GLUON_WARMUP, "not run" if beside is None
             else "%.1f images/s, ratio %.4f" % (beside, ips / beside),
             ["%.4f" % v for v in losses], len({p[1] for p in probes})))
    print("phase 26 (d): one %.1f MB float32 batch through a "
          "multiprocessing pipe from a worker process (the DataLoader's "
          "result path): %.1f MB/s, %.3f s a batch"
          % (P26_BATCH * 3 * P26_SIDE ** 2 * 4 / 1e6, pipe / 1e6,
             P26_BATCH * 3 * P26_SIDE ** 2 * 4 / pipe))
    del net, tr, loader, ds
    gc.collect()
    if P26_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return ips


def phase_data_pipeline():
    """Phase 26: the data pipeline on the card.  Returns B1's launches on
    the main path (c)."""
    import shutil
    import tempfile
    import torch
    from mxnet_tpu_torch import _native, io
    from mxnet_tpu_torch.io import bench, make_device_tail
    t_phase = time.monotonic()
    probe = _p26_probe()
    if _native.available() != probe["native"]:
        raise RuntimeError("_native.available() disagrees with the probe")
    most, depth = _p26_ring(probe)
    decoder = "native" if probe["native"] else \
        "cv2" if probe["cv2"] else None
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p26_")
    try:
        rec, idx = bench.fixture_rec(P26_RECORDS, tmp)
        best, first = 0, None
        if decoder is not None:
            curve = sorted({0, most} | {w for w in (4, 8, 16)
                                        if w <= most})
            t0 = time.monotonic()
            feed = bench.run(P26_RECORDS, P26_BATCH, P26_SIDE, curve,
                             resize=P26_RESIZE)
            print("phase 26 (b): %s" % json.dumps(feed))
            each = "%d native decode threads" % _native.default_threads() \
                if decoder == "native" else "OpenCV, one image at a time"
            for w in curve:
                print("phase 26 (b): W=%d (depth %d, %s each): %.1f "
                      "images/s fed to the host over a timed epoch of %d "
                      "after a warm-up epoch"
                      % (w, depth, each,
                         feed["pipeline_worker_scaling"][str(w)],
                         P26_RECORDS))
            best = feed["pipeline_best_workers"]
            print("phase 26 (b): best W=%d at %.1f images/s; legacy float "
                  "path %.1f; raw native decode %s images/s (%.1f s)"
                  % (best, feed["pipeline_fed_imgs_per_sec"],
                     feed["pipeline_fed_legacy_imgs_per_sec"],
                     feed.get("pipeline_decode_imgs_per_sec", "n/a"),
                     time.monotonic() - t0))
            first = _p26_host_checks(rec, idx, best, depth,
                                     decoder == "native")
        else:
            print("phase 26 (b): no decoder on this host (no libjpeg build,"
                  " no OpenCV): the host feed is not measured; (c) runs "
                  "from seeded uint8 batches through NDArrayIter")
            first = np.random.RandomState(26).randint(
                0, 256, (P26_BATCH, P26_SIDE, P26_SIDE, 3)).astype(np.uint8)
        _p26_tail_check(first)
        tail = make_device_tail(P26_MEAN, P26_STD, "bfloat16", "NHWC")

        def records(**kw):
            it = io.ImageRecordIter(
                path_imgrec=rec, path_imgidx=idx, batch_size=P26_BATCH,
                data_shape=(3, P26_SIDE, P26_SIDE), resize=P26_RESIZE,
                layout="NHWC", seed=0, preprocess_threads=best,
                prefetch_buffer=depth, **kw)
            pipe = getattr(it, "base", it)
            used = "native" if pipe._template._native_tail is not None \
                else "cv2"
            if used != decoder:
                raise RuntimeError("the iterator decodes with %s; the "
                                   "probe found %s" % (used, decoder))
            print("phase 26 (c): ImageRecordIter(%s) decodes with %s, "
                  "W=%d, depth %d" % (", ".join(sorted(kw)), used, best,
                                      depth))
            return it

        def fallback():
            return io.NDArrayIter(np.concatenate([first] * 4), np.arange(
                4 * P26_BATCH, dtype=np.float32) % 1000, P26_BATCH)

        from mxnet_tpu_torch.ops import fused_optimizer as fo
        fo.reset_launch_counts()
        runs = {}
        if decoder is not None:
            runs["c1"] = _p26_train("c1", records(
                device_tail=True, dtype="bfloat16", **P26_MEAN_STD))
            runs["c2"] = _p26_train("c2", io.PrefetchToDeviceIter(
                records(dtype="uint8"), depth=depth), tail)
        else:
            runs["c1"] = _p26_train("c1", io.DeviceFeedIter(
                fallback(), transform=tail))
            runs["c2"] = _p26_train("c2", io.PrefetchToDeviceIter(
                fallback()), tail)
        gen = torch.Generator(device=P26_DEVICE).manual_seed(26)
        synth = [(torch.randint(0, 256, first.shape, dtype=torch.uint8,
                                device=P26_DEVICE, generator=gen),
                  torch.randint(0, 1000, (P26_BATCH,), device=P26_DEVICE,
                                generator=gen).float()) for _ in range(2)]
        runs["synthetic"] = _p26_train("synthetic", transform=tail,
                                       synth=synth)
        launches = sum(r["launches"] for r in runs.values())
        syn = runs["synthetic"]
        for k in ("c1", "c2"):
            print("phase 26 (c): %s %.1f images/s (window) and %.1f "
                  "(sustained) against the device-resident synthetic uint8 "
                  "feed's %.1f and %.1f (ratios %.4f, %.4f); idle share %s "
                  "against %s"
                  % (k, runs[k]["images_s"], runs[k]["sustained"],
                     syn["images_s"], syn["sustained"],
                     runs[k]["images_s"] / syn["images_s"],
                     runs[k]["sustained"] / syn["sustained"],
                     runs[k]["idle"], syn["idle"]))
        if decoder is not None:
            if any(r.get("respawns") for r in runs.values()):
                raise RuntimeError("pipeline workers respawned in (c)")
            print("phase 26 (c): no pipeline worker initialised CUDA "
                  "(each checks after every batch; none failed)")
        _p26_gluon(rec, idx, probe, max(1, best))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("phase 26: B1 launches %d over (c); %.1f s"
          % (launches, time.monotonic() - t_phase))
    return launches


# -- slice 20: training through Symbol, Executor and Module ------------------
P27_RECORDS, P27_BATCH, P27_SIDE = 1024, 128, 224   # 8 batches of the tool's
P27_WARMUP, P27_TIMED = 2, 10
P27_PARITY_BATCH = 2
P27_OUT_TOL = 1e-4       # card vs CPU outputs, f32 TF32 off (phase 6's)
P27_F64_TOL = 1e-4
P27_SMALL_TOL = 1e-5     # (d): small nets, card vs CPU, TF32 off
P27_MNIST_TRAIN, P27_MNIST_VAL, P27_MNIST_EPOCHS = 2048, 512, 3
P27_ACC_BAR = 0.8        # the reference test's bar (tests/test_module.py:37)
P27_DEVICE = "cuda"
P27_MEAN = dict(mean_r=123.68, mean_g=116.78, mean_b=103.94)


def _p27_mnist_files(tmp):
    """idx files (gzip) of a learnable 10-class set in the MNIST layout:
    each class a seeded sparse 28 x 28 stroke mask (a fifth of the pixels,
    MNIST's ink share), each image its class's mask with 30 % of its ink
    dropped and 5 % of the pixels lit at random (the reference's
    synthetic fallback draws random labels, which no net can learn)."""
    import gzip
    import os
    import struct
    masks = np.random.RandomState(27).rand(10, 28, 28) < 0.2
    for stem, n, seed in (("train", P27_MNIST_TRAIN, 1),
                          ("t10k", P27_MNIST_VAL, 2)):
        r = np.random.RandomState(seed)
        labels = r.randint(0, 10, n).astype(np.uint8)
        ink = (masks[labels] & (r.rand(n, 28, 28) > 0.3)) \
            | (r.rand(n, 28, 28) < 0.05)
        imgs = (ink * 255).astype(np.uint8)
        with gzip.open(os.path.join(tmp, stem + "-images-idx3-ubyte.gz"),
                       "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
        with gzip.open(os.path.join(tmp, stem + "-labels-idx1-ubyte.gz"),
                       "wb") as f:
            f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _p27_ce(prob, label):
    """Mean cross-entropy of SoftmaxOutput's probabilities (a tensor)."""
    import torch
    lab = label.to(prob.device).long()
    return -torch.log(prob[torch.arange(prob.shape[0], device=prob.device),
                           lab].clamp_min(1e-30)).mean()


def _p27_fit(tmp, rec, workers):
    """(a): ``tools/train_imagenet.main`` on the records, one epoch, batch
    halved on out-of-memory.  Returns (module, batch, prefix, stats)."""
    import gc
    import torch
    from mxnet_tpu_torch.tools import train_imagenet
    batch = P27_BATCH
    while True:
        marks, losses = [], []

        def stamp(param):
            mod = param.locals["self"]
            losses.append(float(_p27_ce(mod.get_outputs()[0]._data,
                                        param.locals["data_batch"].label[0]
                                        ._data)))
            marks.append(time.perf_counter())
        prefix = "%s/r50b%d" % (tmp, batch)
        try:
            t0 = time.perf_counter()
            mod = train_imagenet.main(
                ["--data-train", rec, "--num-layers", "50",
                 "--image-shape", "3,%d,%d" % (P27_SIDE, P27_SIDE),
                 "--num-classes", "1000", "--batch-size", str(batch),
                 "--num-epochs", "1", "--num-examples", str(P27_RECORDS),
                 "--model-prefix", prefix, "--data-nthreads", str(workers),
                 "--ctx", "gpu" if P27_DEVICE == "cuda" else "cpu"],
                batch_end_callback=stamp)
            wall = time.perf_counter() - t0
            break
        except torch.cuda.OutOfMemoryError:
            if batch <= 8:
                raise
            gc.collect()
            torch.cuda.empty_cache()
            batch //= 2
            print("phase 27 (a): out of memory, batch halved to %d"
                  % batch)
    if not np.isfinite(losses).all() or len(losses) != P27_RECORDS // batch:
        raise RuntimeError("phase 27 (a): losses %r" % losses)
    fed = batch * (len(marks) - 1) / (marks[-1] - marks[0])
    print("phase 27 (a): tools/train_imagenet.py, ResNet-50 v2 (symbolic, "
          "1000 classes, %d x %d), batch %d, %d JPEG records, %d decode "
          "workers: %d steps in %.2f s (bind, Xavier init and checkpoint "
          "included); fed %.1f images/s over steps 2-%d; losses %s"
          % (P27_SIDE, P27_SIDE, batch, P27_RECORDS, workers, len(losses),
             wall, fed, len(losses), ["%.4f" % v for v in losses]))
    return mod, batch, prefix, dict(fed=fed, losses=losses)


def _p27_reload(mod, batch, prefix, rec):
    """(a): ``Module.load`` of the checkpoint the tool wrote, ``score``
    and ``predict`` over the records (no augmentation)."""
    from mxnet_tpu_torch import io, module
    loaded = module.Module.load(prefix, 1, context=P27_DEVICE)
    val = io.ImageRecordIter(path_imgrec=rec,
                             data_shape=(3, P27_SIDE, P27_SIDE),
                             batch_size=batch, resize=256, **P27_MEAN)
    loaded.bind(val.provide_data, val.provide_label, for_training=False)
    want_arg, want_aux = mod.get_params()
    got_arg, got_aux = loaded.get_params()
    for want, got in ((want_arg, got_arg), (want_aux, got_aux)):
        for n in want:
            if not bool((want[n]._data == got[n]._data).all()):
                raise RuntimeError("phase 27 (a): %s differs after "
                                   "Module.load" % n)
    t0 = time.perf_counter()
    acc = loaded.score(val, "acc")[0][1]
    pred = loaded.predict(val, num_batch=2).asnumpy()
    if pred.shape != (2 * batch, 1000) or not np.isfinite(pred).all() \
            or not np.allclose(pred.sum(axis=1), 1.0, atol=1e-3):
        raise RuntimeError("phase 27 (a): predict gave %s" % (pred.shape,))
    print("phase 27 (a): Module.load(%s, 1): every parameter and moving "
          "statistic bitwise the trained module's; score accuracy %.4f over "
          "%d records, predict %s, rows sum to 1 (%.2f s)"
          % (prefix.rsplit("/", 1)[-1], acc, P27_RECORDS, pred.shape,
             time.perf_counter() - t0))


def _p27_steps(mod, batch):
    """(a): timed ``forward`` / ``backward`` / ``update`` on one fixed
    uint8 batch on the card (cast to f32 by the executor's feed)."""
    import torch
    from mxnet_tpu_torch.io import DataBatch
    from mxnet_tpu_torch.ndarray import NDArray
    gen = torch.Generator(device=P27_DEVICE).manual_seed(27)
    x = torch.randint(0, 256, (batch, 3, P27_SIDE, P27_SIDE),
                      dtype=torch.uint8, device=P27_DEVICE, generator=gen)
    y = torch.randint(0, 1000, (batch,), device=P27_DEVICE,
                      generator=gen).float()
    db = DataBatch([NDArray(x)], [NDArray(y)])
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
          for _ in range(P27_WARMUP + P27_TIMED)]
    outs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, e in enumerate(ev):
        if i == P27_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        e[0].record()
        mod.forward(db, is_train=True)
        e[1].record()
        mod.backward()
        e[2].record()
        mod.update()
        e[3].record()
        outs.append(mod.get_outputs()[0]._data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def step():
        mod.forward(db, is_train=True)
        mod.backward()
        mod.update()
    idle = _p26_idle(step, 3)
    losses = [float(_p27_ce(o, y)) for o in outs]
    split = np.mean([[e[k].elapsed_time(e[k + 1]) for k in range(3)]
                     for e in ev[P27_WARMUP:]], axis=0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rate = batch * P27_TIMED / wall
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise RuntimeError("phase 27 (a): synthetic losses %r" % losses)
    p5 = RUNS.get("phase 5")
    print("phase 27 (a): Module forward_backward + update on a fixed uint8 "
          "batch of %d: %.1f images/s over %d steps (host clock), ms a "
          "step between CUDA events forward %.3f / backward %.3f / update "
          "%.3f, idle share %s over 3 more (profiler), peak %.2f GiB; "
          "losses %s; phase 5's DataParallelTrainer f32 (batch %s, B1 "
          "update) %s images/s"
          % (batch, rate, P27_TIMED, split[0], split[1], split[2],
             "not measured" if idle is None else "%.4f" % idle, peak,
             ["%.4f" % v for v in losses],
             p5["batch"] if p5 else "n/a",
             "%.1f" % p5["images_s"] if p5 else "not run"))
    return dict(images_s=rate, fwd_ms=split[0], bwd_ms=split[1],
                upd_ms=split[2], peak_gib=peak, idle=idle)


def _p27_parity():
    """(b): one forward_backward of get_symbol(1000, 50, "3,224,224") at
    batch 2, card vs CPU from the same weights."""
    import torch
    from mxnet_tpu_torch import initializer, io, module, nd
    from mxnet_tpu_torch.tools.symbols import resnet
    sym = resnet.get_symbol(1000, 50, "3,%d,%d" % (P27_SIDE, P27_SIDE))
    shape = (P27_PARITY_BATCH, 3, P27_SIDE, P27_SIDE)
    rng = np.random.RandomState(2)
    x = rng.rand(*shape).astype(np.float32)
    y = rng.randint(0, 1000, P27_PARITY_BATCH).astype(np.float32)
    init = module.Module(sym, context="cpu")
    init.bind([("data", shape)], [("softmax_label", y.shape)])
    init.init_params(initializer.Xavier(rnd_type="gaussian",
                                        factor_type="in", magnitude=2),
                     rng=np.random.RandomState(1))
    arg, aux = [{k: v.asnumpy() for k, v in d.items()}
                for d in init.get_params()]
    up = {k: np.nextafter(v, np.float32(np.inf)) for k, v in arg.items()}

    def f32(ctx, weights):
        mod = module.Module(sym, context=ctx)
        mod.bind([("data", shape)], [("softmax_label", y.shape)])
        mod.set_params(weights, aux)
        mod.forward_backward(io.DataBatch([nd.array(x, ctx="cpu")],
                                          [nd.array(y, ctx="cpu")]))
        return (mod.get_outputs()[0].asnumpy(),
                {k: v.asnumpy() for k, v in mod._exec.grad_dict.items()})

    def f64(ctx):
        exe = sym.simple_bind(ctx, grad_req="write", type_dict={
            n: "float64" for n in sym.list_arguments()}, data=shape,
            softmax_label=y.shape)
        exe.copy_params_from(arg, aux)
        exe.forward(is_train=True, data=x.astype(np.float64),
                    softmax_label=y.astype(np.float64))
        exe.backward()
        return (exe.outputs[0].asnumpy(),
                {k: v.asnumpy() for k, v in exe.grad_dict.items()
                 if k not in ("data", "softmax_label")})

    def worst(a, b):
        return max((float(np.abs(a[n].astype(np.float64) - b[n]).max()), n)
                   for n in a)

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        out_g, g_g = f32(P27_DEVICE, arg)
        out_c, g_c = f32("cpu", arg)
        _, g_u = f32("cpu", up)
        out_g64, g_g64 = f64(P27_DEVICE)
        out_c64, g_c64 = f64("cpu")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    d_out = float(np.abs(out_g - out_c).max())
    d_g, at_g = worst(g_g, g_c)
    d_u, at_u = worst(g_u, g_c)
    d_out64 = float(np.abs(out_g64 - out_c64).max())
    d_g64, at_g64 = worst(g_g64, g_c64)
    print("phase 27 (b): ResNet-50 v2 batch %d, one forward_backward, TF32 "
          "off: f32 outputs card vs CPU %.3g (tol %g); gradients %.3g (%s), "
          "rounding floor %.3g (%s: the CPU run from weights one ulp up), "
          "allowed %g x floor; f64 through type_dict: outputs %.3g, "
          "gradients %.3g (%s) (tol %g); %.1f s"
          % (P27_PARITY_BATCH, d_out, P27_OUT_TOL, d_g, at_g, d_u, at_u,
             NOISE_FACTOR, d_out64, d_g64, at_g64, P27_F64_TOL,
             time.perf_counter() - t0))
    if d_out > P27_OUT_TOL:
        raise RuntimeError("phase 27 (b): f32 outputs differ by %.3g"
                           % d_out)
    if d_g > max(NOISE_FACTOR * d_u, P27_OUT_TOL):
        raise RuntimeError("phase 27 (b): f32 gradients differ by %.3g, "
                           "more than %g x the floor %.3g"
                           % (d_g, NOISE_FACTOR, d_u))
    if d_out64 > P27_F64_TOL or d_g64 > P27_F64_TOL:
        raise RuntimeError("phase 27 (b): f64 differs: outputs %.3g, "
                           "gradients %.3g" % (d_out64, d_g64))
    if g_g["bn_data_gamma"].any():
        raise RuntimeError("phase 27 (b): fix_gamma's gamma got a gradient")


def _p27_mnist(tmp):
    """(c): tools/train_mnist.py, MLP and LeNet, on the card."""
    from mxnet_tpu_torch.tools import train_mnist
    _p27_mnist_files(tmp)
    for net in ("mlp", "lenet"):
        argv = ["--network", net, "--data-dir", tmp, "--num-epochs",
                str(P27_MNIST_EPOCHS), "--batch-size", "64"] \
            + ([] if P27_DEVICE == "cuda" else ["--cpu"])
        t0 = time.perf_counter()
        mod = train_mnist.main(argv)
        wall = time.perf_counter() - t0
        val = train_mnist.get_iters(train_mnist.parse_args(argv))[1]
        acc = mod.score(val, "acc")[0][1]
        print("phase 27 (c): train_mnist --network %s, %d epochs of %d "
              "images on the card in %.2f s: validation accuracy %.4f "
              "(bar %g)" % (net, P27_MNIST_EPOCHS, P27_MNIST_TRAIN, wall,
                            acc, P27_ACC_BAR))
        if not acc > P27_ACC_BAR:
            raise RuntimeError("phase 27 (c): %s accuracy %.4f" % (net, acc))


def _p27_small(ctx):
    """(d) on ``ctx``: BucketingModule and SequentialModule steps and a
    CustomOp softmax; returns numpy results."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    rng = np.random.RandomState(4)
    w = (rng.randn(8, 12) * 0.3).astype(np.float32)
    out = {}

    def gen(key):
        data = mx.sym.Variable("data")
        net = mx.sym.FullyConnected(data, num_hidden=8, name="fcb")
        return mx.sym.SoftmaxOutput(net, name="softmax"), ("data",), \
            ("softmax_label",)
    bm = mx.mod.BucketingModule(gen, default_bucket_key=10, context=ctx)
    bm.bind([("data", (10, 12))], [("softmax_label", (10,))])
    bm.init_params(arg_params={"fcb_weight": w,
                               "fcb_bias": np.zeros(8, np.float32)})
    bm.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                        "momentum": 0.9})
    for key in (10, 6, 10):
        x = rng.randn(key, 12).astype(np.float32)
        lab = rng.randint(0, 8, key).astype(np.float32)
        bm.forward(mx.io.DataBatch(
            [nd.array(x, ctx="cpu")], [nd.array(lab, ctx="cpu")],
            bucket_key=key, provide_data=[mx.io.DataDesc("data", x.shape)],
            provide_label=[mx.io.DataDesc("softmax_label", lab.shape)]),
            is_train=True)
        bm.backward()
        bm.update()
    out["bucketing"] = bm.get_params()[0]["fcb_weight"].asnumpy()
    d1 = mx.sym.Variable("data")
    m1 = mx.mod.Module(mx.sym.Activation(mx.sym.FullyConnected(
        d1, num_hidden=5, name="sa"), act_type="tanh"), label_names=None,
        context=ctx)
    m2 = mx.mod.Module(mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Variable("hidden"), num_hidden=3, name="sb"),
        name="softmax"), data_names=["hidden"], context=ctx)
    seq = mx.mod.SequentialModule().add(m1).add(m2, take_labels=True)
    seq.bind([("data", (10, 6))], [("softmax_label", (10,))],
             inputs_need_grad=True)
    seq.init_params(arg_params={
        "sa_weight": (rng.randn(5, 6) * 0.4).astype(np.float32),
        "sa_bias": np.zeros(5, np.float32),
        "sb_weight": (rng.randn(3, 5) * 0.4).astype(np.float32),
        "sb_bias": np.zeros(3, np.float32)})
    seq.init_optimizer(optimizer_params={"learning_rate": 0.2})
    for _ in range(2):
        seq.forward(mx.io.DataBatch(
            [nd.array(rng.randn(10, 6).astype(np.float32), ctx="cpu")],
            [nd.array(rng.randint(0, 3, 10).astype(np.float32),
                      ctx="cpu")]), is_train=True)
        seq.backward()
        seq.update()
    out["sequential"] = seq.get_outputs()[0].asnumpy()
    out["sequential_in_grad"] = seq.get_input_grads()[0].asnumpy()
    x = nd.array(rng.randn(6, 5).astype(np.float32), ctx=ctx)
    lab = nd.array(rng.randint(0, 5, 6).astype(np.float32), ctx=ctx)
    x.attach_grad()
    with autograd.record():
        prob = nd.Custom(x, lab, op_type="chip_smoke_softmax")
    prob.backward()
    out["custom"] = prob.asnumpy()
    out["custom_grad"] = x.grad.asnumpy()
    out["device"] = prob.context.type
    return out


def _p27_register_softmax():
    from mxnet_tpu_torch import nd, operator

    @operator.register("chip_smoke_softmax")
    class _Prop(operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def create_operator(self, ctx, shapes, dtypes):
            return _Softmax()

    class _Softmax(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], nd.softmax(in_data[0], axis=1))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            onehot = nd.one_hot(in_data[1], depth=out_data[0].shape[1])
            self.assign(in_grad[0], req[0], out_data[0] - onehot)


def phase_module_train():
    """Phase 27: training through Symbol, Executor and Module."""
    import os
    import shutil
    import tempfile
    import torch
    from mxnet_tpu_torch.io import bench
    t_phase = time.monotonic()
    print("phase 27: precision flags as found: cudnn.allow_tf32=%s "
          "matmul.allow_tf32=%s cudnn.benchmark=%s cudnn.deterministic=%s; "
          "host load average %s over %d cores"
          % (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic,
             "/".join("%.2f" % v for v in os.getloadavg()),
             os.cpu_count() or 0))
    for m in _hand_counters():
        m.reset_launch_counts()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p27_")
    try:
        rec, _ = bench.fixture_rec(P27_RECORDS, tmp)
        workers = min(8, os.cpu_count() or 1)
        mod, batch, prefix, fit = _p27_fit(tmp, rec, workers)
        _p27_reload(mod, batch, prefix, rec)
        steps = _p27_steps(mod, batch)
        del mod
        torch.cuda.empty_cache()
        _p27_parity()
        _p27_mnist(tmp)
        _p27_register_softmax()
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            card, host = _p27_small(P27_DEVICE), _p27_small("cpu")
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
        if card.pop("device").split(":")[0] != P27_DEVICE:
            raise RuntimeError("phase 27 (d): the CustomOp ran off the card")
        host.pop("device")
        worst = {k: float(np.abs(card[k] - host[k]).max()) for k in card}
        print("phase 27 (d): card vs CPU, TF32 off: %s (tol %g)"
              % (", ".join("%s %.3g" % kv for kv in worst.items()),
                 P27_SMALL_TOL))
        if max(worst.values()) > P27_SMALL_TOL:
            raise RuntimeError("phase 27 (d): %r" % worst)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launched = _hand_launches()
    if launched:
        raise RuntimeError("phase 27: hand kernels launched on the Module "
                           "path: %r" % launched)
    print("phase 27: B1-B10 launches 0 over the phase; fed %.1f images/s, "
          "step %.1f images/s; %.1f s (the script so far %.1f s)"
          % (fit["fed"], steps["images_s"], time.monotonic() - t_phase,
             time.monotonic() - T_START))


# -- slice 21: LSTM + CTC ----------------------------------------------------
P28_DEVICE = "cuda"
# card vs CPU, TF32 off, each difference over the larger of 1 and the
# array's largest magnitude (_p28_err).  In float64 the card equals the
# CPU within 1e-10: the same math.  In float32 the RNN and CTC are held
# at 1e-4, the reference's own torch check: cuDNN's f32 recurrence sits
# 0.7-2.9e-5 off a float64 run where the CPU's sits within 6.3e-7 (tanh /
# sigmoid modes; relu 3e-7 on both); the CUDA CTC's float32 log-space
# recursion at T 50 ~3e-5 (both printed)
P28_RNN_F32_TOL = P28_CTC_F32_TOL = 1e-4
P28_RNN_F64_TOL = 1e-10
P28_OP_SHAPE = (10, 4, 12, 16)          # T, B, input, hidden of (a)
P28_CTC_SHAPE = (50, 8, 29, 12)         # T, B, alphabet, label length of (b)
# (d): the tool's own flags at widths that make the card work; not a
# published configuration
P28_SPEECH = ["--num-hidden", "1024", "--feat-dim", "161", "--batch-size",
              "32", "--buckets", "200,400"]
P28_WARMUP, P28_TIMED, P28_PROFILED = 2, 10, 3
P28_GLUON_STEPS = 3
# kernel-name fragments -> category, first match wins (cuDNN's RNN kernels
# run their own GEMMs, which land under "gemm")
P28_CATEGORIES = (
    ("CTC", ("ctc",)),
    ("cuDNN RNN", ("rnn", "lstm", "persist", "cudnn")),
    ("gemm", ("gemm", "cutlass", "xmma", "sm90_")),
    ("copies (the flat-weight copies among them)", ("copy", "cat")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


@contextlib.contextmanager
def _p28_tf32_off():
    """cuDNN's and cuBLAS's TF32 off inside, restored after."""
    import torch
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _p28_err(got, want):
    """The largest difference over the larger of 1 and the largest
    magnitude (the op sweep's rule)."""
    return float(np.abs(got - want).max()
                 / max(1.0, float(np.abs(want).max())))


def _p28_rnn_run(device, arrays, kw, dtype=None):
    """Outputs and gradients (data, flat vector, states) of one RNN call
    under seeded cotangents, in float32 or ``dtype``."""
    import torch
    from mxnet_tpu_torch.ops import rnn
    dtype = dtype or torch.float32
    ts = [torch.tensor(a, device=device, dtype=dtype, requires_grad=True)
          for a in arrays]
    outs = rnn.rnn(*ts, state_outputs=True, **kw)
    rng = np.random.RandomState(1)
    cts = [torch.tensor(rng.randn(*o.shape), device=device, dtype=dtype)
           for o in outs]
    grads = torch.autograd.grad(outs, ts, cts)
    return [t.detach().cpu().double().numpy()
            for t in list(outs) + list(grads)]


def _p28_rnn_op():
    """(a): every mode x {1, 2} layers x {uni, bi}, and the clip route,
    card against CPU in float32 and float64, each beside a float64 CPU
    run."""
    import torch
    from mxnet_tpu_torch.ops import rnn
    T, B, I, H = P28_OP_SHAPE
    cases = [(m, L, bi, {}) for m in ("lstm", "gru", "rnn_tanh", "rnn_relu")
             for L in (1, 2) for bi in (False, True)]
    clip = dict(lstm_state_clip_min=-0.2, lstm_state_clip_max=0.2,
                lstm_state_clip_nan=True)
    cases += [("lstm", 1, False, clip), ("lstm", 2, True, clip)]
    worst = dict.fromkeys(("f32", "f64", "card_truth", "cpu_truth"), 0.0)
    fused = loop = 0
    with _p28_tf32_off():
        for mode, L, bi, extra in cases:
            rng = np.random.RandomState(L * 10 + bi)
            d = 2 if bi else 1
            n = rnn.rnn_param_size(H, I, L, mode, bi)
            arrays = [rng.randn(T, B, I).astype(np.float32) * 2,
                      (rng.randn(n) * 0.3).astype(np.float32),
                      (rng.randn(L * d, B, H) * 0.5).astype(np.float32)]
            if mode == "lstm":
                arrays.append((rng.randn(L * d, B, H) * 0.5).astype(
                    np.float32))
            kw = dict(state_size=H, num_layers=L, mode=mode,
                      bidirectional=bi, **extra)
            rnn.reset_launch_counts()
            card = _p28_rnn_run(P28_DEVICE, arrays, kw)
            counts = rnn.launch_counts()
            want = "loop" if extra else "fused"
            if counts[want] != 1 or sum(counts.values()) != 1:
                raise RuntimeError("phase 28 (a): %s L%d bi=%s took %r"
                                   % (mode, L, bi, counts))
            fused += counts["fused"]
            loop += counts["loop"]
            host = _p28_rnn_run("cpu", arrays, kw)
            truth = _p28_rnn_run("cpu", arrays, kw, torch.float64)
            card64 = _p28_rnn_run(P28_DEVICE, arrays, kw, torch.float64)
            for key, got, want in (("f32", card, host),
                                   ("f64", card64, truth),
                                   ("card_truth", card, truth),
                                   ("cpu_truth", host, truth)):
                worst[key] = max([worst[key]] + [
                    _p28_err(g, w) for g, w in zip(got, want)])
    print("phase 28 (a): RNN op, %d cases (4 modes x 1-2 layers x uni/bi, "
          "2 clip cases), card (cuDNN) vs CPU, TF32 off: outputs, final "
          "states and gradients of data, parameters and states within "
          "%.3g in float32 (tol %g) and %.3g in float64 (tol %g); against "
          "a float64 CPU run the card's float32 sits at %.3g, the CPU's at "
          "%.3g; routes fused %d, loop %d"
          % (len(cases), worst["f32"], P28_RNN_F32_TOL, worst["f64"],
             P28_RNN_F64_TOL, worst["card_truth"], worst["cpu_truth"],
             fused, loop))
    if worst["f32"] > P28_RNN_F32_TOL or worst["f64"] > P28_RNN_F64_TOL:
        raise RuntimeError("phase 28 (a): %r" % worst)


def _p28_ctc_run(device, x, lab, dl, ll, kw, dtype=None):
    import torch
    from mxnet_tpu_torch.ops import contrib
    d = torch.tensor(x, device=device, dtype=dtype or torch.float32,
                     requires_grad=True)
    args = [torch.tensor(a, device=device) if a is not None else None
            for a in (lab, dl, ll)]
    loss = contrib.ctc_loss(d, *args, **kw)
    (g,) = torch.autograd.grad(loss.sum(), d)
    return (loss.detach().cpu().double().numpy(),
            g.cpu().double().numpy())


def _p28_ctc():
    """(b): both blanks, lengths given and inferred, card against CPU;
    the CTC kernels the profile names."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    T, B, A, L = P28_CTC_SHAPE
    worst = dict.fromkeys(("f32", "f64", "card_truth", "cpu_truth"), 0.0)
    for blank in ("first", "last"):
        for given in (False, True):
            rng = np.random.RandomState(3)
            x = rng.randn(T, B, A).astype(np.float32)
            lo, hi = (1, A) if blank == "first" else (0, A - 1)
            lab = rng.randint(lo, hi, (B, L)).astype(np.float32)
            ll = rng.randint(1, L + 1, B).astype(np.float32)
            for b in range(B):
                lab[b, int(ll[b]):] = 0 if blank == "first" else -1
            dl = rng.randint(T // 2, T + 1, B).astype(np.float32)
            kw = dict(blank_label=blank, use_data_lengths=given,
                      use_label_lengths=given)
            args = (x, lab, dl if given else None, ll if given else None)
            card = _p28_ctc_run(P28_DEVICE, *args, kw)
            host = _p28_ctc_run("cpu", *args, kw)
            card64 = _p28_ctc_run(P28_DEVICE, *args, kw, torch.float64)
            truth = _p28_ctc_run("cpu", *args, kw, torch.float64)
            for key, got, want in (("f32", card, host),
                                   ("f64", card64, truth),
                                   ("card_truth", card, truth),
                                   ("cpu_truth", host, truth)):
                worst[key] = max(worst[key], _p28_err(got[0], want[0]),
                                 _p28_err(got[1], want[1]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(P28_PROFILED):
            _p28_ctc_run(P28_DEVICE, *args, kw)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and "ctc" in e.key.lower()})
    print("phase 28 (b): ctc_loss at T %d, batch %d, alphabet %d, labels "
          "%d, both blanks, lengths given and inferred, card vs CPU: "
          "losses and gradients of the activations within %.3g in float32 "
          "(tol %g) and %.3g in float64 (tol %g); against a float64 CPU run "
          "the card's float32 sits at %.3g, the CPU's at %.3g; the "
          "profile's CTC kernels: %s"
          % (T, B, A, L, worst["f32"], P28_CTC_F32_TOL, worst["f64"],
             P28_RNN_F64_TOL, worst["card_truth"], worst["cpu_truth"],
             "; ".join(_short_kernel(n) for n in names) or "none named"))
    if worst["f32"] > P28_CTC_F32_TOL or worst["f64"] > P28_RNN_F64_TOL:
        raise RuntimeError("phase 28 (b): %r" % worst)


def _p28_train_defaults():
    """(c): ``tools/train_ctc.main`` at its defaults on the card."""
    from mxnet_tpu_torch.ops import rnn
    from mxnet_tpu_torch.tools import train_ctc
    keys, buckets = [], []

    def seen(i, batch, mod):
        keys.append(batch.bucket_key)
        buckets[:] = sorted(mod._buckets)
    rnn.reset_launch_counts()
    t0 = time.perf_counter()
    losses = train_ctc.main([], batch_end_callback=seen)
    secs = time.perf_counter() - t0
    counts = rnn.launch_counts()
    by_key = {}
    for k, v in zip(keys, losses):
        by_key.setdefault(k, []).append(v)
    fell = {k: (np.mean(v[:5]), np.mean(v[-5:])) for k, v in by_key.items()}
    print("phase 28 (c): train_ctc.main() at its defaults (batch 16, 2 "
          "bi-LSTM layers of 64, 39 features, 28 symbols, buckets 40/80, "
          "Adam 2e-3, 60 batches): %.2f s; buckets bound %s; loss per key, "
          "first 5 -> last 5: %s; RNN routes %s"
          % (secs, buckets, ", ".join("%d: %.3f -> %.3f" % (k, a, b)
                                      for k, (a, b) in sorted(fell.items())),
             counts))
    if not np.isfinite(losses).all() or buckets != [40, 80] \
            or any(b >= a for a, b in fell.values()) \
            or counts["fused"] != len(losses):
        raise RuntimeError("phase 28 (c): losses %r, buckets %r, routes %r"
                           % (losses, buckets, counts))
    return secs


def _p28_speech():
    """(d): the same sym_gen at speech-sized widths, fixed-batch steps on
    the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.io import DataBatch, DataDesc
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.tools import train_ctc
    args = train_ctc.parse_args(P28_SPEECH)
    T = max(train_ctc.buckets_of(args))
    B, F = args.batch_size, args.feat_dim
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mod = train_ctc.make_module(args)
    gen = torch.Generator(device=P28_DEVICE).manual_seed(28)
    x = torch.randn(B, T, F, device=P28_DEVICE, generator=gen)
    lab = torch.randint(1, args.vocab, (B, train_ctc.MAX_LABEL),
                        device=P28_DEVICE, generator=gen).float()
    batch = DataBatch([NDArray(x)], [NDArray(lab)], bucket_key=T,
                      provide_data=[DataDesc("data", (B, T, F))],
                      provide_label=[DataDesc("label", tuple(lab.shape))])
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
          for _ in range(P28_WARMUP + P28_TIMED)]
    losses = []
    for i, e in enumerate(ev):
        if i == P28_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        e[0].record()
        mod.forward(batch, is_train=True)
        e[1].record()
        mod.backward()
        e[2].record()
        mod.update()
        e[3].record()
        losses.append(mod.get_outputs()[0]._data.mean())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    split = np.mean([[e[k].elapsed_time(e[k + 1]) for k in range(3)]
                     for e in ev[P28_WARMUP:]], axis=0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    utt = B * P28_TIMED / wall
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise RuntimeError("phase 28 (d): losses %r" % losses)

    def window(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(P28_PROFILED):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        return [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0], wall_us

    def fwd_bwd():
        mod.forward(batch, is_train=True)
        mod.backward()
    kernels, wall_us = window(fwd_bwd)
    upd, upd_wall_us = window(mod.update)
    busy = sum(e.self_device_time_total for e in kernels)
    upd_busy = sum(e.self_device_time_total for e in upd)
    # the copy cuDNN makes of the flat vector's views, alone
    from mxnet_tpu_torch.ops import rnn
    flat = mod._curr_module._exec.arg_dict["lstm_parameters"]._data
    views = [w for layer in rnn._unpack(flat, args.num_hidden, F, 2, "lstm",
                                        True) for dw in layer for w in dw]
    c0, c1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cat([w.reshape(-1) for w in views])
    c0.record()
    for _ in range(10):
        torch.cat([w.reshape(-1) for w in views])
    c1.record()
    torch.cuda.synchronize()
    copy_ms = c0.elapsed_time(c1) / 10
    step_ms = float(sum(split))
    if not kernels:
        cats = "the profiler recorded no device time; not measured"
        idle = step_idle = None
    else:
        acc = {}
        for e in kernels:
            c = _category(e.key, P28_CATEGORIES)
            acc[c] = acc.get(c, 0.0) + e.self_device_time_total
        acc["the update (its own window)"] = upd_busy
        cats = "; ".join("%s %.3f" % (c, us / P28_PROFILED / 1e3)
                         for c, us in sorted(acc.items(),
                                             key=lambda kv: -kv[1]))
        idle = 1 - (busy + upd_busy) / (wall_us + upd_wall_us)
        # the profiler's window runs slower than the step (its cost per
        # launch, ~6,000 launches a step): the busy time over the step's
        # CUDA-event time too
        step_idle = 1 - (busy + upd_busy) / P28_PROFILED / 1e3 / step_ms
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    ctc_names = sorted(_short_kernel(e.key) for e in kernels
                       if _category(e.key, P28_CATEGORIES) == "CTC")
    print("phase 28 (d): the tool's sym_gen at %s, bucket %d, fixed batch: "
          "%.1f utterances/s, %.0f frames/s over %d steps (host clock); ms "
          "a step between CUDA events forward %.3f / backward %.3f / update "
          "%.3f; device ms a step by category: %s; the flat-weight copy "
          "alone %.4f ms (%d views, %.1f MB); idle share %s over the "
          "profiler's window, %s of the step's CUDA-event time; peak %.2f "
          "GiB; losses %.3f -> %.3f; the CTC kernels there: %s"
          % (" ".join(P28_SPEECH), T, utt, utt * T, P28_TIMED, split[0],
             split[1], split[2], cats, copy_ms, len(views),
             flat.numel() * 4 / 1e6,
             "not measured" if idle is None else "%.4f" % idle,
             "not measured" if step_idle is None else "%.4f" % step_idle,
             peak, losses[0], losses[-1], "; ".join(ctc_names) or "none"))
    for e in top:
        print("phase 28 (d): kernel %9.3f ms a step x%-5d %s"
              % (e.self_device_time_total / P28_PROFILED / 1e3,
                 e.count // P28_PROFILED, e.key[:110]))
    del mod
    torch.cuda.empty_cache()
    return dict(utt_s=utt, frames_s=utt * T, fwd_ms=split[0],
                bwd_ms=split[1], upd_ms=split[2], idle=idle,
                step_idle=step_idle, peak_gib=peak)


def _p28_gluon_run(device):
    """Three Trainer steps of a bidirectional LSTM + Dense under CTCLoss
    from weights drawn on the host."""
    import mxnet_tpu_torch as mx
    rng = np.random.RandomState(4)
    x = rng.randn(8, 30, 20).astype(np.float32)
    lab = rng.randint(0, 10, (8, 6)).astype(np.float32)
    lab[::2, 4:] = -1
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.rnn.LSTM(32, num_layers=2, layout="NTC",
                                  bidirectional=True))
        net.add(mx.gluon.nn.Dense(11, flatten=False))
    net.initialize(mx.init.Xavier(), ctx=device,
                   rng=np.random.RandomState(5))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9})
    loss_fn = mx.gluon.loss.CTCLoss()
    losses = []
    for _ in range(P28_GLUON_STEPS):
        with mx.autograd.record():
            loss = loss_fn(net(mx.nd.array(x, ctx=device)),
                           mx.nd.array(lab, ctx=device))
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(loss.asnumpy())
    return losses, {k[len(net.prefix):]: p.data().asnumpy()
                    for k, p in net.collect_params().items()}


def _p28_cells(device):
    """``mx.rnn.FusedRNNCell`` and its unfused ``LSTMCell`` stack bound
    with the same weights: (fused outputs, unfused outputs)."""
    import mxnet_tpu_torch as mx
    B, T, I, H = 4, 12, 10, 24
    x = np.random.RandomState(6).randn(B, T, I).astype(np.float32)
    with mx.name.NameManager():
        cell = mx.rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                   prefix="f_")
        out, _ = cell.unroll(T, mx.sym.Variable("data"), layout="NTC")
    ex = out.simple_bind(device, data=x.shape)
    flat = (np.random.RandomState(7).randn(
        *ex.arg_dict["f_parameters"].shape) * 0.2).astype(np.float32)
    ex.copy_params_from({"f_parameters": mx.nd.array(flat, ctx="cpu")})
    fused = ex.forward(data=x)[0].asnumpy()
    stack = cell.unfuse()
    with mx.name.NameManager():
        sout, _ = stack.unroll(T, mx.sym.Variable("data"), layout="NTC",
                               merge_outputs=True)
    sex = sout.simple_bind(device, data=x.shape)
    sex.copy_params_from(cell.unpack_weights(
        {"f_parameters": mx.nd.array(flat, ctx="cpu")}))
    return fused, sex.forward(data=x)[0].asnumpy()


def _p28_gluon():
    """(e): the Gluon route and the unfused cells, card against CPU."""
    with _p28_tf32_off():
        card, host = _p28_gluon_run(P28_DEVICE), _p28_gluon_run("cpu")
        fused, unfused = _p28_cells(P28_DEVICE)
    w_loss = max(_p28_err(c, h) for c, h in zip(card[0], host[0]))
    w_par = max(_p28_err(card[1][k], v) for k, v in host[1].items())
    w_cell = _p28_err(unfused, fused)
    print("phase 28 (e): gluon.rnn.LSTM(32, 2 layers, bidirectional) + "
          "Dense under gluon.loss.CTCLoss, %d Trainer steps (SGD momentum), "
          "card vs CPU, TF32 off: losses %.3g, parameters %.3g; "
          "mx.rnn.LSTMCell stack (unfuse) vs FusedRNNCell on the card %.3g "
          "(tol %g: cuDNN's f32 recurrence, (a)); losses %s"
          % (P28_GLUON_STEPS, w_loss, w_par, w_cell, P28_RNN_F32_TOL,
             ["%.4f" % float(np.mean(v)) for v in card[0]]))
    if max(w_loss, w_par, w_cell) > P28_RNN_F32_TOL:
        raise RuntimeError("phase 28 (e): %r" % ((w_loss, w_par, w_cell),))


def phase_rnn_ctc():
    """Phase 28: LSTM + CTC."""
    import os
    import torch
    t_phase = time.monotonic()
    print("phase 28: precision flags as found: cudnn.allow_tf32=%s "
          "matmul.allow_tf32=%s cudnn.benchmark=%s cudnn.deterministic=%s; "
          "cuDNN %s; host load average %s"
          % (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.version(),
             "/".join("%.2f" % v for v in os.getloadavg())))
    for m in _hand_counters():
        m.reset_launch_counts()
    _p28_rnn_op()
    _p28_ctc()
    secs = _p28_train_defaults()
    speech = _p28_speech()
    _p28_gluon()
    launched = _hand_launches()
    if launched:
        raise RuntimeError("phase 28: hand kernels launched on the LSTM + "
                           "CTC path: %r" % launched)
    RUNS["phase 28"] = dict(speech, defaults_s=secs)
    print("phase 28: B1-B10 launches 0 over the phase; %.1f s (the script "
          "so far %.1f s)" % (time.monotonic() - t_phase,
                              time.monotonic() - T_START))


# -- slice 22: detection -----------------------------------------------------
P29_DEVICE = "cuda"
# card vs CPU, each difference over the larger of 1 and the array's
# largest magnitude (_p28_err); integer, index and keep outputs equal
P29_F32_TOL, P29_F64_TOL = 1e-5, 1e-10
P29_WARMUP, P29_TIMED, P29_PROFILED = 2, 10, 3
# SSD300 (MXNet example/ssd, symbol/symbol_factory.py, vgg16_reduced at
# 300): six source maps, their sizes, ratios and steps; 8,732 anchors
P29_SSD_MAPS = (38, 19, 10, 5, 3, 1)
P29_SSD_SIZES = ((.1, .141), (.2, .272), (.37, .447), (.54, .619),
                 (.71, .79), (.88, .961))
P29_SSD_RATIOS = ((1, 2, .5), (1, 2, .5, 3, 1. / 3), (1, 2, .5, 3, 1. / 3),
                  (1, 2, .5, 3, 1. / 3), (1, 2, .5), (1, 2, .5))
P29_SSD_STEPS = tuple(s / 300.0 for s in (8, 16, 32, 64, 100, 300))
P29_ANCHORS = 8732
# the training config's targets and the deploy config's detection
# (example/ssd/symbol/symbol_builder.py), VOC's 20 classes + background
P29_BATCH, P29_CLASSES, P29_MAX_OBJ = 32, 21, 20
P29_TARGET = dict(overlap_threshold=0.5, ignore_label=-1.0,
                  negative_mining_ratio=3.0, negative_mining_thresh=0.5,
                  minimum_negative_samples=0,
                  variances=(0.1, 0.1, 0.2, 0.2))
P29_DETECT = dict(nms_threshold=0.45, nms_topk=400, threshold=0.01,
                  force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2))
# Faster R-CNN's VGG16 test settings: a 600 x 1000 image at stride 16,
# 9 anchors a position (21,546)
P29_RPN_MAP = (38, 63)
P29_RPN = dict(rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
               threshold=0.7, rpn_min_size=16, scales=(8, 16, 32),
               ratios=(0.5, 1, 2), feature_stride=16)
P29_ROI_DATA = (1, 512, 38, 63)
# (b): the tool at batch 256 over 8 x 256 records
P29_SSD_BIG = 256
# (d): mx.random.seed of the RCNN run held to its asserts, and the seeds
# printed beside it (the reference's bars do not hold at every seed,
# ROADMAP.md C9)
P29_RCNN_SEED, P29_RCNN_SEEDS = 2, (0, 1)
# (e): detection records cycling the 16 JPEG fixtures (500 x 375)
P29_DET_RECORDS, P29_DET_BATCH, P29_DET_SIDE = 256, 32, 300
P29_CATEGORIES = (
    ("gemm / convolution", ("gemm", "conv", "cutlass", "xmma", "sm90_",
                            "implicit")),
    ("sort", ("sort", "radix")),
    ("copies", ("copy", "cat", "memcpy")),
    ("reduction", ("reduce",)),
    ("gather / scatter / index", ("gather", "scatter", "index")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _p29_ssd_anchors(device, dtype):
    """The six SSD300 maps' anchors, concatenated: (1, 8732, 4)."""
    import torch
    from mxnet_tpu_torch.ops import contrib
    outs = []
    for side, sizes, ratios, step in zip(P29_SSD_MAPS, P29_SSD_SIZES,
                                         P29_SSD_RATIOS, P29_SSD_STEPS):
        x = torch.empty((1, 1, side, side), device=device, dtype=dtype)
        outs.append(contrib.multibox_prior(x, sizes=sizes, ratios=ratios,
                                           steps=(step, step)))
    return torch.cat(outs, dim=1)


def _p29_inputs():
    """Seeded inputs of (a) as float64 numpy arrays (cast per run); the
    decoded rows ``box_nms`` takes and the IoU matrix
    ``bipartite_matching`` takes are made on the CPU in float64."""
    import torch
    from mxnet_tpu_torch.ops import contrib
    rng = np.random.RandomState(29)
    anc = _p29_ssd_anchors("cpu", torch.float64)
    assert anc.shape == (1, P29_ANCHORS, 4), anc.shape
    B, M = P29_BATCH, P29_MAX_OBJ
    lab = np.full((B, M, 5), -1.0)
    for b in range(B):
        for m in range(rng.randint(1, M + 1)):
            x0, y0 = rng.uniform(0, 0.8, 2)
            lab[b, m] = [rng.randint(P29_CLASSES - 1), x0, y0,
                         x0 + rng.uniform(0.05, 1 - x0),
                         y0 + rng.uniform(0.05, 1 - y0)]
    logits = rng.randn(B, P29_CLASSES, P29_ANCHORS) * 2
    prob = np.exp(logits - logits.max(1, keepdims=True))
    prob /= prob.sum(1, keepdims=True)
    loc = rng.randn(B, P29_ANCHORS * 4) * 0.5
    # MultiBoxDetection's rows before its NMS: [class, score, box], -1
    # at or under the threshold
    a = anc.numpy()[0]
    aw, ah = a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]
    l4 = loc.reshape(B, -1, 4)
    cx = l4[..., 0] * 0.1 * aw + (a[:, 0] + a[:, 2]) / 2
    cy = l4[..., 1] * 0.1 * ah + (a[:, 1] + a[:, 3]) / 2
    w, h = np.exp(l4[..., 2] * 0.2) * aw, np.exp(l4[..., 3] * 0.2) * ah
    rows = np.concatenate([
        prob[:, 1:].argmax(1)[..., None], prob[:, 1:].max(1)[..., None],
        np.clip(np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                         -1), 0, 1)], -1)
    rows[rows[..., 1] <= 0.01] = -1
    iou = contrib._box_iou_corner(anc.expand(B, -1, -1),
                                  torch.from_numpy(lab[..., 1:5])).numpy()
    H, W = P29_RPN_MAP
    A = len(P29_RPN["scales"]) * len(P29_RPN["ratios"])
    x1 = rng.uniform(0, 900, 300)
    y1 = rng.uniform(0, 500, 300)
    return dict(
        anc=anc.numpy(), lab=lab, cls_pred=logits, prob=prob, loc=loc,
        rows=rows, rows1=rows[:1], iou=iou,
        rpn_cls=rng.rand(2, 2 * A, H, W), rpn_box=rng.randn(2, 4 * A, H, W)
        * 0.2, info=np.array([[600, 1000, 1.0], [600, 1000, 1.0]]),
        feat=rng.randn(*P29_ROI_DATA),
        rois=np.stack([np.zeros(300), x1, y1, x1 + rng.uniform(16, 300, 300),
                       y1 + rng.uniform(16, 300, 300)], 1),
        roi_ct=rng.randn(300, P29_ROI_DATA[1], 7, 7))


def _p29_cases():
    """(name, fn(tensors) -> outputs, input keys, exact output indices,
    whether a decision sits downstream of exp) of (a)."""
    from mxnet_tpu_torch.ops import contrib
    return [
        ("MultiBoxPrior x6", lambda t: (_p29_ssd_anchors(
            t[0].device, t[0].dtype),), ["anc"], (), False),
        ("MultiBoxTarget", lambda t: contrib.multibox_target(
            *t, **P29_TARGET), ["anc", "lab", "cls_pred"], (1, 2), True),
        ("MultiBoxDetection", lambda t: (contrib.multibox_detection(
            *t, **P29_DETECT),), ["prob", "loc", "anc"], (0,), True),
        ("box_nms topk 400", lambda t: (contrib.box_nms(
            t[0], overlap_thresh=0.45, valid_thresh=0.01, topk=400,
            coord_start=2, score_index=1, id_index=0),), ["rows"], (0,),
         False),
        ("box_nms 8,732 rows (batch 1)", lambda t: (contrib.box_nms(
            t[0], overlap_thresh=0.45, valid_thresh=0.01, coord_start=2,
            score_index=1, id_index=0, force_suppress=True),), ["rows1"],
         (0,), False),
        ("bipartite_matching", lambda t: contrib.bipartite_matching(
            t[0], threshold=1e-12), ["iou"], (0, 1), False),
        ("Proposal", lambda t: contrib.proposal(
            t[0][:1], t[1][:1], t[2][:1], output_score=True, **P29_RPN),
         ["rpn_cls", "rpn_box", "info"], (0, 1), True),
        ("MultiProposal (batch 2)", lambda t: contrib.proposal(
            *t, output_score=True, **P29_RPN),
         ["rpn_cls", "rpn_box", "info"], (0, 1), True),
    ]


def _p29_images(name, outs):
    """Each output as (images, values): Proposal's rows regrouped by
    image, the rest batch-first as they are."""
    if name.startswith(("Proposal", "MultiProposal")):
        n = 1 if name.startswith("Proposal") else 2
        return [o.reshape(n, -1) for o in outs]
    return [o.reshape(o.shape[0], -1) for o in outs]


def _p29_exact(name, i, a):
    """The part of output ``i`` (as images) held equal: integer, index and
    keep values (a detection row's class and score, -1 where dropped; a
    roi's batch index; Proposal's scores are an input's values)."""
    if name.startswith(("MultiBoxDetection", "box_nms")):
        return a.reshape(a.shape[0], -1, 6)[..., :2]
    if name.startswith(("Proposal", "MultiProposal")) and i == 0:
        return a.reshape(a.shape[0], -1, 5)[..., 0]
    return a


def _p29_compare(name, exact_idx, card, host):
    """(images with a flipped decision, worst float difference over the
    others) of one op's outputs, card against CPU."""
    card, host = _p29_images(name, card), _p29_images(name, host)
    flipped = np.zeros(card[0].shape[0], bool)
    for i in exact_idx:
        c, h = _p29_exact(name, i, card[i]), _p29_exact(name, i, host[i])
        flipped |= (c != h).reshape(c.shape[0], -1).any(1)
    worst = 0.0
    for c, h in zip(card, host):
        c, h = c[~flipped], h[~flipped]
        if c.size:
            worst = max(worst, _p28_err(c, h))
    return np.nonzero(flipped)[0].tolist(), worst


def _p29_time(fn, *args):
    """(ms a call by CUDA events, kernel launches and copies a call by
    the profiler, host syncs a call by torch's sync debug mode)."""
    import warnings
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(P29_WARMUP):
        fn(*args)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(P29_TIMED):
        fn(*args)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / P29_TIMED
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(P29_PROFILED):
            fn(*args)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    copies = sum(e.count for e in ev if "memcpy" in e.key.lower()
                 or "memset" in e.key.lower())
    kernels = sum(e.count for e in ev) - copies
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # torch's message for each synchronizing call (its one-time notice
    # that the mode is a prototype is not one)
    syncs = [str(w.message) for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    return ms, kernels / P29_PROFILED, copies / P29_PROFILED, syncs


def _p29_ops():
    """(a): every op of the slice at the published sizes, card against
    CPU in float32 and float64, then timed on the card."""
    import torch
    from mxnet_tpu_torch.ops import contrib
    inp = _p29_inputs()

    def tensors(keys, device, dtype):
        return [torch.tensor(inp[k], device=device, dtype=dtype)
                for k in keys]
    rows = []
    with _p28_tf32_off():
        for name, fn, keys, exact, after_exp in _p29_cases():
            res = {}
            for dt in (torch.float32, torch.float64):
                got = {}
                for dev in (P29_DEVICE, "cpu"):
                    outs = fn(tensors(keys, dev, dt))
                    got[dev] = [o.detach().cpu().double().numpy()
                                for o in outs]
                res[dt] = _p29_compare(name, exact, got[P29_DEVICE],
                                       got["cpu"])
            (flip32, err32), (flip64, err64) = res[torch.float32], \
                res[torch.float64]
            args = tensors(keys, P29_DEVICE, torch.float32)
            contrib.reset_host_sync_counts()
            ms, kernels, copies, msgs = _p29_time(fn, args)
            syncs = len(msgs)
            counted = sum(contrib.host_sync_counts().values()) / (
                P29_WARMUP + P29_TIMED + P29_PROFILED + 1)
            if syncs > counted:
                print("phase 29 (a): %s: a sync besides the NMS's: %s"
                      % (name, msgs[0][:300].replace("\n", " ")))
            rows.append(dict(op=name, ms=ms, kernels=kernels, copies=copies,
                             syncs=syncs, nms_syncs=counted,
                             flips32=len(flip32), flips64=len(flip64),
                             err32=err32, err64=err64))
            print("phase 29 (a): %-27s %9.4f ms a call; %6.1f kernels, "
                  "%4.1f copies, %d host syncs a call (sync debug mode; "
                  "the NMS counter %.1f); card vs CPU: f32 %.3g over the "
                  "images with no flip, %d image(s) with a flipped "
                  "decision; f64 %.3g, %d flipped"
                  % (name, ms, kernels, copies, syncs, counted, err32,
                     len(flip32), err64, len(flip64)))
            if flip64 or err64 > P29_F64_TOL or err32 > P29_F32_TOL \
                    or (flip32 and not after_exp):
                raise RuntimeError("phase 29 (a): %s: f32 flips %r (%.3g), "
                                   "f64 flips %r (%.3g)"
                                   % (name, flip32, err32, flip64, err64))
        rows.append(_p29_roi_align(inp))
    return rows


def _p29_roi_align(inp):
    """(a): ROIAlign forward and backward, both ``aligned`` values."""
    import torch
    from mxnet_tpu_torch.ops import contrib
    worst = {}
    for aligned in (False, True):
        kw = dict(pooled_size=(7, 7), spatial_scale=1.0 / 16,
                  sample_ratio=2, aligned=aligned)
        for dt in (torch.float32, torch.float64):
            got = []
            for dev in (P29_DEVICE, "cpu"):
                d = torch.tensor(inp["feat"], device=dev, dtype=dt,
                                 requires_grad=True)
                r = torch.tensor(inp["rois"], device=dev, dtype=dt)
                out = contrib.roi_align(d, r, **kw)
                (g,) = torch.autograd.grad(
                    out, d, torch.tensor(inp["roi_ct"], device=dev,
                                         dtype=dt))
                got.append([out.detach().cpu().double().numpy(),
                            g.cpu().double().numpy()])
            key = "f32" if dt == torch.float32 else "f64"
            worst[key] = max([worst.get(key, 0.0)] + [
                _p28_err(c, h) for c, h in zip(*got)])
    d = torch.tensor(inp["feat"], device=P29_DEVICE, dtype=torch.float32,
                     requires_grad=True)
    r = torch.tensor(inp["rois"], device=P29_DEVICE, dtype=torch.float32)
    ct = torch.tensor(inp["roi_ct"], device=P29_DEVICE, dtype=torch.float32)
    kw = dict(pooled_size=(7, 7), spatial_scale=1.0 / 16, sample_ratio=2)
    fwd = _p29_time(lambda: contrib.roi_align(d, r, **kw))
    out = contrib.roi_align(d, r, **kw)
    bwd = _p29_time(lambda: torch.autograd.grad(out, d, ct,
                                                retain_graph=True))
    print("phase 29 (a): ROIAlign 300 rois over %s, 7 x 7, sample_ratio 2: "
          "forward %.4f ms (%.1f kernels), backward %.4f ms (%.1f kernels), "
          "%d / %d host syncs; card vs CPU, both aligned values, outputs "
          "and data gradients: f32 %.3g, f64 %.3g"
          % (P29_ROI_DATA, fwd[0], fwd[1], bwd[0], bwd[1], len(fwd[3]),
             len(bwd[3]), worst["f32"], worst["f64"]))
    if worst["f32"] > P29_F32_TOL or worst["f64"] > P29_F64_TOL:
        raise RuntimeError("phase 29 (a): ROIAlign %r" % worst)
    return dict(op="ROIAlign", ms=fwd[0], bwd_ms=bwd[0], kernels=fwd[1],
                bwd_kernels=bwd[1], syncs=len(fwd[3]) + len(bwd[3]),
                err32=worst["f32"], err64=worst["f64"])


def _p29_ctx():
    """The tools' flags for P29_DEVICE: none on the card (their default),
    ``--ctx cpu`` in a rehearsal on the host."""
    return [] if P29_DEVICE == "cuda" else ["--ctx", "cpu"]


def _p29_ssd_defaults():
    """(b): ``tools/train_ssd.main()`` at its defaults on the card."""
    from mxnet_tpu_torch.ops import contrib
    from mxnet_tpu_torch.tools import train_ssd
    contrib.reset_host_sync_counts()
    t0 = time.perf_counter()
    losses, kept = train_ssd.main(_p29_ctx())
    secs = time.perf_counter() - t0
    print("phase 29 (b): train_ssd.main() at its defaults (BASELINE config "
          "4: batch 16, 2 classes, 80 batches, SGD lr 0.05 momentum 0.9, "
          "jpeg %s): %.2f s; loss %.4f at step 0 -> %.4f at step %d (mean "
          "of the last 10 %.4f); %d detections kept on the inference "
          "batch's image 0; NMS host syncs %r"
          % (train_ssd.jpeg_encoder(), secs, losses[0], losses[-1],
             len(losses) - 1, float(np.mean(losses[-10:])), len(kept),
             contrib.host_sync_counts()))
    if not np.isfinite(losses).all() or not np.mean(losses[-10:]) \
            < losses[0]:
        raise RuntimeError("phase 29 (b): losses %r" % losses)
    return secs, losses


def _p29_ssd_big(tmp):
    """(b): the tool's step at batch 256, fed from a .rec of 8 x 256
    records through ImageDetRecordIter: images/s, the stage split between
    CUDA events, the idle share and peak memory."""
    import os
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.context import use
    from mxnet_tpu_torch.tools import train_ssd
    args = train_ssd.parse_args(["--batch-size", str(P29_SSD_BIG)]
                                + _p29_ctx())
    rec, idx = train_ssd.pack_det_records(
        os.path.join(tmp, "ssd"), P29_SSD_BIG * 8, args.num_classes,
        np.random.RandomState(0), train_ssd.jpeg_encoder())
    stages = ("forward", "target", "loss", "backward", "update")
    steps = P29_WARMUP + P29_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with use(P29_DEVICE):
        it = train_ssd.make_iter(rec, idx, P29_SSD_BIG)
        ex, updater = train_ssd.bind(args, torch.device(P29_DEVICE))
        gen = train_ssd.batches(it, P29_SSD_BIG)
        ev = []
        losses = []
        for i in range(steps):
            if i == P29_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            x, y = next(gen)
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(len(stages) + 1)]
            marks[0].record()
            seen = iter(marks[1:])
            losses.append(train_ssd.train_step(
                ex, updater, x, y, marks=lambda s: next(seen).record()))
            ev.append(marks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        split = np.mean([[m[k].elapsed_time(m[k + 1])
                          for k in range(len(stages))]
                         for m in ev[P29_WARMUP:]], axis=0)
        fed = P29_SSD_BIG * P29_TIMED / wall
        # the device's idle share over fed steps, and the step alone on
        # one batch already on the host
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(P29_PROFILED):
                x, y = next(gen)
                train_ssd.train_step(ex, updater, x, y)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t1) * 1e6
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in kernels)
        x, y = next(gen)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for _ in range(P29_TIMED):
            train_ssd.train_step(ex, updater, x, y)
        torch.cuda.synchronize()
        alone = P29_SSD_BIG * P29_TIMED / (time.perf_counter() - t2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    acc = {}
    for e in kernels:
        c = _category(e.key, P29_CATEGORIES)
        acc[c] = acc.get(c, 0.0) + e.self_device_time_total
    cats = "; ".join("%s %.3f" % (c, us / P29_PROFILED / 1e3) for c, us in
                     sorted(acc.items(), key=lambda kv: -kv[1])) \
        or "the profiler recorded no device time; not measured"
    idle = 1 - busy / wall_us if kernels else None
    print("phase 29 (b): the tool's step at batch %d over %d records "
          "(ImageDetRecordIter, shuffle + mirror, decoded in its prefetch "
          "thread): %.1f images/s fed over %d steps (host clock), %.1f "
          "images/s on one batch already decoded; ms a step between CUDA "
          "events %s; device ms a step by category %s; idle share %s over "
          "%d fed steps; peak %.3f GiB; losses %.4f -> %.4f"
          % (P29_SSD_BIG, P29_SSD_BIG * 8, fed, P29_TIMED, alone,
             " / ".join("%s %.3f" % (s, v) for s, v in zip(stages, split)),
             cats, "not measured" if idle is None else "%.4f" % idle,
             P29_PROFILED, peak, losses[0], losses[-1]))
    if not np.isfinite(losses).all():
        raise RuntimeError("phase 29 (b): losses %r" % losses)
    return dict(fed=fed, alone=alone, split=dict(zip(stages, split)),
                idle=idle, peak=peak)


def _p29_ssd_parity():
    """(c): one SSD step from the same bound weights, card against CPU,
    TF32 off: outputs, MultiBoxTarget on the same inputs, gradients
    against the CPU's rounding floor (weights one ulp up)."""
    import torch
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ops import contrib
    from mxnet_tpu_torch.tools import train_ssd
    args = train_ssd.parse_args(["--batch-size", "8"])
    rng = np.random.RandomState(5)
    x = rng.rand(8, 3, train_ssd.SIDE, train_ssd.SIDE).astype(np.float32)
    lab = np.full((8, 2, 5), -1.0, np.float32)
    for b in range(8):
        for m in range(1 + b % 2):
            x0, y0 = rng.uniform(0.05, 0.5, 2)
            lab[b, m] = [rng.randint(2), x0, y0, x0 + 0.3, y0 + 0.3]
    cpu_ex, _ = train_ssd.bind(args, torch.device("cpu"))
    w = {n: (rng.randn(*a.shape) * 0.1).astype(np.float32)
         for n, a in cpu_ex.arg_dict.items() if n != "data"}
    up = {n: np.nextafter(v, np.float32(np.inf)) for n, v in w.items()}

    def run(device, weights, targets=None):
        ex, _ = train_ssd.bind(args, torch.device(device))
        for n, v in weights.items():
            ex.arg_dict[n][:] = v
        anc, cp, lp = ex.forward(is_train=True, data=x)
        if targets is None:
            targets = [t._data for t in nd.contrib.MultiBoxTarget(
                anc, nd.array(lab, ctx=device), cp, negative_mining_ratio=3.0)]
        cpt = cp._data.detach().requires_grad_()
        lpt = lp._data.detach().requires_grad_()
        tg = [t.to(device) for t in targets]
        loss = train_ssd.ssd_loss(cpt, lpt, *tg)
        gc, gl = torch.autograd.grad(loss, (cpt, lpt))
        ex.backward(out_grads=[nd.zeros(anc.shape, ctx=device),
                               nd.NDArray(gc), nd.NDArray(gl)])
        return ([o.asnumpy() for o in (anc, cp, lp)], targets,
                {n: ex.grad_dict[n].asnumpy() for n in weights})

    with _p28_tf32_off():
        out_c, tg_c, g_c = run("cpu", w)
        out_g, _, g_g = run(P29_DEVICE, w, tg_c)
        _, _, g_u = run("cpu", up, tg_c)
        # MultiBoxTarget on the CPU's outputs, on both devices
        on_card = contrib.multibox_target(
            *[torch.tensor(a, device=P29_DEVICE) for a in
              (out_c[0], lab, out_c[1])], negative_mining_ratio=3.0)
    d_out = max(_p28_err(a, b) for a, b in zip(out_g, out_c))
    on_card = [t.cpu().numpy() for t in on_card]
    tg_c = [t.numpy() for t in tg_c]
    # loc_mask and cls_target equal; loc_target (a log and divisions)
    # within the float rule of (a)
    flips = [int((a != b).sum()) for a, b in zip(on_card, tg_c)]
    d_loc = _p28_err(on_card[0], tg_c[0])
    d_g = max((float(np.abs(g_g[n] - g_c[n]).max()), n) for n in g_c)
    d_u = max((float(np.abs(g_u[n] - g_c[n]).max()), n) for n in g_c)
    print("phase 29 (c): one SSD step at batch 8, TF32 off: executor "
          "outputs card vs CPU %.3g (tol %g); MultiBoxTarget on the same "
          "inputs: entries differing (loc_target, loc_mask, cls_target) "
          "%s, loc_target within %.3g (tol %g); gradients %.3g (%s) "
          "against the rounding floor %.3g (%s: the CPU run from weights "
          "one ulp up), allowed %g x floor"
          % (d_out, P27_OUT_TOL, flips, d_loc, P29_F32_TOL, d_g[0], d_g[1],
             d_u[0], d_u[1], NOISE_FACTOR))
    if d_out > P27_OUT_TOL or any(flips[1:]) or d_loc > P29_F32_TOL or \
            d_g[0] > max(NOISE_FACTOR * d_u[0], P27_OUT_TOL):
        raise RuntimeError("phase 29 (c): outputs %.3g, target flips %r "
                           "(loc %.3g), gradients %r vs floor %r"
                           % (d_out, flips, d_loc, d_g, d_u))


def _p29_rcnn():
    """(d): ``tools/train_rcnn_lite.main()`` at its defaults on the card,
    its own asserts; the seeds of C9 beside it."""
    import contextlib
    import io as _io
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.tools import train_rcnn_lite
    mx.random.seed(P29_RCNN_SEED)
    t0 = time.perf_counter()
    losses, acc, recall = train_rcnn_lite.main(_p29_ctx())
    secs = time.perf_counter() - t0
    others = []
    for seed in P29_RCNN_SEEDS:
        mx.random.seed(seed)
        buf = _io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                train_rcnn_lite.main(_p29_ctx())
            ok = "passes"
        except AssertionError:
            ok = "fails"
        line = [ln for ln in buf.getvalue().splitlines()
                if "head accuracy" in ln][0]
        others.append("seed %d: %s (%s)" % (seed, line.split(": ", 1)[1],
                                             ok))
    print("phase 29 (d): train_rcnn_lite.main() at its defaults (60 steps, "
          "batch 8, Adam 2e-3) after mx.random.seed(%d): %.2f s; loss %.4f "
          "-> %.4f; head accuracy %.3f (bar 0.8), proposal recall@0.3 %.3f "
          "(bar 0.5); the other seeds: %s"
          % (P29_RCNN_SEED, secs, losses[0], losses[-1], acc, recall,
             "; ".join(others)))
    return secs


def _p29_det_records(tmp):
    """(rec, idx) of P29_DET_RECORDS detection records cycling the JPEG
    fixtures, 1-5 seeded boxes each."""
    import os
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.io import bench
    jpegs = bench.fixture_jpegs()
    rng = np.random.RandomState(7)
    rec, idx = os.path.join(tmp, "det.rec"), os.path.join(tmp, "det.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(P29_DET_RECORDS):
        label = [2.0, 5.0]
        for _ in range(rng.randint(1, 6)):
            x0, y0 = rng.uniform(0, 0.7, 2)
            label += [float(rng.randint(20)), x0, y0,
                      x0 + rng.uniform(0.1, 0.3), y0 + rng.uniform(0.1, 0.3)]
        w.write_idx(i, recordio.pack(recordio.IRHeader(
            len(label), np.asarray(label, np.float32), i, 0),
            jpegs[i % len(jpegs)]))
    w.close()
    return rec, idx


def _p29_iter(tmp):
    """(e): ImageDetRecordIter on the host: batches/s over an epoch; the
    first batch bitwise an in-process ImageDetIter's from the same seed;
    labels padded with -1 to the estimated shape."""
    import random
    from mxnet_tpu_torch import io
    from mxnet_tpu_torch.image.detection import ImageDetIter
    rec, idx = _p29_det_records(tmp)
    kw = dict(path_imgrec=rec, path_imgidx=idx, batch_size=P29_DET_BATCH,
              data_shape=(3, P29_DET_SIDE, P29_DET_SIDE), shuffle=True,
              rand_crop=0.5, rand_mirror=True)
    random.seed(29)
    t0 = time.perf_counter()
    it = io.ImageDetRecordIter(**kw)
    first = it.next()
    n = 1
    for _ in it:
        n += 1
    rate = n / (time.perf_counter() - t0)
    random.seed(29)
    want = ImageDetIter(**kw).next()
    same = all(np.array_equal(a.asnumpy(), b.asnumpy()) for a, b in
               ((first.data[0], want.data[0]), (first.label[0],
                                                want.label[0])))
    lab = first.label[0].asnumpy()
    shape = it.provide_label[0].shape
    # each image's objects (kept, or ejected by the crop: class -1) first,
    # then rows of -1 to the estimated shape
    pad = (lab == -1).all(-1)
    padded = bool(pad.any() and all(
        not pad[i, np.argmax(pad[i]):].size or pad[i, np.argmax(pad[i]):]
        .all() for i in range(lab.shape[0]) if pad[i].any()))
    print("phase 29 (e): ImageDetRecordIter over %d records (the 16 JPEG "
          "fixtures, 500 x 375, 1-5 boxes), batch %d at %d^2, shuffle, "
          "rand_crop 0.5, rand_mirror: %.2f batches/s (%.1f images/s) over "
          "%d batches, decoded in its prefetch thread; first batch bitwise "
          "an in-process ImageDetIter's from the same seed: %s; labels %s, "
          "padding rows all -1: %s"
          % (P29_DET_RECORDS, P29_DET_BATCH, P29_DET_SIDE, rate,
             rate * P29_DET_BATCH, n, same, shape, padded))
    if not same or not padded or tuple(lab.shape) != tuple(shape) \
            or shape[1:] != (5, 5):
        raise RuntimeError("phase 29 (e): same %s, padded %s, label shape "
                           "%r / %r" % (same, padded, lab.shape, shape))
    return rate


def phase_detection():
    """Phase 29: detection."""
    import shutil
    import tempfile
    t_phase = time.monotonic()
    try:
        import PIL  # noqa: F401
        pil = "present"
    except ImportError:
        pil = "missing: (b) packs with recordio.pack_img (OpenCV)"
    print("phase 29: PIL on this host %s" % pil)
    for m in _hand_counters():
        m.reset_launch_counts()
    rows = _p29_ops()
    secs, _ = _p29_ssd_defaults()
    tmp = tempfile.mkdtemp(prefix="p29_")
    try:
        big = _p29_ssd_big(tmp)
        _p29_ssd_parity()
        rcnn = _p29_rcnn()
        rate = _p29_iter(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launched = _hand_launches()
    if launched:
        raise RuntimeError("phase 29: hand kernels launched on the "
                           "detection path: %r" % launched)
    RUNS["phase 29"] = dict(ops=rows, ssd_defaults_s=secs, ssd_big=big,
                            rcnn_s=rcnn, det_iter_batches_s=rate)
    print("phase 29: B1-B10 launches 0 over the phase; %.1f s (the script "
          "so far %.1f s)" % (time.monotonic() - t_phase,
                              time.monotonic() - T_START))



# -- slice 23: sparse storage ------------------------------------------------
P30_DEVICE = "cuda"
# card vs CPU, each difference over the larger of 1 and the array's
# largest magnitude (_p28_err); indices, indptr, nnz and masks equal
P30_F32_TOL, P30_F64_TOL = 1e-5, 1e-10
P30_WEIGHT_TOL, P30_GLUON_TOL = 1e-6, 1e-5
# MXNet example/sparse/linear_classification on LibSVM's avazu-app
# (train.py's defaults): 1,000,001 features, batch 8,192; 15 nonzeros a
# row (122,880 a batch)
P30_FEATURES, P30_BATCH, P30_NNZ = 1000001, 8192, 15
P30_WIDE = 64                  # the second rhs width of (a)'s dot
P30_CSR_SLICE = (1024, 65536)  # (a)'s dense -> csr cast
P30_BATCHES = 32               # (b) at Avazu's width
P30_WARMUP, P30_PROFILED = 2, 3
# MovieLens-10M's id ranges and MXNet example/sparse/
# matrix_factorization's rank 128; 200 batches of 256 synthetic ratings
P30_USERS, P30_ITEMS, P30_RANK = 71569, 65135, 128
P30_MF_BATCHES, P30_MF_BATCH = 200, 256
# host syncs a call the reference has too: the data-dependent sizes
P30_SYNCS = {"cast_storage row_sparse": 1, "cast_storage csr": 1,
             "add_rsp": 1}
P30_CATEGORIES = (
    ("sort / scan", ("sort", "radix", "scan")),
    ("gather / scatter / index", ("gather", "scatter", "index")),
    ("copies", ("copy", "cat", "memcpy")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _p30_ctx():
    """The tools' flags for P30_DEVICE (none on the card, their
    default)."""
    return [] if P30_DEVICE == "cuda" else ["--ctx", "cpu"]


def _p30_csr_host(rows, features, nnz, seed):
    """(values f64, column indices, indptr) of a seeded CSR batch with
    ``nnz`` sorted, distinct columns a row."""
    rng = np.random.RandomState(seed)
    cols = np.sort(rng.randint(0, features - nnz + 1, (rows, nnz)), 1) \
        + np.arange(nnz)
    return (rng.randn(rows * nnz), cols.reshape(-1),
            np.arange(rows + 1, dtype=np.int64) * nnz)


def _p30_syncs(fn, device=None):
    """(fn's result, torch's messages for each synchronizing call in
    it) on ``device`` (P30_DEVICE by default)."""
    import warnings
    import torch
    if (device or P30_DEVICE) != "cuda":
        return fn(), []
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message) for w in caught
                 if "synchronizing CUDA operation" in str(w.message)]


def _p30_inputs():
    """(a)'s seeded inputs as numpy: the batch, the rhs of each dot, two
    error vectors, the batch's unique rows, the dense slice."""
    vals, cols, indptr = _p30_csr_host(P30_BATCH, P30_FEATURES, P30_NNZ, 30)
    rng = np.random.RandomState(31)
    m, n = P30_CSR_SLICE
    sl = np.zeros((m, n))
    r = np.repeat(np.arange(m), P30_NNZ)
    c, v = cols[:m * P30_NNZ], vals[:m * P30_NNZ]
    sl[r[c < n], c[c < n]] = v[c < n]
    return dict(vals=vals, cols=cols, indptr=indptr,
                w1=rng.randn(P30_FEATURES, 1) * 0.1,
                w64=rng.randn(P30_FEATURES, P30_WIDE) * 0.1,
                e1=rng.randn(P30_BATCH, 1) * 1e-3,
                e64=rng.randn(P30_BATCH, P30_WIDE) * 1e-3,
                e2=rng.randn(P30_BATCH, 1) * 1e-3,
                rows=np.unique(cols), slice=sl)


def _p30_arrays(inp, dev, dtype):
    """(a)'s arrays on ``dev`` in ``dtype``, and the gradients the later
    ops take."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ndarray import sparse

    def a(x, dt=dtype):
        return nd.array(x, ctx=dev, dtype=dt)
    t = {k: a(inp[k]) for k in ("w1", "w64", "e1", "e64", "e2", "slice")}
    t["x"] = sparse.CSRNDArray(a(inp["vals"]), a(inp["cols"], "int64"),
                               a(inp["indptr"], "int64"),
                               (P30_BATCH, P30_FEATURES))
    t["rows"] = a(inp["rows"], "int64")
    t["g1"] = sparse.dot(t["x"], t["e1"], transpose_a=True)
    t["g2"] = sparse.dot(t["x"], t["e2"], transpose_a=True)
    t["rsp"] = sparse.retain(sparse.cast_storage(t["g1"], "row_sparse"),
                             t["rows"])
    t["rsp2"] = sparse.retain(sparse.cast_storage(t["g2"], "row_sparse"),
                              t["rows"])
    return t


def _p30_update(name, kw):
    """make(arrays) -> run: ``run()`` applies one row-sparse update of
    optimizer ``name`` to a copy of w1 and its states (made once) and
    returns [weight, states...]."""
    from mxnet_tpu_torch import optimizer

    def make(t):
        opt = optimizer.create(name, **kw)
        w = t["w1"]._data.clone()
        state = opt.create_state(0, w)
        states = [s for s in (state if isinstance(state, tuple)
                              else (state,)) if s is not None]

        def run():
            opt.update(0, w, t["rsp"], state)
            return [w] + states
        return run
    return make


def _p30_cases():
    """(name, make(arrays) -> run, indices of the outputs held equal) of
    (a); ``run()`` returns the op's outputs (tensors or NDArrays), its
    inputs made by ``make``."""
    from mxnet_tpu_torch.ndarray import sparse
    from mxnet_tpu_torch.ops import registry

    def parts(s):
        return [s.indices, s.data] if s.stype == "row_sparse" \
            else [s.indices, s.indptr, s.data]

    def retain(t):
        c1 = sparse.cast_storage(t["g1"], "row_sparse")
        return lambda: parts(sparse.retain(c1, t["rows"]))
    cast0 = registry.get("cast_storage").fn
    retain0 = registry.get("_sparse_retain").fn
    adagrad0 = registry.get("_sparse_adagrad_update").fn
    return [
        ("dot (1,000,001 x 1)", lambda t: lambda: [
            sparse.dot(t["x"], t["w1"])], ()),
        ("dot (1,000,001 x 64)", lambda t: lambda: [
            sparse.dot(t["x"], t["w64"])], ()),
        ("dot^T (8,192 x 1)", lambda t: lambda: [sparse.dot(
            t["x"], t["e1"], transpose_a=True)], ()),
        ("dot^T (8,192 x 64)", lambda t: lambda: [sparse.dot(
            t["x"], t["e64"], transpose_a=True)], ()),
        ("cast_storage row_sparse", lambda t: lambda: parts(
            sparse.cast_storage(t["g1"], "row_sparse")), (0,)),
        ("cast_storage csr", lambda t: lambda: parts(
            sparse.cast_storage(t["slice"], "csr")), (0, 1)),
        ("retain", retain, (0,)),
        ("add_rsp", lambda t: lambda: parts(t["rsp"] + t["rsp2"]), (0,)),
        ("sgd (row_sparse)", _p30_update("sgd", dict(learning_rate=0.1)),
         ()),
        ("sgd momentum (row_sparse)", _p30_update("sgd", dict(
            learning_rate=0.1, momentum=0.9, wd=1e-4)), ()),
        ("adam (row_sparse)", _p30_update("adam", dict(
            learning_rate=0.01, rescale_grad=0.5)), ()),
        ("adagrad (row_sparse)", _p30_update("adagrad", dict(
            learning_rate=0.1, wd=1e-4)), ()),
        ("_sparse_adagrad_update", lambda t: (
            lambda h: lambda: list(adagrad0(t["w1"]._data, t["g1"]._data,
                                            h, lr=0.1, wd=1e-4)))(
            t["w1"]._data.abs()), ()),
        ("cast_storage op (capacity 0)", lambda t: lambda: list(cast0(
            t["g1"]._data, stype="row_sparse")), (1, 2)),
        ("_sparse_retain op", lambda t: lambda: list(retain0(
            t["rsp"].data._data, t["rsp"].indices._data,
            t["rows"]._data)), (1,)),
    ]


def _p30_host(o):
    import torch
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().double().numpy()
    return o.asnumpy().astype(np.float64)


def _p30_library(t):
    """torch.sparse.mm on the same CSR: ms a call of each dot of (a) (the
    transposed ones through the CSR's transpose, or its COO form where
    that is refused), beside the largest difference from the port's."""
    import torch
    from mxnet_tpu_torch.ndarray import sparse
    x = t["x"]
    csr = torch.sparse_csr_tensor(x.indptr._data, x.indices._data,
                                  x.data._data, x.shape)
    coo_t = csr.to_sparse_coo().t().coalesce()
    out = {}
    for name, rhs, trans in (("dot (1,000,001 x 1)", "w1", False),
                             ("dot (1,000,001 x 64)", "w64", False),
                             ("dot^T (8,192 x 1)", "e1", True),
                             ("dot^T (8,192 x 64)", "e64", True)):
        r = t[rhs]._data
        form = "csr"
        try:
            fn = (lambda: torch.sparse.mm(csr.t(), r)) if trans \
                else (lambda: torch.sparse.mm(csr, r))
            got = fn()
        except (RuntimeError, NotImplementedError):
            form = "coo^T"
            fn = lambda: torch.sparse.mm(coo_t, r)  # noqa: E731
            got = fn()
        want = sparse.dot(x, t[rhs], transpose_a=trans)._data
        err = _p28_err(_p30_host(got), _p30_host(want))
        out[name] = (_p29_time(fn)[0], form, err)
    return out


def _p30_ops():
    """(a): every op of the slice at Avazu's shapes, card against CPU in
    float32 and float64, then timed on the card."""
    inp = _p30_inputs()
    cases = _p30_cases()
    worst = {}
    with _p28_tf32_off():
        for dt, tol in ((np.float32, P30_F32_TOL), (np.float64, P30_F64_TOL)):
            arrs = {dev: _p30_arrays(inp, dev, dt)
                    for dev in (P30_DEVICE, "cpu")}
            for name, make, exact in cases:
                card = [_p30_host(o) for o in make(arrs[P30_DEVICE])()]
                host = [_p30_host(o) for o in make(arrs["cpu"])()]
                bad = [i for i in exact
                       if not np.array_equal(card[i], host[i])]
                err = max([_p28_err(c, h) for i, (c, h) in
                           enumerate(zip(card, host)) if i not in exact]
                          + [0.0])
                worst.setdefault(name, {})[dt] = err
                if bad or err > tol:
                    raise RuntimeError("phase 30 (a): %s (%s): outputs %r "
                                       "differ, float error %.3g"
                                       % (name, np.dtype(dt).name, bad,
                                          err))
            if dt == np.float32:
                t32 = arrs[P30_DEVICE]
            del arrs
    lib = _p30_library(t32)
    rows, over = [], []
    for name, make, exact in cases:
        ms, kernels, copies, msgs = _p29_time(make(t32))
        allowed = P30_SYNCS.get(name, 0)
        if len(msgs) > allowed:
            over.append((name, len(msgs), msgs[0][:200]))
        row = dict(op=name, ms=ms, kernels=kernels, copies=copies,
                   syncs=len(msgs), err32=worst[name][np.float32],
                   err64=worst[name][np.float64])
        libtxt = ""
        if name in lib:
            row["library_ms"], form, lerr = lib[name]
            libtxt = "; torch.sparse.mm (%s) %.4f ms, %.3g from the port's" \
                % (form, row["library_ms"], lerr)
        rows.append(row)
        print("phase 30 (a): %-29s %9.4f ms a call; %6.1f kernels, %4.1f "
              "copies, %d host syncs a call (allowed %d); card vs CPU f32 "
              "%.3g, f64 %.3g%s"
              % (name, ms, kernels, copies, len(msgs), allowed,
                 row["err32"], row["err64"], libtxt))
    if over:
        raise RuntimeError("phase 30 (a): host syncs beyond the "
                           "reference's: %r" % over)
    return rows


def _p30_linear_defaults():
    """(b): ``tools/train_sparse_linear.main()`` at its defaults on the
    card, the example's assert inside."""
    from mxnet_tpu_torch.tools import train_sparse_linear
    t0 = time.perf_counter()
    acc, probs, weight = train_sparse_linear.main(_p30_ctx())
    secs = time.perf_counter() - t0
    print("phase 30 (b): train_sparse_linear.main() at its defaults "
          "(BASELINE config 5: 1,000 features, 20 nonzeros a row, 100 "
          "batches of 64, SGD lr 1.0 in the store): %.2f s; running "
          "accuracy %.3f (the example's bar 0.7); %d weights moved"
          % (secs, acc, int(np.count_nonzero(weight))))
    return secs, acc


def _p30_write_libsvm(path, rows, features, nnz, seed):
    """The example's LibSVM data (a planted linear rule, ``%.5f``
    values) at ``rows`` x ``features``, drawn in bulk from ``seed``: the
    example's writer permutes all the features once a row."""
    vals, cols, _ = _p30_csr_host(rows, features, nnz, seed)
    w_true = np.random.RandomState(seed + 1).randn(features) \
        .astype(np.float32)
    vals = vals.astype(np.float32).reshape(rows, nnz)
    cols = cols.reshape(rows, nnz)
    table = np.empty((rows, 1 + 2 * nnz))
    table[:, 0] = (w_true[cols] * vals).sum(1) > 0
    table[:, 1::2] = cols
    table[:, 2::2] = vals
    np.savetxt(path, table, fmt="%g" + " %d:%.5f" * nnz)


def _p30_cycle(it):
    while True:
        for batch in it:
            yield batch
        it.reset()


def _p30_linear_wide(tmp):
    """(b): the tool's step at Avazu's width: 32 batches of 8,192 rows
    from a LibSVM file; samples/s, the parse, the step's parts between
    CUDA events, host syncs a step, the idle share, peak memory."""
    import os
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import io, nd
    from mxnet_tpu_torch.context import use
    from mxnet_tpu_torch.tools import train_sparse_linear as tsl
    path = os.path.join(tmp, "avazu_width.libsvm")
    t0 = time.perf_counter()
    _p30_write_libsvm(path, P30_BATCH * P30_BATCHES, P30_FEATURES, P30_NNZ,
                      34)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    it = io.LibSVMIter(data_libsvm=path, data_shape=(P30_FEATURES,),
                       batch_size=P30_BATCH)
    parse_s = time.perf_counter() - t0
    gen = _p30_cycle(it)
    parts = tsl.STEP_PARTS
    timed = P30_BATCHES - P30_WARMUP
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with use(P30_DEVICE) as dev:
        kv = tsl.make_store("local", P30_FEATURES, 1.0)
        w_local = nd.zeros((P30_FEATURES, 1))
        ev, correct, assembly = [], 0, []
        for i in range(P30_BATCHES):
            if i == P30_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            t_batch = time.perf_counter()
            batch = next(gen)
            assembly.append(time.perf_counter() - t_batch)
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(len(parts) + 1)]
            marks[0].record()
            seen = iter(marks[1:])
            p, y = tsl.train_step(kv, w_local, batch, dev,
                                  marks=lambda part: next(seen).record())
            if i >= P30_WARMUP:
                correct += int(((p > 0.5) == (y > 0.5)).sum())
            ev.append(marks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        split = np.mean([[m[k].elapsed_time(m[k + 1])
                          for k in range(len(parts))]
                         for m in ev[P30_WARMUP:]], axis=0)
        _, msgs = _p30_syncs(lambda: tsl.train_step(kv, w_local, next(gen),
                                                    dev))
        # the host's share of "to device": the batch's unique rows, then
        # the CSR's three copies to the card (host clock)
        x_host = next(gen).data[0]
        t1 = time.perf_counter()
        np.unique(x_host.indices.asnumpy())
        unique_ms = 1e3 * (time.perf_counter() - t1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x_host.as_in_context(dev)
        torch.cuda.synchronize()
        copy_ms = 1e3 * (time.perf_counter() - t1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(P30_PROFILED):
                tsl.train_step(kv, w_local, next(gen), dev)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t1) * 1e6
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    busy = sum(e.self_device_time_total for e in kernels)
    acc = {}
    for e in kernels:
        c = _category(e.key, P30_CATEGORIES)
        acc[c] = acc.get(c, 0.0) + e.self_device_time_total
    cats = "; ".join("%s %.3f" % (c, us / P30_PROFILED / 1e3) for c, us in
                     sorted(acc.items(), key=lambda kv: -kv[1])) \
        or "the profiler recorded no device time; not measured"
    idle = 1 - busy / wall_us if kernels else None
    rate = P30_BATCH * timed / wall
    where = {}
    for m in msgs:
        key = m.split("\n")[0][:80]
        where[key] = where.get(key, 0) + 1
    print("phase 30 (b): the tool's step at Avazu's width (%d x %d, %d "
          "nonzeros a row): file written in %.2f s (%d rows, vectorised, "
          "from the seed), LibSVMIter's parse %.2f s; %.1f samples/s over "
          "%d steps (host clock, the host's batch assembly included); the "
          "iterator's batch assembly %.3f ms a step (host clock); ms a "
          "step between CUDA events %s (to device: the batch's np.unique "
          "%.3f ms, the CSR's copy %.3f ms, host clock); host syncs a step "
          "%d; device ms a "
          "step by category %s; idle share %s over %d steps; peak %.3f GiB; "
          "running accuracy %.3f over the timed steps"
          % (P30_BATCH, P30_FEATURES, P30_NNZ, write_s, P30_BATCH *
             P30_BATCHES, parse_s, rate, timed,
             1e3 * float(np.mean(assembly[P30_WARMUP:])),
             " / ".join("%s %.3f" % (s, v) for s, v in zip(parts, split)),
             unique_ms, copy_ms, len(msgs), cats,
             "not measured" if idle is None else "%.4f" % idle,
             P30_PROFILED, peak,
             correct / (P30_BATCH * timed)))
    print("phase 30 (b): where a step syncs: %r" % where)
    return dict(rate=rate, parse_s=parse_s, write_s=write_s,
                assembly_ms=1e3 * float(np.mean(assembly[P30_WARMUP:])),
                unique_ms=unique_ms, copy_ms=copy_ms,
                split=dict(zip(parts, split)), syncs=len(msgs), idle=idle,
                peak=peak)


def _p30_linear_parity():
    """(c): one step at Avazu's width from the same weights, card against
    CPU: scores, the row-sparse gradient, the weight after the update."""
    from mxnet_tpu_torch import kvstore, nd, optimizer
    from mxnet_tpu_torch.context import use
    from mxnet_tpu_torch.io import DataBatch
    from mxnet_tpu_torch.ndarray import sparse
    from mxnet_tpu_torch.tools import train_sparse_linear as tsl
    vals, cols, indptr = _p30_csr_host(P30_BATCH, P30_FEATURES, P30_NNZ, 32)
    rng = np.random.RandomState(33)
    w0 = (rng.randn(P30_FEATURES, 1) * 0.1).astype(np.float32)
    y = (rng.rand(P30_BATCH) > 0.5).astype(np.float32)
    rows = np.unique(cols)
    batch = DataBatch([sparse.CSRNDArray(
        nd.array(vals, ctx="cpu"), nd.array(cols, ctx="cpu", dtype="int64"),
        nd.array(indptr, ctx="cpu", dtype="int64"),
        (P30_BATCH, P30_FEATURES))], [nd.array(y, ctx="cpu")])
    got = {}
    with _p28_tf32_off():
        for dev in (P30_DEVICE, "cpu"):
            with use(dev) as d:
                x = batch.data[0].as_in_context(d)
                score = sparse.dot(x, nd.array(w0)).asnumpy()[:, 0]
                p = 1.0 / (1.0 + np.exp(-score))
                err = ((p - y) / len(y)).astype(np.float32)[:, None]
                grad = sparse.retain(sparse.cast_storage(sparse.dot(
                    x, nd.array(err), transpose_a=True), "row_sparse"),
                    nd.array(rows, dtype="int64"))
                kv = kvstore.create("local")
                kv.init("weight", nd.array(w0))
                kv.set_optimizer(optimizer.create("sgd", learning_rate=1.0))
                p2, _ = tsl.train_step(kv, nd.zeros((P30_FEATURES, 1)),
                                       batch, d)
                weight = nd.zeros((P30_FEATURES, 1))
                kv.pull("weight", out=weight)
                got[dev] = (score, grad.indices.asnumpy(),
                            grad.data.asnumpy(), p2, weight.asnumpy())
    c, h = got[P30_DEVICE], got["cpu"]
    d_score = _p28_err(c[0], h[0])
    same_idx = np.array_equal(c[1], h[1])
    d_grad = _p28_err(c[2], h[2])
    d_p = _p28_err(c[3], h[3])
    d_w = _p28_err(c[4], h[4])
    moved = int((h[4] != w0).sum())
    print("phase 30 (c): one step at Avazu's width from the same weights, "
          "card vs CPU: scores %.3g (tol %g), the row-sparse gradient's %d "
          "indices equal %s, its values %.3g (tol %g), the step's "
          "probabilities %.3g, the weight after the update %.3g (tol %g; "
          "%d weights moved)"
          % (d_score, P30_F32_TOL, len(c[1]), same_idx, d_grad, P30_F32_TOL,
             d_p, d_w, P30_WEIGHT_TOL, moved))
    if d_score > P30_F32_TOL or not same_idx or d_grad > P30_F32_TOL or \
            d_p > P30_F32_TOL or d_w > P30_WEIGHT_TOL or not moved:
        raise RuntimeError("phase 30 (c): scores %.3g, indices %s, gradient "
                           "%.3g, p %.3g, weight %.3g"
                           % (d_score, same_idx, d_grad, d_p, d_w))


def _p30_gluon_tools():
    """(d): ``tools/train_wide_deep.main()`` and ``tools/matrix_fact.main()``
    at their defaults, their asserts inside."""
    from mxnet_tpu_torch.tools import matrix_fact, train_wide_deep
    t0 = time.perf_counter()
    acc, losses = train_wide_deep.main(_p30_ctx())
    wd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mses = matrix_fact.main(_p30_ctx())
    mf_s = time.perf_counter() - t0
    print("phase 30 (d): train_wide_deep.main() at its defaults (4 fields "
          "of 50 ids, 120 batches of 64, Adam 0.01): %.2f s, loss %.4f -> "
          "%.4f, running accuracy %.3f (bar 0.75); matrix_fact.main() at "
          "its defaults (200 users, 150 items, rank 8, 12 epochs of 32 "
          "batches, Adam 0.02): %.2f s, mse %.4f -> %.4f (bar 0.3x)"
          % (wd_s, losses[0], losses[-1], acc, mf_s, mses[0], mses[-1]))
    return wd_s, mf_s


def _p30_mf_wide():
    """(d): matrix factorization at MovieLens-10M's id ranges: samples/s
    and the Adam update's ms a step."""
    import torch
    from mxnet_tpu_torch import autograd, gluon, init, nd
    from mxnet_tpu_torch.context import use
    from mxnet_tpu_torch.tools import matrix_fact
    n = P30_MF_BATCHES * P30_MF_BATCH
    users, items, ratings = matrix_fact.synthetic_ratings(
        P30_USERS, P30_ITEMS, P30_RANK, n, np.random.RandomState(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with use(P30_DEVICE):
        net = matrix_fact.MFBlock(P30_USERS, P30_ITEMS, P30_RANK)
        net.initialize(init.Normal(0.05), rng=np.random.RandomState(1))
        net.hybridize()
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.02})
        loss_fn = gluon.loss.L2Loss()
        # the ratings go to the card once; each batch is a slice there
        u_all = nd.array(users.astype(np.float32))
        i_all = nd.array(items.astype(np.float32))
        r_all = nd.array(ratings)
        losses, upd = [], []
        for s in range(P30_MF_BATCHES):
            if s == P30_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            sel = slice(s * P30_MF_BATCH, (s + 1) * P30_MF_BATCH)
            with autograd.record():
                loss = loss_fn(net(u_all[sel], i_all[sel]), r_all[sel])
            loss.backward()
            e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            e[0].record()
            trainer.step(P30_MF_BATCH)
            e[1].record()
            upd.append(e)
            losses.append(loss.mean())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rate = P30_MF_BATCH * (P30_MF_BATCHES - P30_WARMUP) / wall
    upd_ms = float(np.mean([a.elapsed_time(b) for a, b in
                            upd[P30_WARMUP:]]))
    first = 2 * float(losses[0].asscalar())
    last = 2 * float(np.mean([v.asscalar() for v in losses[-10:]]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # each user is in under one rating here: the example's recipe
    # overfits (the error is printed, not held)
    print("phase 30 (d): matrix factorization at MovieLens-10M's id ranges "
          "(%d users, %d items, rank %d; MXNet example/sparse/"
          "matrix_factorization), %d batches of %d synthetic ratings, Adam "
          "0.02: %.1f samples/s over %d steps (host clock); the Adam "
          "update %.3f ms a step (CUDA events, %d parameters: both tables "
          "and biases, dense); mse %.4f at the first batch -> %.4f (the "
          "last 10); peak %.3f GiB"
          % (P30_USERS, P30_ITEMS, P30_RANK, P30_MF_BATCHES, P30_MF_BATCH,
             rate, P30_MF_BATCHES - P30_WARMUP, upd_ms,
             (P30_USERS + P30_ITEMS) * (P30_RANK + 1), first, last, peak))
    if not np.isfinite([first, last]).all():
        raise RuntimeError("phase 30 (d): mse %r -> %r" % (first, last))
    return dict(rate=rate, update_ms=upd_ms, peak=peak)


def _p30_embeddings():
    """(e): ``Embedding(sparse_grad=True)`` and ``SparseEmbedding``, one
    step each, card against CPU: outputs, the dense gradients, the
    updated weights."""
    from mxnet_tpu_torch import autograd, gluon, init, nd
    from mxnet_tpu_torch.context import use
    rng = np.random.RandomState(35)
    x = rng.randint(0, 1000, (64, 8)).astype(np.float32)
    head = rng.randn(64, 8, 32).astype(np.float32)
    worst = {}
    for kind, make in (
            ("Embedding(sparse_grad=True)",
             lambda: gluon.nn.Embedding(1000, 32, sparse_grad=True)),
            ("contrib.nn.SparseEmbedding",
             lambda: gluon.contrib.nn.SparseEmbedding(1000, 32))):
        got = {}
        for dev in (P30_DEVICE, "cpu"):
            with use(dev) as d:
                blk = make()
                blk.initialize(init.Uniform(0.5), ctx=d,
                               rng=np.random.RandomState(36))
                tr = gluon.Trainer(blk.collect_params(), "sgd",
                                   {"learning_rate": 0.5})
                with autograd.record():
                    out = blk(nd.array(x))
                    loss = (out * nd.array(head)).sum()
                loss.backward()
                grad = blk.weight.grad().asnumpy().copy()
                tr.step(1)
                got[dev] = (out.asnumpy(), grad, blk.weight.data().asnumpy())
        worst[kind] = max(_p28_err(c, h) for c, h in zip(got[P30_DEVICE],
                                                         got["cpu"]))
    print("phase 30 (e): one step card vs CPU (64 x 8 ids over 1,000 x 32): "
          "outputs, dense gradients and updated weights within %s (tol %g)"
          % ("; ".join("%s %.3g" % kv for kv in worst.items()),
             P30_GLUON_TOL))
    if max(worst.values()) > P30_GLUON_TOL:
        raise RuntimeError("phase 30 (e): %r" % worst)


def phase_sparse():
    """Phase 30: sparse storage."""
    import shutil
    import tempfile
    t_phase = time.monotonic()
    for m in _hand_counters():
        m.reset_launch_counts()
    rows = _p30_ops()
    defaults_s, acc = _p30_linear_defaults()
    tmp = tempfile.mkdtemp(prefix="p30_")
    try:
        wide = _p30_linear_wide(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _p30_linear_parity()
    tools_s = _p30_gluon_tools()
    mf = _p30_mf_wide()
    _p30_embeddings()
    launched = _hand_launches()
    if launched:
        raise RuntimeError("phase 30: hand kernels launched on the sparse "
                           "path: %r" % launched)
    RUNS["phase 30"] = dict(ops=rows, linear_defaults_s=defaults_s,
                            linear_wide=wide, gluon_tools_s=tools_s, mf=mf)
    print("phase 30: B1-B10 launches 0 over the phase; %.1f s (the script "
          "so far %.1f s)" % (time.monotonic() - t_phase,
                              time.monotonic() - T_START))


# -- slice 24: the rest of the op set and contrib/ ---------------------------
P31_DEVICE = "cuda"
# card vs CPU, each difference over the larger of 1 and the array's
# largest magnitude (_p28_err): float64 within 1e-10; float32 elementwise
# ops within 1e-6, and reductions, GEMMs and factorizations within
# P31_FLOOR_FACTOR times the float32 rounding floor the phase measures (the
# CPU's float32 result against its float64 one) where that is above
# 1e-6; integer outputs, histogram counts and determinant signs equal
P31_F64_TOL, P31_F32_TOL, P31_FLOOR_FACTOR = 1e-10, 1e-6, 10
# (a): a batch of 16 matrices of 1,024 x 1,024 (cut from 32 for the
# script's time limit); the card computes all 16
# and the CPU the first P31_HELD of them, against which the card's first
# P31_HELD are held (each matrix's outputs and gradients are its own)
P31_LINALG, P31_HELD = (16, 1024), 2
# compact bilinear pooling (Gao et al., CVPR 2016): VGG-16 conv5_3's 512
# channels at 28 x 28 for a batch of 32 (25,088 rows), sketched to 8,192
P31_CBP = (25088, 512, 8192)
# the reference's op-sweep shapes with their batch axis at 256
P31_BATCH = 256
# host syncs a call beyond none: torch.linalg.eigh reads cuSOLVER's status
# back (torch has no eigh without that check)
P31_SYNCS = {"syevd": 1}
# a timed window of about this many seconds, 2 to 10 calls
P31_TIME_S = 0.2
# (b): the widths of upstream MXNet's MNIST stacked autoencoder
# (example/autoencoder/mnist_sae.py: 784-500-500-2000-10), the KL penalty
# on the 10-wide code, batch 256 of synthetic pixels
P31_SAE = dict(hidden=(500, 500, 2000), code=10, dim=784)
P31_SAE_BATCH, P31_SAE_WARMUP, P31_SAE_STEPS, P31_SAE_PROFILED = \
    256, 5, 50, 10
# (c): Deformable R-FCN (Dai et al., ICCV 2017), ResNet-101 on a 600 x 1000
# image: res5's 3 x 3 deformable convolution 512 -> 512 (dilation 2, pad 2)
# on the 38 x 63 map, 300 RoIs, 21 classes and 8 box outputs at 7 x 7 bins
P31_RFCN_MAP, P31_RFCN_IMAGE = (38, 63), (600, 1000)
P31_RFCN_CH, P31_RFCN_ROIS, P31_RFCN_P = 512, 300, 7
P31_RFCN_CLASSES, P31_RFCN_BOX = 21, 8
# (d): phase 28 (d)'s widths (frames, batch, features, hidden) and its
# tolerances (cuDNN's f32 recurrence sits up to 2.9e-5 off)
P31_LSTM = (200, 32, 161, 1024)
# (e): GloVe 6B-300d's width, the vocabulary cut for the write's time;
# the corpus the Vocabulary counts, and the Gluon lookup's batch
P31_GLOVE, P31_CORPUS, P31_LOOKUP = (100000, 300), 200000, 4096
P31_FIT = (4096, 784, 256)   # DataLoaderIter -> Module.fit: rows, width, batch
# the 21 contrib names of the slice (the linalg, control-flow and image
# names are those their modules register)
P31_CONTRIB = (
    "AdaptiveAvgPooling2D", "BilinearResize2D", "DeformableConvolution",
    "DeformablePSROIPooling", "IdentityAttachKLSparseReg", "PSROIPooling",
    "_contrib_AdaptiveAvgPooling2D", "_contrib_BilinearResize2D",
    "_contrib_DeformableConvolution", "_contrib_DeformablePSROIPooling",
    "_contrib_PSROIPooling", "_contrib_count_sketch",
    "_contrib_div_sqrt_dim", "_contrib_fft", "_contrib_ifft",
    "_contrib_quadratic", "count_sketch", "fft", "ifft", "khatri_rao",
    "quadratic")


class _P31Case:
    """One op on seeded inputs: ``make(inp)`` -> numpy inputs (floats in
    float64, cast per run), ``diff`` the inputs differentiated, ``exact``
    the outputs held equal, ``elem`` an elementwise op (float32 within
    1e-6), ``sign`` "gelqf" / "syevd" for rows unique up to sign."""

    def __init__(self, label, name, make, params=None, diff=(), exact=(),
                 elem=False, sign=None, dtypes=(np.float32, np.float64),
                 held=None):
        self.label, self.name, self.make = label, name, make
        self.params = params or {}
        self.diff, self.exact, self.elem = diff, exact, elem
        self.sign, self.dtypes, self.held = sign, dtypes, held


def _p31_linalg_inputs():
    """(a)'s matrices: SPD S = G G^T / n + I, its Cholesky factor, an SPD
    Q diag(1 .. 5) Q^T with its eigenvalues evenly spaced (an
    eigenvector, and the gradient through it, moves by eps / gap: a
    Wishart's smallest gaps near 1e-4 at n = 1,024 leave two correct
    float64 eigensolvers 1e-10 apart), a near-identity M = I + G / (2
    sqrt n) (|det| near 1: finite in float32), Gaussians and a batch of
    vectors."""
    import torch
    b, n = P31_LINALG
    rng = np.random.RandomState(310)
    g = rng.randn(b, n, n) / np.sqrt(n)
    tg = torch.from_numpy(g)
    spd = (tg @ tg.transpose(-1, -2) + torch.eye(n, dtype=tg.dtype))
    q = torch.linalg.qr(torch.from_numpy(rng.randn(b, n, n)))[0]
    eig = (q * torch.linspace(1.0, 5.0, n, dtype=q.dtype)) \
        @ q.transpose(-1, -2)
    return dict(spd=spd.numpy(), chol=torch.linalg.cholesky(spd).numpy(),
                eig=((eig + eig.transpose(-1, -2)) / 2).numpy(),
                m=np.eye(n) + 0.5 * rng.randn(b, n, n) / np.sqrt(n),
                g=g, g2=rng.randn(b, n, n) / np.sqrt(n),
                g3=rng.randn(b, n, n), v=rng.randn(b, n))


def _p31_rois(rng, n, batch, side_h, side_w):
    x1 = rng.uniform(0, side_w * 0.7, n)
    y1 = rng.uniform(0, side_h * 0.7, n)
    w = rng.uniform(side_w * 0.05, side_w * 0.3, n)
    h = rng.uniform(side_h * 0.05, side_h * 0.3, n)
    bidx = rng.randint(0, batch, n) if batch > 1 else np.zeros(n)
    return np.stack([bidx, x1, y1, x1 + w, y1 + h], 1)


def _p31_cases():
    """(a): every op of the slice at real sizes."""
    B = P31_BATCH
    rows, cin, sk = P31_CBP
    lin = {}

    def L(key):
        def make(_):
            if not lin:
                lin.update(_p31_linalg_inputs())
            return [lin[k] for k in key.split(",")]
        return make

    def R(*shapes, seed=311, pos=False):
        def make(_):
            rng = np.random.RandomState(seed)
            return [rng.rand(*s) if pos else rng.randn(*s) for s in shapes]
        return make
    rng = np.random.RandomState(312)
    sketch_h = rng.randint(0, sk, cin).astype(np.float64)
    sketch_s = rng.choice([-1.0, 1.0], cin)
    edges = np.array([0.0, 0.2, 0.5, 0.9, 1.0])
    hist = np.random.RandomState(313).rand(B, 20)
    hist[:, :3] = [0.5, 0.9, 1.0]          # values on the edges
    cases = [
        _P31Case("gemm", "_linalg_gemm", L("g,g2,g3"),
                 dict(alpha=2.0, beta=0.5), diff=(0, 1, 2)),
        _P31Case("gemm2 (B^T)", "_linalg_gemm2", L("g,g2"),
                 dict(transpose_b=True, alpha=0.5), diff=(0, 1)),
        _P31Case("potrf", "_linalg_potrf", L("spd"), diff=(0,)),
        _P31Case("potri", "_linalg_potri", L("chol"), diff=(0,)),
        _P31Case("trmm", "_linalg_trmm", L("chol,g2"), dict(alpha=2.0),
                 diff=(0, 1)),
        _P31Case("trsm", "_linalg_trsm", L("chol,g3"), diff=(0, 1)),
        _P31Case("trsm (right, A^T)", "_linalg_trsm", L("chol,g3"),
                 dict(rightside=True, transpose=True), diff=(0, 1)),
        _P31Case("sumlogdiag", "_linalg_sumlogdiag", L("spd"), diff=(0,)),
        _P31Case("extractdiag", "_linalg_extractdiag", L("g"),
                 dict(offset=1), diff=(0,), elem=True),
        _P31Case("makediag", "_linalg_makediag", L("v"), dict(offset=-1),
                 diff=(0,), elem=True),
        _P31Case("extracttrian", "_linalg_extracttrian", L("g"), diff=(0,),
                 elem=True),
        _P31Case("syrk", "_linalg_syrk", L("g"), dict(alpha=1.5),
                 diff=(0,)),
        _P31Case("gelqf", "_linalg_gelqf", L("m"), diff=(0,), sign="gelqf"),
        _P31Case("syevd", "_linalg_syevd", L("eig"), diff=(0,),
                 sign="syevd"),
        _P31Case("inverse", "_linalg_inverse", L("m"), diff=(0,)),
        _P31Case("det", "_linalg_det", L("m"), diff=(0,)),
        _P31Case("slogdet", "_linalg_slogdet", L("m"), diff=(0,),
                 exact=(0,)),
        _P31Case("count_sketch (CBP)", "_contrib_count_sketch",
                 lambda _: [np.random.RandomState(314).randn(rows, cin),
                            sketch_h, sketch_s], dict(out_dim=sk),
                 diff=(0, 2)),
        _P31Case("fft (CBP)", "_contrib_fft", R((rows, sk), seed=315),
                 diff=(0,)),
        _P31Case("ifft (CBP)", "_contrib_ifft", R((rows, 2 * sk), seed=316),
                 diff=(0,)),
        _P31Case("AdaptiveAvgPooling2D", "_contrib_AdaptiveAvgPooling2D",
                 R((B, 2, 6, 6)), dict(output_size=3), diff=(0,)),
        _P31Case("BilinearResize2D (up)", "_contrib_BilinearResize2D",
                 R((B, 2, 4, 4)), dict(height=8, width=8), diff=(0,)),
        _P31Case("BilinearResize2D (down)", "_contrib_BilinearResize2D",
                 R((B, 2, 17, 23)), dict(height=9, width=11), diff=(0,)),
        _P31Case("khatri_rao", "khatri_rao", R((B, 3), (4, 3)),
                 diff=(0, 1), elem=True),
        _P31Case("DeformableConvolution", "_contrib_DeformableConvolution",
                 lambda _: (lambda r: [r.randn(B, 4, 9, 9),
                                       r.randn(B, 18, 7, 7) * 0.7,
                                       r.randn(6, 4, 3, 3), r.randn(6)])(
                     np.random.RandomState(317)),
                 dict(kernel=(3, 3), num_filter=6), diff=(0, 1, 2, 3)),
        _P31Case("DeformablePSROIPooling", "_contrib_DeformablePSROIPooling",
                 lambda _: (lambda r: [r.randn(B, 18, 12, 14),
                                       _p31_rois(r, B, B, 48, 56),
                                       r.randn(B, 2, 3, 3)])(
                     np.random.RandomState(318)),
                 dict(spatial_scale=0.25, output_dim=2, group_size=3,
                      pooled_size=3, part_size=3, sample_per_part=2,
                      trans_std=0.1), diff=(0, 2)),
        _P31Case("PSROIPooling", "_contrib_PSROIPooling",
                 lambda _: [np.random.RandomState(319).randn(B, 8, 8, 8),
                            np.stack([np.arange(B), np.zeros(B),
                                      np.zeros(B), np.full(B, 7.0),
                                      np.full(B, 7.0)], 1)],
                 dict(spatial_scale=1.0, output_dim=2, pooled_size=2),
                 diff=(0,)),
        _P31Case("div_sqrt_dim", "_contrib_div_sqrt_dim", R((B, 16)),
                 diff=(0,), elem=True),
        _P31Case("quadratic", "_contrib_quadratic", R((B, 4)),
                 dict(a=1.0, b=2.0, c=3.0), diff=(0,), elem=True),
        _P31Case("IdentityAttachKLSparseReg", "IdentityAttachKLSparseReg",
                 R((B, 3), pos=True), diff=(0,)),
        _P31Case("histogram (range)", "_histogram", lambda _: [hist],
                 dict(bin_cnt=5, range=(0.0, 1.2)), exact=(0,)),
        _P31Case("histogram (edges)", "_histogram",
                 lambda _: [hist, edges], exact=(0,)),
        _P31Case("histogram (data range)", "_histogram", R((B, 20)),
                 dict(bin_cnt=7), exact=(0,)),
        _P31Case("square_sum", "square_sum", R((B, 4)), dict(axis=1),
                 diff=(0,)),
        _P31Case("_image_to_tensor", "_image_to_tensor",
                 lambda _: [np.random.RandomState(320).randint(
                     0, 256, (B, 4, 5, 3)).astype(np.uint8)], elem=True,
                 dtypes=(np.float32,)),
        _P31Case("_image_normalize", "_image_normalize", R((B, 3, 4, 5)),
                 dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)),
                 diff=(0,), elem=True),
    ]
    for c in cases:
        if c.name.startswith("_linalg_"):
            c.held = P31_HELD
        elif c.name in ("_contrib_fft", "_contrib_ifft"):
            c.held = rows // 32       # 1 of the batch's 32 images
    return cases


def _p31_new_names():
    """Every name the slice registers: the linalg, control-flow and image
    modules' and the 21 contrib names."""
    from mxnet_tpu_torch.ops import registry
    mods = {"mxnet_tpu_torch.ops.linalg", "mxnet_tpu_torch.ops.control_flow",
            "mxnet_tpu_torch.ops.image_ops"}
    return sorted({n for n in registry.list_ops()
                   if registry.get(n).fn.__module__ in mods}
                  | set(P31_CONTRIB))


def _p31_ct(shape, k, held):
    """A seeded cotangent for an output of ``shape``: where the case's
    rows are held in part (``held``), one item's broadcast over the rows;
    else full for matrices and smaller arrays, one row broadcast over a
    wide 2-D output."""
    if held:
        tail = shape[1:]
    else:
        tail = shape[-2:] if len(shape) >= 3 or np.prod(shape) <= 1 << 24 \
            else shape[-1:]
    return np.random.RandomState(330 + k).randn(*tail) if tail else \
        np.float64(np.random.RandomState(330 + k).randn())


def _p31_run(case, arrays, device, dtype, keep=None):
    """One case's float outputs and input gradients as host float64
    numpy (the gradient of sum(out * ct), or of sum(cos(out)) where rows
    are unique up to sign), their first ``keep`` rows where given."""
    import torch
    from mxnet_tpu_torch.ops import registry
    fn = registry.get(case.name).fn
    tdt = {np.float32: torch.float32, np.float64: torch.float64}[dtype]
    xs = [torch.tensor(a, device=device,
                       dtype=tdt if a.dtype == np.float64 else None)
          for a in arrays]
    for i in case.diff:
        xs[i].requires_grad_(True)
    out = fn(*xs, **case.params)
    outs = list(out) if isinstance(out, tuple) else [out]
    grads = []
    if case.diff:
        terms = [torch.cos(o).sum() if case.sign else
                 (o * torch.tensor(_p31_ct(tuple(o.shape), k, case.held),
                                   dtype=o.dtype, device=device)).sum()
                 for k, o in enumerate(outs) if o.is_floating_point()
                 and k not in case.exact]
        grads = torch.autograd.grad(sum(terms), [xs[i] for i in case.diff])
    host = [t.detach()[:keep].cpu().double().numpy()
            for t in outs + list(grads)]
    return host[:len(outs)], host[len(outs):]


def _p31_align(case, outs, ref):
    """``outs`` with each row's sign (L's matching column) set to the
    reference's: gelqf's Q rows, syevd's eigenvector rows."""
    if case.sign is None:
        return outs
    rows, want = (outs[1], ref[1]) if case.sign == "gelqf" \
        else (outs[0], ref[0])
    s = np.where(np.einsum("...ij,...ij->...i", rows, want) < 0, -1.0, 1.0)
    if case.sign == "gelqf":
        return [outs[0] * s[..., None, :], outs[1] * s[..., :, None]]
    return [outs[0] * s[..., :, None], outs[1]]


def _p31_signfree(case, outs, a):
    """(A rebuilt, rows orthonormal) residuals over the larger of 1 and
    the largest magnitude: L Q = A and Q Q^T = I, or U^T diag(w) U = A
    and U U^T = I."""
    if case.sign == "gelqf":
        rebuilt, rows = outs[0] @ outs[1], outs[1]
    else:
        rebuilt, rows = np.swapaxes(outs[0], -1, -2) @ (
            outs[1][..., :, None] * outs[0]), outs[0]
    eye = np.broadcast_to(np.eye(rows.shape[-2]), rows.shape[:-1]
                          + (rows.shape[-2],))
    return (_p28_err(rebuilt, a),
            _p28_err(rows @ np.swapaxes(rows, -1, -2), eye))


def _p31_hold(case, arrays):
    """Card against CPU in each dtype; returns {dtype: (worst error, its
    tolerance)}.  float32's tolerance per array: 1e-6 for elementwise
    ops, else P31_FLOOR_FACTOR times that array's float32 floor (CPU
    float32 against CPU float64) where that is above 1e-6.  Where
    ``case.held`` is set, the card runs every row and the CPU the first
    ``held``, against which the card's first ``held`` are held."""
    runs = {}
    host_arrays = arrays if not case.held else [a[:case.held]
                                                for a in arrays]
    with _p28_tf32_off():
        for dt in case.dtypes:
            runs[(P31_DEVICE, dt)] = _p31_run(case, arrays, P31_DEVICE, dt,
                                              case.held)
            runs[("cpu", dt)] = _p31_run(case, host_arrays, "cpu", dt)
    worst = {}
    ref64 = runs.get(("cpu", np.float64))
    for dt in case.dtypes:
        card, host = runs[(P31_DEVICE, dt)], runs[("cpu", dt)]
        c_out, h_out = _p31_align(case, card[0], host[0]), host[0]
        bad = [k for k in case.exact
               if not np.array_equal(c_out[k], h_out[k])]
        if bad:
            raise RuntimeError("phase 31: %s (%s): outputs %r differ"
                               % (case.label, np.dtype(dt).name, bad))
        pairs = [(c, h, k) for k, (c, h) in enumerate(zip(c_out, h_out))
                 if k not in case.exact]
        pairs += [(c, h, None) for c, h in zip(card[1], host[1])]
        floors = [0.0] * len(pairs)
        if dt == np.float32 and ref64 is not None and not case.elem:
            r_out = _p31_align(case, ref64[0], h_out)
            ref = [r for k, r in enumerate(r_out) if k not in case.exact] \
                + ref64[1]
            floors = [_p28_err(h, r) for (_, h, _), r in zip(pairs, ref)]
        err, tol = 0.0, None
        for i, ((c, h, k), fl) in enumerate(zip(pairs, floors)):
            e = _p28_err(c, h)
            t = P31_F64_TOL if dt == np.float64 else max(
                P31_F32_TOL, P31_FLOOR_FACTOR * fl)
            if e > t:
                raise RuntimeError(
                    "phase 31: %s (%s): %s: card vs CPU %.3g over %.3g "
                    "(float32 floor %.3g)"
                    % (case.label, np.dtype(dt).name,
                       "output %d" % k if k is not None else
                       "gradient %d" % (i - len(c_out) + len(case.exact)),
                       e, t, fl))
            if tol is None or e / t > err / tol:
                err, tol = e, t
        worst[dt] = (err, tol if tol is not None else 0.0)
        if case.sign:
            a = host_arrays[0]
            cr, hr = _p31_signfree(case, card[0], a), \
                _p31_signfree(case, host[0], a)
            limit = P31_F64_TOL if dt == np.float64 else max(
                P31_F32_TOL, P31_FLOOR_FACTOR * max(hr))
            print("phase 31 (a): %s (%s) sign-free: card rebuilds A within "
                  "%.3g and its rows are orthonormal within %.3g (CPU %.3g, "
                  "%.3g)" % (case.label, np.dtype(dt).name, cr[0], cr[1],
                             hr[0], hr[1]))
            if max(cr) > limit:
                raise RuntimeError("phase 31: %s sign-free residuals %r over "
                                   "%.3g" % (case.label, cr, limit))
    return worst


def _p31_syncs(fn):
    return _p30_syncs(fn, P31_DEVICE)


def _p31_time(fn):
    """(ms a call, kernel launches a call, host-sync messages of a call):
    CUDA events over a window of about P31_TIME_S (2 to 10 calls), the
    profiler over one call, torch's sync debug mode over one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    if P31_DEVICE != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3, None, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    n = int(min(10, max(2, P31_TIME_S / max(time.perf_counter() - t0,
                                             1e-6))))
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / n
    calls = 3 if ms < 50 else 1
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels = sum(e.count for e in ev if "memcpy" not in e.key.lower()
                  and "memset" not in e.key.lower())
    return ms, kernels / calls, _p31_syncs(fn)[1]


def _p31_forward(case, arrays):
    """The case's forward on the card in float32, as a no-argument call."""
    import torch
    from mxnet_tpu_torch.ops import registry
    fn = registry.get(case.name).fn
    xs = [torch.tensor(a, device=P31_DEVICE,
                       dtype=torch.float32 if a.dtype == np.float64 else None)
          for a in arrays]
    return lambda: fn(*xs, **case.params)


def _p31_ops():
    """(a): every new name, card against CPU, then timed on the card."""
    import torch
    from mxnet_tpu_torch.ops import registry
    registry.load_all()
    cases = _p31_cases()
    names = _p31_new_names()
    covered = {registry.get(c.name) for c in cases}
    missing = [n for n in names if registry.get(n) not in covered]
    if len(names) != 59 or missing:
        raise RuntimeError("phase 31 (a): %d new names, not held: %r"
                           % (len(names), missing))
    rows = []
    for case in cases:
        t0 = time.monotonic()
        arrays = case.make(None)
        worst = _p31_hold(case, arrays)
        ms, kernels, msgs = _p31_time(_p31_forward(case, arrays))
        allowed = P31_SYNCS.get(case.label, 0)
        if len(msgs) > allowed:
            raise RuntimeError("phase 31 (a): %s syncs %d times a call "
                               "(allowed %d): %s" % (case.label, len(msgs),
                                                     allowed, msgs[0][:200]))
        f32 = worst.get(np.float32, (0.0, 0.0))
        f64 = worst.get(np.float64)
        rows.append(dict(op=case.label, name=case.name, ms=ms,
                         kernels=kernels, syncs=len(msgs), err32=f32[0],
                         tol32=f32[1], err64=f64 and f64[0]))
        print("phase 31 (a): %-26s %10.4f ms a call; %s kernels, %d host "
              "syncs a call (allowed %d); card vs CPU f32 %.3g (tol %.3g)%s;"
              " %.1f s" % (case.label, ms, kernels, len(msgs), allowed,
                           f32[0], f32[1],
                           "" if f64 is None else ", f64 %.3g" % f64[0],
                           time.monotonic() - t0))
        del arrays
        if P31_DEVICE == "cuda":
            torch.cuda.empty_cache()
    print("phase 31 (a): all %d names of the slice held (%d ops, %d cases)"
          % (len(names), len(covered), len(cases)))
    return rows


def _p31_sae():
    """(b): ``train_ae.main()`` at its defaults, then the sparse
    autoencoder at MNIST's stacked widths."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.context import use
    from mxnet_tpu_torch.ops import contrib
    from mxnet_tpu_torch.tools import train_ae
    t0 = time.monotonic()
    base, final, plain, sparse = train_ae.main(
        [] if P31_DEVICE == "cuda" else ["--ctx", "cpu"])
    secs = time.monotonic() - t0
    print("phase 31 (b): train_ae.main() at its defaults in %.1f s: "
          "baseline %.4f -> %.4f, mean code plain %.3f sparse %.3f (its "
          "asserts held)" % (secs, base, final, plain, sparse))
    B = P31_SAE_BATCH
    steps = P31_SAE_WARMUP + P31_SAE_STEPS + P31_SAE_PROFILED + 1
    x_host = np.random.RandomState(321).rand(steps * B, P31_SAE["dim"]) \
        .astype(np.float32)
    sync = torch.cuda.synchronize if P31_DEVICE == "cuda" else (lambda: 0)
    with use(P31_DEVICE):
        mx.random.seed(321)
        net = train_ae.AutoEncoder(sparse_reg=0.05, **P31_SAE)
        net.initialize(mx.init.Xavier())
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 1e-3})
        l2 = mx.gluon.loss.L2Loss()
        data = mx.nd.array(x_host)
        batches = iter([data[i * B:(i + 1) * B] for i in range(steps)])
        losses = []

        def step():
            x = next(batches)
            with mx.autograd.record():
                loss = l2(net(x), x).mean()
            loss.backward()
            trainer.step(B)
            losses.append(loss)
        for _ in range(P31_SAE_WARMUP):
            step()
        sync()
        if P31_DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        for _ in range(P31_SAE_STEPS):
            step()
        sync()
        rate = P31_SAE_STEPS * B / (time.perf_counter() - t1)
        idle = _p26_idle(step, P31_SAE_PROFILED) \
            if P31_DEVICE == "cuda" else None
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
            if P31_DEVICE == "cuda" else 0.0
        code = net.encode(data[:B])
        mean_code = float(code.mean().asscalar())
        first, last = float(losses[0].asscalar()), \
            float(losses[-1].asscalar())
        kl = contrib.identity_attach_kl_sparse_reg
        xk = code._data.detach().clone().requires_grad_(True)
        out = kl(xk, sparseness_target=0.05, penalty=0.05)
        g = torch.ones_like(out)
        kl_ms, kl_kernels, kl_syncs = _p31_time(
            lambda: torch.autograd.grad(out, xk, g, retain_graph=True))
    if not (np.isfinite(first) and np.isfinite(last) and last < first):
        raise RuntimeError("phase 31 (b): the wide sparse autoencoder's "
                           "loss went %r -> %r" % (first, last))
    if kl_syncs:
        raise RuntimeError("phase 31 (b): the KL backward syncs: %s"
                           % kl_syncs[0][:200])
    print("phase 31 (b): sparse autoencoder 784-500-500-2000-10 (KL on the "
          "code), batch %d, Adam: %.1f samples/s over %d steps (host clock),"
          " idle share %s over %d more (profiler), peak %.2f GiB, loss %.4f "
          "-> %.4f, mean code %.4f (target 0.05); the KL backward %.4f ms "
          "a call, %s kernels, %d host syncs"
          % (B, rate, P31_SAE_STEPS,
             "not measured" if idle is None else "%.4f" % idle,
             P31_SAE_PROFILED, peak, first, last, mean_code, kl_ms,
             kl_kernels, len(kl_syncs)))
    return dict(defaults_s=secs, samples_s=rate, idle=idle, peak_gib=peak,
                kl_backward_ms=kl_ms)


def _p31_rfcn_cases():
    """(c)'s ops at Deformable R-FCN's sizes."""
    H, W = P31_RFCN_MAP
    C, R, P = P31_RFCN_CH, P31_RFCN_ROIS, P31_RFCN_P
    ih, iw = P31_RFCN_IMAGE

    def conv(dg):
        def make(_):
            rng = np.random.RandomState(340 + dg)
            return [rng.randn(1, C, H, W), rng.randn(1, 18 * dg, H, W) * 2.0,
                    rng.randn(C, C, 3, 3) * np.sqrt(2.0 / (C * 9)),
                    rng.randn(C) * 0.1]
        return _P31Case("DeformableConvolution dg %d" % dg,
                        "_contrib_DeformableConvolution", make,
                        dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2),
                             num_filter=C, num_deformable_group=dg),
                        diff=(0, 1, 2, 3))

    def pool(d, deform):
        def make(_):
            rng = np.random.RandomState(350 + d + deform)
            xs = [rng.randn(1, d * P * P, H, W),
                  _p31_rois(rng, R, 1, ih, iw)]
            return xs + ([rng.randn(R, 2, P, P)] if deform else [])
        kw = dict(spatial_scale=1 / 16, output_dim=d, pooled_size=P)
        if deform:
            kw.update(group_size=P, part_size=P, sample_per_part=4,
                      trans_std=0.1)
            return _P31Case("DeformablePSROIPooling %d x 7^2" % d,
                            "_contrib_DeformablePSROIPooling", make, kw,
                            diff=(0, 2))
        return _P31Case("PSROIPooling %d x 7^2" % d, "_contrib_PSROIPooling",
                        make, kw, diff=(0,))
    return [conv(4), conv(1)] + [pool(d, f) for f in (False, True)
                                 for d in (P31_RFCN_CLASSES, P31_RFCN_BOX)]


def _p31_rfcn():
    """(c): the Deformable R-FCN head, forward and backward, card against
    CPU in float32 and float64, then timed on the card."""
    import torch
    from mxnet_tpu_torch.ops import registry
    H, W = P31_RFCN_MAP
    rows = []
    for case in _p31_rfcn_cases():
        arrays = case.make(None)
        worst = _p31_hold(case, arrays)
        fn = registry.get(case.name).fn
        xs = [torch.tensor(a, device=P31_DEVICE, dtype=torch.float32)
              for a in arrays]
        for i in case.diff:
            xs[i].requires_grad_(True)
        out = fn(*xs, **case.params)
        ct = torch.randn(out.shape, device=P31_DEVICE,
                         generator=torch.Generator(P31_DEVICE).manual_seed(7))
        with torch.no_grad():
            fwd_ms, fwd_k, fwd_s = _p31_time(lambda: fn(*xs, **case.params))
        bwd_ms, bwd_k, bwd_s = _p31_time(lambda: torch.autograd.grad(
            out, [xs[i] for i in case.diff], ct, retain_graph=True))
        extra = ""
        if case.name == "_contrib_DeformableConvolution":
            col = P31_RFCN_CH * 9 * H * W * 4
            extra = "; deformed im2col %.1f MB (f32, and as much again " \
                "for the gathered samples)" % (col / 1e6)
        rows.append(dict(op=case.label, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
                         err32=worst[np.float32][0],
                         err64=worst[np.float64][0]))
        print("phase 31 (c): %-34s forward %9.4f ms (%s kernels), backward "
              "%9.4f ms (%s kernels), host syncs %d / %d; card vs CPU f32 "
              "%.3g (tol %.3g), f64 %.3g%s"
              % (case.label, fwd_ms, fwd_k, bwd_ms, bwd_k, len(fwd_s),
                 len(bwd_s), worst[np.float32][0], worst[np.float32][1],
                 worst[np.float64][0], extra))
        if fwd_s or bwd_s:
            raise RuntimeError("phase 31 (c): %s syncs: %s"
                               % (case.label, (fwd_s + bwd_s)[0][:200]))
        del xs, out, arrays
        if P31_DEVICE == "cuda":
            torch.cuda.empty_cache()
    return rows


def _p31_lstm_run(dtype, arrays, cts):
    """(fused RNN op's, foreach over LSTMCell's) outputs, final states and
    gradients (data, h0, c0, the flat vector), host float64, and each
    route's forward + backward as a call."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.context import use
    from mxnet_tpu_torch.ops import rnn
    T, B, I, H = P31_LSTM
    x, flat, h0, c0 = arrays
    tdt = {np.float32: torch.float32, np.float64: torch.float64}[dtype]
    dev = P31_DEVICE

    def t(a, grad=True):
        return torch.tensor(a, dtype=tdt, device=dev, requires_grad=grad)
    ts = [t(x), t(flat), t(h0[None]), t(c0[None])]
    ct = [t(c, False) for c in cts]

    def fused():
        outs = rnn.rnn(*ts, state_size=H, num_layers=1, mode="lstm",
                       state_outputs=True)
        return list(outs) + list(torch.autograd.grad(
            outs, ts, [ct[0], ct[1][None], ct[2][None]]))
    out, h_t, c_t, dx, dflat, dh0, dc0 = [
        a.detach().cpu().double().numpy() for a in fused()]
    got_f = [out, h_t[0], c_t[0], dx, dh0[0], dc0[0], dflat]
    with use(dev):
        cell = mx.gluon.rnn.LSTMCell(H, input_size=I)
        cell.initialize(ctx=dev)
        if dtype == np.float64:
            cell.cast("float64")
        sizes = [4 * H * I, 4 * H * H, 4 * H, 4 * H]
        parts = np.split(flat, np.cumsum(sizes)[:-1])
        params = [cell.i2h_weight, cell.h2h_weight, cell.i2h_bias,
                  cell.h2h_bias]
        for p, v, shape in zip(params, parts, [(4 * H, I), (4 * H, H),
                                               (4 * H,), (4 * H,)]):
            p.set_data(v.reshape(shape).astype(dtype))
        nds = [mx.nd.array(a, dtype=np.dtype(dtype).name)
               for a in (x, h0, c0)]
        for a in nds:
            a.attach_grad()
        nct = [mx.nd.NDArray(c) for c in ct]

        def looped():
            with mx.autograd.record():
                outs, (hT, cT) = mx.nd.contrib.foreach(
                    lambda xt, st: cell(xt, st), nds[0], nds[1:])
                loss = (outs * nct[0]).sum() + (hT * nct[1]).sum() \
                    + (cT * nct[2]).sum()
            loss.backward()
            return [outs, hT, cT] + [a.grad for a in nds] + [
                p.grad() for p in params]
        got, msgs = _p31_syncs(looped)
        got = [a.asnumpy().astype(np.float64) for a in got]
    got_l = got[:6] + [np.concatenate([g.reshape(-1) for g in got[6:]])]
    return got_f, got_l, fused, looped, msgs


def _p31_control_flow():
    """(d): an LSTM as nd.contrib.foreach over gluon.rnn.LSTMCell against
    the fused RNN op on the same weights; while_loop and cond with their
    host syncs."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.context import use
    from mxnet_tpu_torch.ops import contrib
    T, B, I, H = P31_LSTM
    rng = np.random.RandomState(360)
    arrays = [rng.randn(T, B, I), rng.uniform(-0.07, 0.07, 4 * H * (I + H + 2)),
              rng.randn(B, H) * 0.1, rng.randn(B, H) * 0.1]
    cts = [rng.randn(T, B, H), rng.randn(B, H), rng.randn(B, H)]
    names = ["outputs", "h_T", "c_T", "d data", "d h0", "d c0", "d weights"]
    with _p28_tf32_off():
        for dtype, tol in ((np.float32, P28_RNN_F32_TOL),
                           (np.float64, P28_RNN_F64_TOL)):
            got_f, got_l, fused, looped, msgs = _p31_lstm_run(dtype, arrays,
                                                              cts)
            errs = [_p28_err(a, b) for a, b in zip(got_l, got_f)]
            print("phase 31 (d): foreach over LSTMCell vs the fused RNN op "
                  "(%s), T %d, batch %d, %d -> %d: %s (tol %g); host syncs "
                  "in the foreach step %d"
                  % (np.dtype(dtype).name, T, B, I, H, ", ".join(
                      "%s %.3g" % kv for kv in zip(names, errs)), tol,
                     len(msgs)))
            if max(errs) > tol or msgs:
                raise RuntimeError("phase 31 (d): %r %r" % (errs, msgs[:1]))
            if dtype == np.float32:
                f_ms = _p31_time(fused)[0]
                l_ms = _p31_time(looped)[0]
                print("phase 31 (d): forward + backward over %d frames: the "
                      "fused op (cuDNN) %.3f ms, foreach %.3f ms (%.4f / "
                      "%.4f ms a frame)" % (T, f_ms, l_ms, f_ms / T, l_ms / T))
            del got_f, got_l, fused, looped
            if P31_DEVICE == "cuda":
                torch.cuda.empty_cache()
    contrib.reset_host_sync_counts()
    with use(P31_DEVICE):
        calls = []

        def cond_fn(v):
            calls.append(1)
            return v < 1000

        one, zero, five = (mx.nd.array([a]) for a in (1.0, 0.0, 5.0))
        v, msgs = _p31_syncs(lambda: mx.nd.contrib.while_loop(
            cond_fn, lambda v: v * 2, one))
        iters = int(np.log2(float(v.asscalar())))
        capped, msgs5 = _p31_syncs(lambda: mx.nd.contrib.while_loop(
            lambda v: v < 1e9, lambda v: v + 1, zero, max_iterations=5))
        r, msgs_c = _p31_syncs(lambda: mx.nd.contrib.cond(
            one, lambda a: a * 2, lambda a: a * 3, [five]))
        counted = contrib.host_sync_counts()
    tests = len(calls)
    expect = (tests, 5, 1) if P31_DEVICE == "cuda" else (0, 0, 0)
    print("phase 31 (d): while_loop %d iterations, %d tests of its "
          "condition, %d host syncs; capped at 5 iterations: %d syncs; cond: "
          "%d sync; counted by the ops %r%s"
          % (iters, tests, len(msgs), len(msgs5), len(msgs_c), counted,
             "; first: %s" % msgs[0][:160] if msgs else ""))
    if float(v.asscalar()) != 1024.0 or float(capped.asscalar()) != 5.0 \
            or float(r.asscalar()) != 10.0 or iters != 10 or tests != 11:
        raise RuntimeError("phase 31 (d): control flow results")
    if (len(msgs), len(msgs5), len(msgs_c)) != expect or \
            counted.get("while_loop", 0) != expect[0] + expect[1] or \
            counted.get("cond", 0) != expect[2]:
        raise RuntimeError("phase 31 (d): host syncs %r, counted %r, "
                           "allowed one a test of the condition and one a "
                           "cond: %r" % ((len(msgs), len(msgs5),
                                          len(msgs_c)), counted, expect))


def _p31_glove(tmp):
    """(e): a GloVe-format file from the seed, loaded by CustomEmbedding,
    a Vocabulary's vectors copied into a Gluon Embedding on the card;
    lookups bitwise."""
    import collections
    import os
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.context import use
    n, d = P31_GLOVE
    rng = np.random.RandomState(370)
    table = np.array(["%.3f" % (k / 1000.0) for k in range(-999, 1000)],
                     dtype=object)
    idx = rng.randint(0, len(table), (n, d))
    path = os.path.join(tmp, "glove.txt")
    t0 = time.monotonic()
    with open(path, "w") as f:
        for i in range(n):
            f.write("w%d %s\n" % (i, " ".join(table[idx[i]])))
    write_s = time.monotonic() - t0
    text = mx.contrib.text
    with use(P31_DEVICE):
        t0 = time.monotonic()
        emb = text.CustomEmbedding(path)
        load_s = time.monotonic() - t0
        ids = np.minimum(rng.zipf(1.2, P31_CORPUS), n + n // 5) - 1
        corpus = ["w%d" % i for i in ids]
        vocab = text.Vocabulary(collections.Counter(corpus))
        comp = text.CompositeEmbedding(vocab, [emb])
        layer = mx.gluon.nn.Embedding(len(vocab), d)
        layer.initialize(ctx=P31_DEVICE)
        layer.weight.set_data(comp.idx_to_vec)
        toks = corpus[:P31_LOOKUP]
        out = layer(mx.nd.array(np.array(vocab.to_indices(toks),
                                         np.float32))).asnumpy()
        want = emb.get_vecs_by_tokens(toks).asnumpy()
        device = emb.idx_to_vec._data.device.type
    parsed = np.array([[float(v) for v in table[idx[int(t[1:])]]]
                       if int(t[1:]) < n else [0.0] * d for t in toks],
                      np.float32)
    unknown = sum(int(t[1:]) >= n for t in toks)
    print("phase 31 (e): GloVe-format file of %d tokens x %d (%.0f MB) "
          "written in %.1f s, loaded by CustomEmbedding in %.1f s (vectors "
          "on %s); Vocabulary of %d tokens from a %d-token corpus; %d "
          "lookups (%d unknown) through gluon.nn.Embedding bitwise: %s"
          % (n, d, os.path.getsize(path) / 1e6, write_s, load_s, device,
             len(vocab), P31_CORPUS, len(toks), unknown,
             np.array_equal(out, want) and np.array_equal(out, parsed)))
    if not (np.array_equal(out, want) and np.array_equal(out, parsed)) \
            or device != P31_DEVICE:
        raise RuntimeError("phase 31 (e): embedding lookups differ")
    return dict(write_s=write_s, load_s=load_s, vocab=len(vocab))


def _p31_contrib(tmp):
    """(e): DataLoaderIter into Module.fit, the old autograd API, the
    tensorboard gate."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.context import use
    rows, width, batch = P31_FIT
    rng = np.random.RandomState(380)
    x = rng.randn(rows, width).astype(np.float32)
    y = (x[:, :8].sum(1) > 0).astype(np.float32)   # a planted direction
    with use(P31_DEVICE):
        sym = mx.sym
        net = sym.SoftmaxOutput(sym.FullyConnected(sym.Activation(
            sym.FullyConnected(sym.Variable("data"), num_hidden=128,
                               name="fc1"), act_type="relu"),
            num_hidden=2, name="fc2"), name="softmax")
        it = mx.contrib.io.DataLoaderIter(mx.gluon.data.DataLoader(
            mx.gluon.data.ArrayDataset(x, y), batch_size=batch))
        mod = mx.mod.Module(net, context=P31_DEVICE)
        mx.random.seed(380)
        t0 = time.monotonic()
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5},
                initializer=mx.init.Xavier())
        fit_s = time.monotonic() - t0
        it.reset()
        acc = dict(mod.score(it, "acc"))["accuracy"]
    grads = {}
    for dev in (P31_DEVICE, "cpu"):
        with use(dev):
            g, loss = mx.contrib.autograd.grad_and_loss(
                lambda a: mx.nd.sum(a * a * a))(mx.nd.array(x[0]))
            grads[dev] = (g[0].asnumpy(), float(loss.asscalar()))
    gerr = _p28_err(grads[P31_DEVICE][0], grads["cpu"][0])
    try:
        mx.contrib.tensorboard.LogMetricsCallback(tmp)
        writer = "a summary writer imports here"
    except ImportError as e:
        if "tensorboardX" not in str(e):
            raise
        writer = "no summary writer imports here: ImportError (%s)" % e
    print("phase 31 (e): DataLoaderIter -> Module.fit, one epoch of %d x %d "
          "in batches of %d: %.2f s, training accuracy after it %.4f; "
          "contrib.autograd.grad_and_loss card vs CPU %.3g; "
          "LogMetricsCallback: %s" % (rows, width, batch, fit_s, acc, gerr,
                                      writer))
    if acc < 0.8 or gerr > P31_F32_TOL:
        raise RuntimeError("phase 31 (e): accuracy %r, autograd %r"
                           % (acc, gerr))
    return dict(fit_s=fit_s, accuracy=acc)


def phase_rest_of_ops():
    """Phase 31: the rest of the op set and contrib/."""
    import shutil
    import tempfile
    t_phase = time.monotonic()
    for m in _hand_counters():
        m.reset_launch_counts()
    rows = _p31_ops()
    sae = _p31_sae()
    rfcn = _p31_rfcn()
    _p31_control_flow()
    tmp = tempfile.mkdtemp(prefix="p31_")
    try:
        glove = _p31_glove(tmp)
        fit = _p31_contrib(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launched = _hand_launches()
    if launched:
        raise RuntimeError("phase 31: hand kernels launched on the slice's "
                           "path: %r" % launched)
    RUNS["phase 31"] = dict(ops=rows, sae=sae, rfcn=rfcn, glove=glove,
                            fit=fit)
    print("phase 31: B1-B10 launches 0 over the phase; %.1f s (the script "
          "so far %.1f s)" % (time.monotonic() - t_phase,
                              time.monotonic() - T_START))


# phase 32: in-process data parallelism, ZeRO-1, grad_accum,
# sharded checkpoints; K in-process ranks on the one card
P32_K, P32_BATCH, P32_WARM, P32_TIMED = 4, 256, 2, 6
P32_PARITY_BATCH, P32_SMALL_BATCH = 16, 32
P32_LM_PLAN = dict(data=2, sequence=2)
P32_PLAIN_TOL, P32_CPU_RTOL = 1e-6, 1e-4
# where the phase's path runs and the image side (224: ResNet-50's)
P32_DEV, P32_SIDE = "cuda", 224


def _p32_card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _p32_arrays(layout="NCHW"):
    """Xavier weights of resnet50_v1 (seeded), made once on the host."""
    import torch
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import vision
    net = vision.resnet50_v1(layout=layout)
    net.initialize(initializer.Xavier(), ctx="cpu",
                   rng=np.random.RandomState(0))
    shape = (1, P32_SIDE, P32_SIDE, 3) if layout == "NHWC" else (1, 3, P32_SIDE, P32_SIDE)
    with torch.no_grad():
        net(torch.zeros(shape))
    return {n: p.tensor().detach().numpy().copy()
            for n, p in net.collect_params().items()}


def _p32_trainer(arrays, k, device=None, layout="NCHW", opt="sgd",
                 params=None, **kw):
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.utils import from_jax_params
    from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
    dev = P32_DEV if device is None else device
    net = from_jax_params(vision.resnet50_v1(layout=layout), arrays,
                          device=dev)
    tr = DataParallelTrainer(
        net, SoftmaxCrossEntropyLoss(), opt,
        dict(SGD_PARAMS) if params is None else params,
        mesh=make_mesh((k,), ("data",), [dev] * k), **kw)
    return net, tr


def _p32_images(n, batch, layout="NCHW", seed=0):
    rng = np.random.RandomState(seed)
    shape = (batch, P32_SIDE, P32_SIDE, 3) if layout == "NHWC" \
        else (batch, 3, P32_SIDE, P32_SIDE)
    pool = [rng.rand(*shape).astype(np.float32) for _ in range(2)]
    x = np.concatenate([pool[i % 2] for i in range(n)])
    y = (rng.rand(n * batch) * 1000).astype(np.int64)
    return x, y


def _p32_fit(tr, x, y, batch):
    """(loss metric, seconds) of one ``fit`` epoch over the arrays."""
    import torch
    from mxnet_tpu_torch.io import NDArrayIter
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = tr.fit(NDArrayIter(x, y, batch_size=batch), num_epoch=1,
               bulk_size=4)
    torch.cuda.synchronize()
    return m.get()[1], time.perf_counter() - t0


def _p32_ranks(tr, label):
    """Each rank's optimizer state numel against ``shard`` and the loop of
    csrc/fused_optimizer.cu its launch takes."""
    from mxnet_tpu_torch.parallel import zero
    plan = tr._zero_plan
    out = []
    for i in range(plan.k):
        leaves = tr._zero_leaves(i)
        w = tr._zero_master[i] if tr._zero_master is not None \
            else tr._zero_w_shards[i]
        numel = [int(v.numel()) for v in leaves]
        if any(n != plan.shard for n in numel) or w.numel() != plan.shard:
            raise RuntimeError("%s: rank %d holds state %r, want %d each"
                               % (label, i, numel, plan.shard))
        # the gradient shard is rank i's view of one reduce-scattered
        # buffer, i * shard elements in
        route = zero.shard_route((w,) + tuple(leaves))
        if (i * plan.shard) % 4:
            route = "scalar"
        out.append((i, numel[0], route))
    print("%s: total %d padded %d shard %d (shard %% 4 = %d); per rank "
          "(rank, state numel, route): %s"
          % (label, plan.total, plan.padded, plan.shard, plan.shard % 4, out))
    return out


def _p32_timed(label, tr, x, y, batch, card, counts_of, want):
    """A warm-up and a timed ``fit`` epoch; the launches of the timed one
    checked against ``want``."""
    import torch
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    nw = P32_WARM * batch
    _p32_fit(tr, x[:nw], y[:nw], batch)
    fo.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    loss, secs = _p32_fit(tr, x[nw:], y[nw:], batch)
    peak = torch.cuda.max_memory_allocated()
    got = counts_of(fo.launch_counts())
    if got != want:
        raise RuntimeError("%s: launches %r, want %r" % (label, got, want))
    rate = P32_TIMED * batch / secs
    print("%s: %.1f images/s over %d fit steps of %d (%.3f s); peak memory "
          "%.2f GiB; mean loss %.4f; launches %r [%s]"
          % (label, rate, P32_TIMED, batch, secs, peak / 2 ** 30, loss, got,
             card))
    if not np.isfinite(loss):
        raise RuntimeError("%s: loss %r" % (label, loss))
    return rate, peak


def _p32_plain_step(arrays, x, y):
    """One ZeRO-1 step at K ranks with B1 against the same step with the
    kernel's plain version on the card (cuDNN deterministic)."""
    import torch
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    outs = []
    real = fo.fused_optimizer_update

    def plain(opt, index, w, g, state, lr, t, inv_scale=1.0, ok=1.0):
        s = fo._scalars(lr, inv_scale, ok, w.device)
        nw, nm = fo.fused_sgd_momentum_reference(
            w, g, state, s, momentum=opt.momentum, wd=opt._get_wd(index),
            rescale_grad=opt.rescale_grad, clip_gradient=opt.clip_gradient)
        with torch.no_grad():
            w.copy_(nw)
            state.copy_(nm)
        return w, state

    for use_plain in (False, True):
        net, tr = _p32_trainer(arrays, P32_K, zero=1)
        fo.fused_optimizer_update = plain if use_plain else real
        try:
            tr.step(x, y)
            tr.flush()
        finally:
            fo.fused_optimizer_update = real
        outs.append([p.tensor().detach() for p in
                     net.collect_params().values()])
        del tr
    err = max(float((a - b).abs().max()) for a, b in zip(*outs))
    print("phase 32 (a): one ZeRO-1 step, B1 on each shard vs its plain "
          "version on the card: max |dparam| %.3g (tol %g)"
          % (err, P32_PLAIN_TOL))
    if err > P32_PLAIN_TOL:
        raise RuntimeError("phase 32 (a): B1 vs plain %.3g" % err)
    return err


def _p32_cpu_parity(arrays):
    """Two ZeRO-1 steps at K ranks, batch 16, on the card and on the CPU
    (TF32 off), as phase 6 holds the one-rank step: the first-step loss
    within 1e-4 relative; after the second step (where Xavier at this
    learning rate turns rounding into chaos) the losses and parameters
    within ``NOISE_FACTOR`` x the rounding floor, the same CPU run on an
    input one ulp up."""
    import torch
    rng = np.random.RandomState(5)
    x = rng.rand(P32_PARITY_BATCH, 3, P32_SIDE, P32_SIDE).astype(np.float32)
    y = rng.randint(0, 1000, P32_PARITY_BATCH)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    try:
        for name, dev, xx in (
                ("card", P32_DEV, x), ("cpu", "cpu", x),
                ("ulp", "cpu", np.nextafter(x, np.float32(np.inf)))):
            net, tr = _p32_trainer(arrays, P32_K, device=dev, zero=1)
            res[name] = ([float(tr.step(xx, y)) for _ in range(2)],
                         [p.tensor().detach().cpu().double() for p in
                          net.collect_params().values()])
            del tr
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved

    def gaps(a, b):
        la, pa = res[a]
        lb, pb = res[b]
        return ([abs(u - v) / abs(v) for u, v in zip(la, lb)],
                max(float((u - v).abs().max()) for u, v in zip(pa, pb)))

    (l1, l2), dp = gaps("card", "cpu")
    (_, f2), fp = gaps("ulp", "cpu")
    print("phase 32 (a): card vs CPU, ZeRO-1 K=%d batch %d, 2 steps, TF32 "
          "off: losses %s / %s; first-step relative gap %.3g (tol %g); "
          "second-step loss gap %.3g and max |dparam| %.3g against the "
          "rounding floor %.3g / %.3g (allowed %g x floor)"
          % (P32_K, P32_PARITY_BATCH, res["card"][0], res["cpu"][0], l1,
             P32_CPU_RTOL, l2, dp, f2, fp, NOISE_FACTOR))
    if l1 > P32_CPU_RTOL:
        raise RuntimeError("phase 32 (a): card vs CPU first-step loss gap "
                           "%.3g" % l1)
    if l2 > max(NOISE_FACTOR * f2, P32_CPU_RTOL) or \
            dp > max(NOISE_FACTOR * fp, P32_CPU_RTOL):
        raise RuntimeError("phase 32 (a): card vs CPU after two steps %.3g "
                           "/ %.3g, more than %g x the rounding floor "
                           "%.3g / %.3g" % (l2, dp, NOISE_FACTOR, f2, fp))
    return l1, l2, dp, f2, fp


def _p32_grad_accum(arrays):
    """grad_accum=2 on both tiers: one step's accumulated gradient against
    the microbatch gradients folded by hand, bitwise (cuDNN
    deterministic)."""
    import torch
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.utils import from_jax_params
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.rand(16, 3, P32_SIDE, P32_SIDE).astype(np.float32)).to(P32_DEV)
    y = torch.from_numpy(rng.randint(0, 1000, 16)).to(P32_DEV)
    net = from_jax_params(vision.resnet50_v1(), arrays, device=P32_DEV)
    params = [p.tensor() for p in net.collect_params().values()
              if p.grad_req != "null"]
    loss_fn = SoftmaxCrossEntropyLoss()

    def grad(xm, ym):
        net.train(True)
        loss = loss_fn(net(xm), ym).mean()
        return torch.cat([g.reshape(-1) for g in
                          torch.autograd.grad(loss, params)])

    out = {}
    for zero, k in ((0, 1), (1, 2)):
        _, tr = _p32_trainer(arrays, k, zero=zero, grad_accum=2,
                             params={"learning_rate": 0.0})
        tr.step(x, y)
        tr.flush()
        rows = [tr._g_flat[0]] if not zero else list(tr._zero_rows)
        per = 16 // k
        for r in range(k):
            xr, yr = x[r * per:(r + 1) * per], y[r * per:(r + 1) * per]
            h = per // 2
            # 0 + g1 is g1: the fold of accumulate_grads, then / 2
            want = (grad(xr[:h], yr[:h]) + grad(xr[h:], yr[h:])) / 2
            got = rows[r][:want.numel()]
            same = bool(torch.equal(got, want))
            out["zero=%d rank %d" % (zero, r)] = same
            if not same:
                raise RuntimeError(
                    "phase 32 (c): zero=%d rank %d accumulated gradient "
                    "is not the fold by hand: max |d| %.3g" % (
                        zero, r, float((got - want).abs().max())))
        del tr
    print("phase 32 (c): grad_accum=2, each rank's accumulated gradient "
          "bitwise the fold of its two half-batch gradients by hand: %s"
          % out)
    return out


def _p32_checkpoints(arrays, tmp, card):
    """fit(checkpoint_dir=, checkpoint_every=1) at K=4; restore at K=2 and
    K=1 (full state bitwise); then two more steps at K=4 from the restore
    against an uninterrupted run (bitwise under cuDNN deterministic)."""
    import os
    import torch
    from mxnet_tpu_torch.io import NDArrayIter
    x, y = _p32_images(4, P32_SMALL_BATCH, seed=7)
    b = P32_SMALL_BATCH
    _, ref = _p32_trainer(arrays, P32_K, zero=1)
    ref.fit(NDArrayIter(x, y, batch_size=b), num_epoch=1)
    _, part = _p32_trainer(arrays, P32_K, zero=1)
    t0 = time.perf_counter()
    part.fit(NDArrayIter(x[:2 * b], y[:2 * b], batch_size=b), num_epoch=1,
             checkpoint_dir=tmp, checkpoint_every=1)
    t_fit = time.perf_counter() - t0
    full = [v.cpu() for v in part._zero_leaves()]
    params = [p.tensor().detach().cpu() for p in
              part._params_by_name.values()]
    held = {}
    for k in (2, 1, 4):
        _, tk = _p32_trainer(arrays, k, zero=1)
        t0 = time.perf_counter()
        cursor = tk.restore_checkpoint(tmp)
        secs = time.perf_counter() - t0
        same = (cursor["step"] == 2
                and all(torch.equal(a, bb.cpu()) for a, bb in
                        zip(full, tk._zero_leaves()))
                and all(torch.equal(a, p.tensor().detach().cpu())
                        for a, p in zip(params,
                                        tk._params_by_name.values())))
        held[k] = (same, round(secs, 3))
        if not same:
            raise RuntimeError("phase 32 (d): restore at K=%d is not "
                               "bitwise the K=%d state" % (k, P32_K))
        if k == P32_K:
            for i in (2, 3):
                tk.step(x[i * b:(i + 1) * b], y[i * b:(i + 1) * b])
            tk.flush()
            cont = all(torch.equal(a.tensor(), c.tensor()) for a, c in
                       zip(tk._params_by_name.values(),
                           ref._params_by_name.values()))
            if not cont:
                raise RuntimeError("phase 32 (d): two steps from the "
                                   "restore are not bitwise the "
                                   "uninterrupted run's")
        del tk
    files = sorted(os.listdir(tmp))
    mb = sum(os.path.getsize(os.path.join(tmp, f)) for f in files) / 2 ** 20
    print("phase 32 (d): fit with a sharded checkpoint every step at K=%d "
          "(%d steps, %.2f s, %d files, %.1f MiB kept); restored at K=2, "
          "1, 4: full state bitwise %s ((bitwise, restore s) by K); two "
          "more steps from the K=%d restore bitwise the uninterrupted run "
          "(cudnn.deterministic=%s) [%s]"
          % (P32_K, part._step_count, t_fit, len(files), mb, held,
             P32_K, torch.backends.cudnn.deterministic, card))
    return held


def _p32_lm(card):
    """The widest TransformerLM over MeshPlan(data=2, sequence=2), zero=1:
    tokens/s and the B1 and B4-B7 launches; two steps at one layer card
    vs CPU."""
    import torch
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    from mxnet_tpu_torch.ops import pallas_kernels as pk
    from mxnet_tpu_torch.parallel import DataParallelTrainer, MeshPlan
    from mxnet_tpu_torch.transformer import TransformerLM, TransformerLMConfig
    plan = MeshPlan(**P32_LM_PLAN)
    steps = P32_WARM + P32_TIMED
    batches = [tuple(torch.from_numpy(a).to(P32_DEV) for a in bb)
               for bb in _lm_batches(steps, TRAIN_LM_BATCH)]
    tr = DataParallelTrainer(
        TransformerLM(TransformerLMConfig(**CFG, attention="ring")), None,
        "sgd", dict(LM_SGD), mesh_plan=plan, zero=1, device=P32_DEV)
    pk.reset_launch_counts()
    fo.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for xb, yb in batches:
        t0 = time.perf_counter()
        losses.append(float(tr.step(xb, yb)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    flash, fcount = pk.launch_counts(), fo.launch_counts()
    d, q = P32_LM_PLAN["data"], P32_LM_PLAN["sequence"]
    want_flash = steps * CFG["n_layers"] * q * d
    want = {"fused_sgd_momentum": steps * d}
    got = {"fused_sgd_momentum": fcount["fused_sgd_momentum"]}
    for n in FLASH_KERNELS:
        want[n + "/wgmma"] = want_flash
        got[n + "/wgmma"] = flash[n + "/wgmma"]
    ln = fcount["fused_layer_norm"]
    if got != want or ln < steps * d * (2 * CFG["n_layers"] + 1):
        raise RuntimeError("phase 32 (e): launches %r (fused_layer_norm "
                           "%d), want %r" % (got, ln, want))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise RuntimeError("phase 32 (e): losses %r" % losses)
    timed = np.asarray(times[P32_WARM:])
    tokens = TRAIN_LM_BATCH * CFG["seq_len"]
    rate = tokens * P32_TIMED / timed.sum()
    zp = tr._mesh_zero_plan
    print("phase 32 (e): TransformerLM %s, MeshPlan(data=%d, sequence=%d), "
          "zero=1 (total %d, shard %d), batch %d x %d: %.1f tokens/s, step "
          "p50 %.2f ms; peak memory %.2f GiB; losses %s; launches %r, "
          "fused_layer_norm %d [%s]"
          % (CFG, d, q, zp.total, zp.shard, TRAIN_LM_BATCH, CFG["seq_len"],
             rate, np.percentile(timed, 50) * 1e3, peak / 2 ** 30,
             ["%.4f" % v for v in losses], got, ln, card))
    del tr
    small = dict(CFG, n_layers=1)
    xb, yb = _lm_batches(1, 4, seed=3)[0]
    res = {}
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in (P32_DEV, "cpu"):
            t = DataParallelTrainer(
                TransformerLM(TransformerLMConfig(**small,
                                                  attention="ring")),
                None, "sgd", dict(LM_SGD), mesh_plan=plan, zero=1,
                device=dev)
            res[dev] = ([float(t.step(xb, yb)) for _ in range(2)],
                        t.mesh_params())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    dl = max(abs(a - b) for a, b in zip(res[P32_DEV][0], res["cpu"][0]))
    dp = max(float(np.abs(res[P32_DEV][1][n] - res["cpu"][1][n]).max())
             for n in res["cpu"][1])
    print("phase 32 (e): one layer, batch 4, 2 steps card vs CPU: losses %s "
          "/ %s, max |dloss| %.3g, max |dparam| %.3g (tol %g)"
          % (res[P32_DEV][0], res["cpu"][0], dl, dp, LM_LOSS_TOL_DEVICE))
    if dl > LM_LOSS_TOL_DEVICE or dp > LM_LOSS_TOL_DEVICE:
        raise RuntimeError("phase 32 (e): card vs CPU %.3g / %.3g"
                           % (dl, dp))
    return got, ln, rate


def _p32_nccl():
    """A NCCL process group at world size 1 (a file store: no network): a
    zero=1 MLP step through the process-group placement equals the
    in-process K=1 step bitwise."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from mxnet_tpu_torch import gluon, initializer
    from mxnet_tpu_torch.parallel import (DataParallelTrainer,
                                          data_parallel_mesh, make_mesh)
    rng = np.random.RandomState(9)
    x = rng.rand(64, 512).astype(np.float32)
    y = rng.randint(0, 10, 64)

    def run(mesh):
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(1024, activation="relu"))
        net.add(gluon.nn.Dense(10))
        net.initialize(initializer.Xavier(), ctx=P32_DEV,
                       rng=np.random.RandomState(4))
        tr = DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "sgd", dict(SGD_PARAMS), mesh=mesh, zero=1)
        loss = float(tr.step(x, y))
        tr.flush()
        return tr, loss, [p.tensor().detach().clone() for p in
                          net.collect_params().values()]

    # the rendezvous is a file store, and NCCL's own bootstrap stays on
    # the loopback interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    fd, store = tempfile.mkstemp(prefix="p32_store_")
    os.close(fd)
    os.remove(store)
    dist.init_process_group("nccl" if P32_DEV == "cuda" else "gloo",
                            init_method="file://" + store, rank=0,
                            world_size=1)
    try:
        tr_pg, l_pg, p_pg = run(data_parallel_mesh())
        placement = tr_pg._comm.placement
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    _, l_in, p_in = run(make_mesh((1,), ("data",), [P32_DEV]))
    same = l_pg == l_in and all(torch.equal(a, b) for a, b in
                                zip(p_pg, p_in))
    print("phase 32 (f): NCCL process group, world size 1, placement %s: "
          "zero=1 MLP step loss %.6f vs in-process K=1 %.6f; parameters "
          "bitwise equal: %s" % (placement, l_pg, l_in, same))
    if placement != "process_group" or not same:
        raise RuntimeError("phase 32 (f): process-group step differs from "
                           "the in-process step")


def phase_data_parallel():
    """Phase 32: in-process data parallelism through
    ``DataParallelTrainer(mesh=make_mesh((4,), ("data",), [card] * 4),
    zero=1, grad_accum=)`` and ``fit``: ZeRO-1 ResNet-50 in f32 and bf16
    channels-last, Adam, grad_accum on both tiers, sharded checkpoints
    with resize-on-resume, the TransformerLM over MeshPlan(data=2,
    sequence=2), and a NCCL process group.  Returns the launches of B1,
    B3 and B4-B7 on the phase's main path."""
    import gc
    import shutil
    import tempfile
    import torch
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    t_phase = time.monotonic()
    card = _p32_card()
    for m in _hand_counters():
        m.reset_launch_counts()
    arrays = _p32_arrays()
    # (a) f32 NCHW ZeRO-1 at K=4, batch 256, through fit
    x, y = _p32_images(P32_WARM + P32_TIMED, P32_BATCH)
    _, tr = _p32_trainer(arrays, P32_K, zero=1)
    b1 = P32_K * P32_TIMED
    rate_a, peak_a = _p32_timed(
        "phase 32 (a) ZeRO-1 f32 NCHW K=%d" % P32_K, tr, x, y, P32_BATCH,
        card, lambda c: {"fused_sgd_momentum": c["fused_sgd_momentum"]},
        {"fused_sgd_momentum": b1})
    launches = {"fused_sgd_momentum": b1}
    routes = _p32_ranks(tr, "phase 32 (a)")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        xs = torch.from_numpy(x[:P32_BATCH]).to(P32_DEV)
        ys = torch.from_numpy(y[:P32_BATCH]).to(P32_DEV)
        plain_err = _p32_plain_step(arrays, xs, ys)
        del xs, ys
    finally:
        torch.backends.cudnn.deterministic = saved_det
    del x, y
    gc.collect()
    torch.cuda.empty_cache()
    parity = _p32_cpu_parity(arrays)
    # (b) bf16 channels-last, f32 master shards; one Adam ZeRO-1 step
    nhwc = _p32_arrays("NHWC")
    x, y = _p32_images(P32_WARM + P32_TIMED, P32_BATCH, layout="NHWC")
    _, tr = _p32_trainer(nhwc, P32_K, layout="NHWC", zero=1, dtype="bf16")
    rate_b, peak_b = _p32_timed(
        "phase 32 (b) ZeRO-1 bf16 NHWC K=%d" % P32_K, tr, x, y, P32_BATCH,
        card, lambda c: {"fused_sgd_momentum": c["fused_sgd_momentum"]},
        {"fused_sgd_momentum": b1})
    launches["fused_sgd_momentum"] += b1
    scale, good, skipped = tr.loss_scale_state()
    _p32_ranks(tr, "phase 32 (b)")
    print("phase 32 (b): loss scale %.1f, good steps %d, skipped %d; live "
          "params %s, masters f32 (shard,) per rank"
          % (scale, good, skipped, tr._zero_flat.dtype))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    _, tr = _p32_trainer(nhwc, P32_K, layout="NHWC", opt="adam",
                         params={"learning_rate": 1e-3, "wd": 1e-4},
                         zero=1, dtype="bf16")
    fo.reset_launch_counts()
    loss = float(tr.step(torch.from_numpy(x[:P32_BATCH]).to(P32_DEV),
                         torch.from_numpy(y[:P32_BATCH]).to(P32_DEV)))
    tr.flush()
    b3 = fo.launch_counts()["fused_adam"]
    if b3 != P32_K or not np.isfinite(loss):
        raise RuntimeError("phase 32 (b): Adam ZeRO-1 step launched B3 %d "
                           "times (want %d), loss %r" % (b3, P32_K, loss))
    launches["fused_adam"] = b3
    print("phase 32 (b): one Adam ZeRO-1 bf16 step, loss %.4f, fused_adam "
          "launches %d (one per rank)" % (loss, b3))
    del tr, x, y, nhwc
    gc.collect()
    torch.cuda.empty_cache()
    # (c) grad_accum and (d) checkpoints, cuDNN deterministic
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(prefix="p32_")
    try:
        accum = _p32_grad_accum(arrays)
        held = _p32_checkpoints(arrays, tmp, card)
    finally:
        torch.backends.cudnn.deterministic = saved_det
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    # (e) the TransformerLM over data x sequence, zero=1
    lm, ln, rate_e = _p32_lm(card)
    launches["fused_sgd_momentum"] += lm["fused_sgd_momentum"]
    launches["fused_layer_norm"] = ln
    for n in FLASH_KERNELS:
        launches[n] = lm[n + "/wgmma"]
    gc.collect()
    torch.cuda.empty_cache()
    # (f) NCCL at world size 1
    _p32_nccl()
    RUNS["phase 32"] = dict(rate_a=rate_a, peak_a=peak_a, rate_b=rate_b,
                            peak_b=peak_b, routes=routes, plain=plain_err,
                            parity=parity, accum=accum, held=held,
                            rate_e=rate_e)
    print("phase 32: launches on the phase's path %s; %.1f s (the script "
          "so far %.1f s) [%s]" % (launches, time.monotonic() - t_phase,
                                   time.monotonic() - T_START, card))
    return launches


# -- slice 26: the parameter server and the launcher --------------------------
P33_DEV = "cuda"
P33_BATCH, P33_STEPS, P33_SIDE = 128, 8, 224   # (a): per worker
P33_PLAIN_TOL, P33_FIRST_TOL = 1e-7, 1e-4
P33_ASYNC_BATCH, P33_ASYNC_RECORDS = 32, 64    # (b): 2 batches a worker
P33_CHAOS = "kvstore.server_apply:13:kill"     # (c)
P33_BW_MB = 64                                 # (d)
P33_TIMEOUT = 600

_P33_SYNC_WORKER = """
import hashlib, json, sys, time
import numpy as np
import torch
from mxnet_tpu_torch import kvstore
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.utils import from_jax_params
from mxnet_tpu_torch.ops import fused_optimizer as fo
from mxnet_tpu_torch.parallel import DataParallelTrainer
out, arrays, data, dev = sys.argv[1:5]
steps, batch = int(sys.argv[5]), int(sys.argv[6])
cuda = dev == "cuda"
sync = torch.cuda.synchronize if cuda else (lambda: None)
kv = kvstore.create("dist_sync")
r = kv.rank
d = np.load(data)
net = from_jax_params(vision.resnet50_v1(), dict(np.load(arrays)),
                      device=dev)
tr = DataParallelTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                         {"learning_rate": 0.05, "momentum": 0.9,
                          "wd": 1e-4}, kvstore=kv, device=dev)
names = [n for n, p in net.collect_params().items() if p.grad_req != "null"]
exch = []
exchange = tr._dist_exchange

def timed(loss):
    sync()
    t0 = time.perf_counter()
    got = exchange(loss)
    sync()
    exch.append(time.perf_counter() - t0)
    return got
tr._dist_exchange = timed

def flat():
    return torch.cat([net.collect_params()[n].tensor().detach().reshape(-1)
                      for n in names])

def digest(v):
    i = v.view(torch.int32).to(torch.int64)
    return "%d:%d" % (int(i.sum()), int((i * torch.arange(
        1, i.numel() + 1, device=i.device)).sum()))
rows = slice(r * batch, (r + 1) * batch)
xs = [torch.from_numpy(d["x"][i][rows]).to(dev) for i in range(2)]
ys = [torch.from_numpy(d["y"][s][rows]).to(dev) for s in range(steps)]
fo.reset_launch_counts()
if cuda:
    torch.cuda.reset_peak_memory_stats()
losses, b1, digests, kept = [], [], [], []
for s in range(steps):
    if s == 1:
        sync()
        t0 = time.perf_counter()
    before = fo.launch_counts()["fused_sgd_momentum"]
    losses.append(float(tr.step(xs[s % 2], ys[s])))
    b1.append(fo.launch_counts()["fused_sgd_momentum"] - before)
    v = flat()
    digests.append(digest(v))
    if r == 0:
        kept.append(v)          # a fresh copy on the card: saved below
sync()
secs = time.perf_counter() - t0
for s, v in enumerate(kept):
    np.save("%s/step_%d.npy" % (out, s), v.cpu().numpy())
import torch.distributed as dist
json.dump({"rank": r, "losses": losses, "b1": b1, "digests": digests,
           "images_s": 2 * batch * (steps - 1) / secs,
           "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                        if cuda else 0.0),
           "exchange_ms": sorted(exch)[len(exch) // 2] * 1e3,
           "backend": dist.get_backend(),
           "rule": kvstore.backend_rule(kv.num_workers)[1],
           "buckets": len(tr._g_flat)},
          open("%s/rank%d.json" % (out, r), "w"))
kv.barrier()
"""

_P33_ASYNC_WORKER = """
import hashlib, json, sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.tools import train_imagenet
out = sys.argv[1]
mx.random.seed(0)
np.random.seed(0)
mod = train_imagenet.main(sys.argv[2:])   # the server rank exits inside
kv = mod._kvstore
kv.barrier()
blob = b"".join(kv._ps_client.pull_array(i).tobytes()
                for i in range(len(mod._param_names)))
json.dump({"rank": kv.rank, "pushes": kv._push_step,
           "keys": len(mod._param_names),
           "digest": hashlib.sha256(blob).hexdigest()},
          open("%s/async_%d.json" % (out, kv.rank), "w"))
kv.barrier()
kv.close()
"""

_P33_MNIST_WORKER = """
import sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.tools import train_mnist
out = sys.argv[1]
mx.random.seed(0)
np.random.seed(0)
mod = train_mnist.main(sys.argv[2:])      # the server rank exits inside
kv = mod._kvstore
with open(out, "wb") as f:
    f.write(b"".join(kv._ps_client.pull_array(i).tobytes()
                     for i in range(len(mod._param_names))))
print("P33C pushes %d failovers %d reconnects %d"
      % (kv._push_step, kv._ps_client.failovers, kv._ps_client.reconnects))
kv.close()
"""


def _p33_launch(args, label, timeout=P33_TIMEOUT):
    """Run ``python -m mxnet_tpu_torch.tools.launch ARGS`` from the
    repository root in its own session (every rank it starts is stopped
    with it on a timeout); returns (stdout, stderr)."""
    import os
    import signal
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + \
        os.pathsep + env.get("PYTHONPATH", "")
    env.pop("MXTPU_CHAOS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch"] + args,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError("%s: the launch ran past %d s" % (label, timeout))
    if proc.returncode:
        raise RuntimeError("%s: the launch exited %d:\n%s\n%s"
                           % (label, proc.returncode, out[-3000:],
                              err[-3000:]))
    return out, err


def _p33_data(steps, batch, side, seed=33):
    """Two global batches of seeded images (cycled) and each step's
    labels: what the workers split and the replay runs."""
    rng = np.random.RandomState(seed)
    x = rng.rand(2, 2 * batch, 3, side, side).astype(np.float32)
    y = rng.randint(0, 1000, (steps, 2 * batch)).astype(np.int64)
    return x, y


def _p33_replay(arrays, x, y, steps, batch, dev, each_step):
    """The reference's ``_dist_step`` over two workers, in one process:
    each half's mean-loss gradient (BatchNorm on its own batch, and rank
    0's running statistics: the second half runs on a copy), their sum
    times 1/2, the fused update (B1).  Calls ``each_step(s, flat
    parameters on the host)`` after every step; returns (losses, B1's
    max |error| against its plain version at the first step)."""
    import torch
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.utils import from_jax_params
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    from mxnet_tpu_torch.parallel import DataParallelTrainer
    net = from_jax_params(vision.resnet50_v1(), arrays, device=dev)
    tr = DataParallelTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                             dict(SGD_PARAMS), device=dev)
    names = [n for n, p in net.collect_params().items()
             if p.grad_req != "null"]
    xs = [torch.from_numpy(x[i]).to(dev) for i in range(2)]
    losses, b1_err = [], None
    for s in range(steps):
        xb, yb = xs[s % 2], torch.from_numpy(y[s]).to(dev)
        if not tr._ready:
            tr._setup(xb)
        lr = tr._next_step()
        net.train(True)
        halves, ls = [], []
        for h in (0, 1):
            rows = slice(h * batch, (h + 1) * batch)
            saved = [a.detach().clone() for a in tr._aux_tensors] \
                if h else None
            for gf in tr._g_flat:
                gf.zero_()
            loss = tr._forward_loss(net, xb[rows], yb[rows])
            loss.backward()
            ls.append(loss.detach())
            halves.append([gf.detach().clone() for gf in tr._g_flat])
            if saved is not None:
                with torch.no_grad():
                    for a, v in zip(tr._aux_tensors, saved):
                        a.copy_(v)
        with torch.no_grad():
            for gf, g0, g1 in zip(tr._g_flat, *halves):
                gf.copy_((g0 + g1) * 0.5)
        losses.append(float((ls[0] + ls[1]) * 0.5))
        if s == 0:
            opt = tr._opt
            w, g, m = (tr._w_flat[0].detach().clone(),
                       tr._g_flat[0].detach().clone(),
                       tr._states[0].detach().clone())
            pw, pm = fo.fused_sgd_momentum_reference(
                w, g, m, fo._scalars(lr, 1.0, 1.0, w.device),
                momentum=opt.momentum, wd=opt._get_wd(0),
                rescale_grad=opt.rescale_grad,
                clip_gradient=opt.clip_gradient)
        tr._apply_groups(lr, tr._step_count)
        if s == 0:
            b1_err = max(float((tr._w_flat[0] - pw).abs().max()),
                         float((tr._states[0] - pm).abs().max()))
        each_step(s, torch.cat([net.collect_params()[n].tensor().detach()
                                .reshape(-1) for n in names]).cpu().numpy())
    net.train(False)
    return losses, b1_err


def _p33_sync_launch(tmp, card, dev=None, steps=P33_STEPS, batch=P33_BATCH,
                     side=P33_SIDE):
    """(a)'s launch of two dist_sync workers: bitwise equal after every
    step and B1 once a step in each; prints their rates.  Returns what
    :func:`_p33_sync_replay` needs (the phase runs it beside (b) and
    (c))."""
    import json
    import os
    dev = P33_DEV if dev is None else dev
    os.makedirs(tmp, exist_ok=True)
    arrays = _p32_arrays() if side == P32_SIDE else _p33_small_arrays(side)
    x, y = _p33_data(steps, batch, side)
    apath, dpath = os.path.join(tmp, "arrays.npz"), os.path.join(
        tmp, "data.npz")
    np.savez(apath, **arrays)
    np.savez(dpath, x=x, y=y)
    script = os.path.join(tmp, "sync_worker.py")
    with open(script, "w") as f:
        f.write(_P33_SYNC_WORKER)
    t0 = time.monotonic()
    _, err = _p33_launch(["-n", "2", "--launcher", "local", sys.executable,
                          script, tmp, apath, dpath, dev, str(steps),
                          str(batch)], "phase 33 (a)")
    wall = time.monotonic() - t0
    res = [json.load(open(os.path.join(tmp, "rank%d.json" % r)))
           for r in (0, 1)]
    if res[0]["digests"] != res[1]["digests"]:
        raise RuntimeError("phase 33 (a): the workers' parameters differ "
                           "after a step: %r / %r"
                           % (res[0]["digests"], res[1]["digests"]))
    # (on the host, as in a dry run, the wrapper runs its plain version
    # and counts no launch)
    want_b1 = [1 if dev == "cuda" else 0] * steps
    for rr in res:
        if rr["b1"] != want_b1 or rr["buckets"] != 1:
            raise RuntimeError("phase 33 (a): rank %d launched B1 %r over "
                               "%d bucket(s) (want once a step)"
                               % (rr["rank"], rr["b1"], rr["buckets"]))
    first = np.load(os.path.join(tmp, "step_0.npy"))
    last = np.load(os.path.join(tmp, "step_%d.npy" % (steps - 1)))
    if first.tobytes() == last.tobytes():
        raise RuntimeError("phase 33 (a): the parameters did not move")
    r0 = res[0]
    print("phase 33 (a): dist_sync ResNet-50, 2 workers x batch %d on one "
          "card, %d steps: %.1f images/s (both workers, steps 2-%d), peak "
          "memory %.2f / %.2f GiB a worker; the reduction over %s (%s), "
          "%.3f ms a step (median; push + pull of %d floats); parameters "
          "bitwise equal after every step; B1 once a step in each worker "
          "(%r / %r); %.1f s for the launch [%s]"
          % (batch, steps, r0["images_s"], steps, r0["peak_gib"],
             res[1]["peak_gib"], r0["backend"],
             r0["rule"], r0["exchange_ms"],
             first.size + 1, r0["b1"], res[1]["b1"], wall, card), flush=True)
    if r0["backend"] != "gloo" or "mxnet_tpu_torch.kvstore: rank 0 of 2 " \
            "over gloo" not in err:
        raise RuntimeError("phase 33 (a): the rule put two ranks on one "
                           "card over %r" % r0["backend"])
    RUNS["phase 33 (a)"] = dict(images_s=r0["images_s"],
                                exchange_ms=r0["exchange_ms"])
    return dict(tmp=tmp, dev=dev, steps=steps, batch=batch, arrays=arrays,
                x=x, y=y, losses=r0["losses"],
                b1=sum(rr["b1"][i] for rr in res for i in range(steps)))


def _p33_sync_replay(run):
    """(a)'s replay of ``_dist_step`` in this process: every step's loss
    (relative) and parameters (absolute) within ``P33_FIRST_TOL`` of
    rank 0's, and B1 vs its plain version within ``P33_PLAIN_TOL``.
    Returns B1's launches in the workers."""
    import os
    import torch
    steps, got = run["steps"], run["losses"]
    d_steps = []

    def each_step(s, v):
        path = os.path.join(run["tmp"], "step_%d.npy" % s)
        d_steps.append(float(np.abs(np.load(path) - v).max()))
        os.remove(path)
    # under torch's default precision flags (the workers')
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        losses, b1_err = _p33_replay(run["arrays"], run["x"], run["y"],
                                     steps, run["batch"], run["dev"],
                                     each_step)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    d_loss = [abs(a - b) / abs(b) for a, b in zip(got, losses)]
    print("phase 33 (a): the one-process replay of _dist_step, every one "
          "of %d steps: first-step loss %.6f vs %.6f; loss max relative "
          "difference %.3g, max |dparam| %.3g (tol %g; bitwise at %d of %d "
          "steps); B1 vs its plain version %.3g (tol %g)"
          % (steps, got[0], losses[0], max(d_loss), max(d_steps),
             P33_FIRST_TOL, sum(d == 0 for d in d_steps), steps, b1_err,
             P33_PLAIN_TOL), flush=True)
    if len(d_steps) != steps or max(d_loss + d_steps) > P33_FIRST_TOL:
        raise RuntimeError("phase 33 (a): the workers are off the replay: "
                           "loss %r, parameters %r (tol %g)"
                           % (d_loss, d_steps, P33_FIRST_TOL))
    if b1_err is None or b1_err > P33_PLAIN_TOL:
        raise RuntimeError("phase 33 (a): B1 vs plain %r" % b1_err)
    return run["b1"]


def _p33_small_arrays(side):
    """resnet50_v1's seeded weights resolved at a small input (a dry run
    of the phase on the host)."""
    import torch
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import vision
    net = vision.resnet50_v1()
    net.initialize(initializer.Xavier(), ctx="cpu",
                   rng=np.random.RandomState(0))
    with torch.no_grad():
        net(torch.zeros(1, 3, side, side))
    return {n: p.tensor().detach().numpy().copy()
            for n, p in net.collect_params().items()}


def _p33_async(tmp, card, ctx="gpu", batch=P33_ASYNC_BATCH,
               records=P33_ASYNC_RECORDS, side=P33_SIDE):
    """(b) train_imagenet over dist_async, a server process beside two
    workers; the server's WAL accounting and final snapshot."""
    import json
    import os
    from mxnet_tpu_torch.io import bench
    from mxnet_tpu_torch.resilience import checkpoint as ckpt
    from mxnet_tpu_torch.resilience.server_state import ServerStateStore
    os.makedirs(tmp, exist_ok=True)
    rec, _ = bench.fixture_rec(records, tmp)
    state = os.path.join(tmp, "ps_state")
    script = os.path.join(tmp, "async_worker.py")
    with open(script, "w") as f:
        f.write(_P33_ASYNC_WORKER)
    t0 = time.monotonic()
    _, err = _p33_launch(
        ["-n", "2", "-s", "1", "--launcher", "local", "--ps-state-dir",
         state, sys.executable, script, tmp, "--data-train", rec,
         "--kv-store", "dist_async", "--batch-size", str(batch),
         "--num-epochs", "1", "--num-examples", str(records),
         "--image-shape", "3,%d,%d" % (side, side), "--ctx", ctx],
        "phase 33 (b)")
    wall = time.monotonic() - t0
    res = [json.load(open(os.path.join(tmp, "async_%d.json" % r)))
           for r in (0, 1)]
    payload, records_after = ServerStateStore(state).recover()
    snaps = ckpt.list_checkpoints(state)
    applied = payload["applied"]
    seq = int(payload["seq"]) + len(records_after)
    keys = res[0]["keys"]
    pushes = sum(rr["pushes"] for rr in res)
    want_seq = keys + 2 + 2 + pushes   # inits, set_optimizer, hellos, pushes
    import hashlib
    store = hashlib.sha256(b"".join(
        ckpt.decode_array(payload["store"][i]).tobytes()
        for i in range(keys))).hexdigest()
    banner = [l for l in err.splitlines() if "standalone PS" in l]
    print("phase 33 (b): train_imagenet --kv-store dist_async, 2 workers x "
          "%d batches of %d, one server process (a host role by design: %s); "
          "pushes sent %d / %d, the server's last push_step a rank %r, WAL "
          "sequence %d (want %d keys + 2 optimizers + 2 incarnations + %d "
          "pushes = %d); workers' pulled weights equal: %s; the final "
          "snapshot (seq %d, %d snapshot(s), %d records after it) holds "
          "them: %s; %.1f s [%s]"
          % (records // batch, batch, "; ".join(banner)[:200],
             res[0]["pushes"], res[1]["pushes"],
             {r: max(m.values()) for r, m in applied.items()}, seq, keys,
             pushes, want_seq, res[0]["digest"] == res[1]["digest"],
             int(payload["seq"]), len(snaps), len(records_after),
             store == res[0]["digest"], wall, card))
    if res[0]["digest"] != res[1]["digest"] or store != res[0]["digest"]:
        raise RuntimeError("phase 33 (b): the pulled weights differ")
    if seq != want_seq or records_after or \
            {r: max(m.values()) for r, m in applied.items()} != \
            {rr["rank"]: rr["pushes"] for rr in res}:
        raise RuntimeError("phase 33 (b): the server's WAL does not count "
                           "each push once")
    RUNS["phase 33 (b)"] = dict(pushes=pushes, seq=seq, wall=wall)


def _p33_failover(tmp, card, ctx_flag=()):
    """(c) train_mnist over dist_async with the server SIGKILLed at its
    13th applied push and respawned by the launcher, against the same run
    uncrashed."""
    import concurrent.futures
    import os
    import re
    os.makedirs(tmp, exist_ok=True)
    script = os.path.join(tmp, "mnist_worker.py")
    with open(script, "w") as f:
        f.write(_P33_MNIST_WORKER)
    # MNIST-layout idx files: MNISTIter shuffles from its fixed seed, so
    # two runs see the same batches (the synthetic fallback's shuffle is
    # unseeded, as the reference's)
    mnist = os.path.join(tmp, "mnist")
    os.makedirs(mnist)
    _p27_mnist_files(mnist)

    def fleet(tag):
        """One launch; (its output, seconds, the pulled bytes)."""
        out = os.path.join(tmp, tag + ".bin")
        args = ["-n", "1", "-s", "1", "--launcher", "local",
                "--restart-failed", "1", "--ps-state-dir",
                os.path.join(tmp, "state_" + tag), "--env",
                "MXTPU_PS_RETRIES=12", "--env-server",
                "MXTPU_PS_SNAPSHOT_EVERY=5"]
        if tag == "crashed":
            args += ["--env-server", "MXTPU_CHAOS=" + P33_CHAOS]
        t0 = time.monotonic()
        sout, err = _p33_launch(
            args + [sys.executable, script, out, "--kv-store", "dist_async",
                    "--num-epochs", "1", "--data-dir", mnist]
            + list(ctx_flag),
            "phase 33 (c) " + tag)
        with open(out, "rb") as f:
            return sout + err, time.monotonic() - t0, f.read()

    # the two runs are independent fleets (their own ports, state dirs
    # and files): run them side by side
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = {tag: pool.submit(fleet, tag)
                for tag in ("uncrashed", "crashed")}
        runs = {tag: f.result() for tag, f in runs.items()}
    logs = {tag: r[:2] for tag, r in runs.items()}
    blobs = {tag: r[2] for tag, r in runs.items()}
    text = logs["crashed"][0]
    m = re.search(r"generation=2, recovered_wal=(\d+), recovery_s=([0-9.]+)",
                  text)
    fo = re.search(r"P33C pushes (\d+) failovers (\d+)", text)
    same = blobs["crashed"] == blobs["uncrashed"]
    print("phase 33 (c): train_mnist --kv-store dist_async, server "
          "SIGKILLed by %s and respawned by --restart-failed 1: %s pushes, "
          "%s failover(s) seen by the worker; the respawned server replayed "
          "%s WAL record(s) in %s s; final parameters byte-identical to the "
          "uncrashed run: %s (%d bytes); %.1f s / %.1f s [%s]"
          % (P33_CHAOS, fo and fo.group(1), fo and fo.group(2),
             m and m.group(1), m and m.group(2), same, len(blobs["crashed"]),
             logs["uncrashed"][1], logs["crashed"][1], card))
    if m is None or fo is None or int(fo.group(2)) != 1 or \
            "restarting" not in text:
        raise RuntimeError("phase 33 (c): no failover happened:\n%s"
                           % text[-3000:])
    if not same:
        raise RuntimeError("phase 33 (c): the crashed run's parameters "
                           "differ from the uncrashed run's")
    RUNS["phase 33 (c)"] = dict(replayed=int(m.group(1)),
                                recovery_s=float(m.group(2)))


def _p33_bandwidth(card, device=None, size_mb=P33_BW_MB):
    """(d) tools/bandwidth on the card."""
    from mxnet_tpu_torch.tools import bandwidth
    argv = ["--size-mb", str(size_mb), "--iters", "10"]
    if device:
        argv += ["--device", device]
    recs = bandwidth.main(argv)
    got = {(r["primitive"], r["route"], r["ranks"]) for r in recs}
    want = {(p, route, k) for p in ("all_reduce_mean", "all_gather",
                                    "reduce_scatter_mean")
            for route, k in (("in_process", 2), ("in_process", 4),
                             ("nccl" if device is None else "gloo", 1),
                             ("gloo", 2))}
    want |= {("push_pull", "dist_sync", 2), ("push_pull", "dist_async", 2)}
    if device is None:
        want |= {("all_reduce_sum", "gloo_host_copy", 2),
                 ("all_reduce_sum", "gloo_cuda_direct", 2)}
    if not want <= got:
        raise RuntimeError("phase 33 (d): missing %r" % sorted(want - got))
    direct = [r for r in recs if r["route"] == "gloo_cuda_direct"]
    print("phase 33 (d): bandwidth at %g MB: %s; gloo with a CUDA tensor "
          "handed over directly: %s [%s]"
          % (size_mb, "; ".join("%s %s K=%d %.3f ms %.2f GB/s"
                                % (r["primitive"], r["route"], r["ranks"],
                                   r["ms"], r["gbps"])
                                for r in recs if "ms" in r),
             direct[0].get("error", "takes it (%.3f ms)"
                           % direct[0].get("ms", 0)) if direct else "n/a",
             card))
    RUNS["phase 33 (d)"] = recs


def _p33_context(card):
    """(e) C17 on the card."""
    import torch
    import mxnet_tpu_torch as mx
    with mx.cpu():
        a = mx.nd.zeros((2,))
    with mx.gpu(0):
        b = mx.nd.zeros((2,))
        inner = mx.current_context()
    free, total = mx.gpu_memory_info(0)
    tfree, ttotal = torch.cuda.mem_get_info(0)
    print("phase 33 (e): with mx.cpu(): %s; with mx.gpu(0): %s (current "
          "%s); gpu_memory_info(0) (%d, %d) vs torch.cuda.mem_get_info "
          "(%d, %d) [%s]" % (a.context, b.context, inner, free, total, tfree,
                             ttotal, card))
    if a.context != mx.cpu() or b.context.type != "cuda" or \
            inner != mx.gpu(0) or total != ttotal or \
            abs(free - tfree) > 1 << 28:
        raise RuntimeError("phase 33 (e): Context scopes or memory info "
                           "off")


def phase_parameter_server():
    """Phase 33: the parameter server and the launcher (module
    docstring).  Returns B1's launches over (a)'s workers."""
    import concurrent.futures
    import os
    import shutil
    import tempfile
    t_phase = time.monotonic()
    card = _p32_card()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p33_")
    try:
        run = _p33_sync_launch(os.path.join(tmp, "a"), card)
        # (b) and (c) are separate fleets on the host (the card barely
        # used): side by side, their walls overlap, and (a)'s replay (its
        # checks, no timing) runs here meanwhile
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            parts = [pool.submit(_p33_async, os.path.join(tmp, "b"), card),
                     pool.submit(_p33_failover, os.path.join(tmp, "c"),
                                 card)]
            b1 = _p33_sync_replay(run)
            for f in parts:
                f.result()
        _p33_bandwidth(card)
        _p33_context(card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("phase 33: B1 launched %d times in the dist_sync workers; %.1f s "
          "(the script so far %.1f s) [%s]"
          % (b1, time.monotonic() - t_phase, time.monotonic() - T_START,
             card))
    return b1


# -- slice 27: model-axis tensor parallelism (A7(a)) and A1(f) ----------------
P34_PLAN = dict(data=2, model=2, sequence=2)
P34_STEPS, P34_LR = 6, 0.1
# one data rank's activations at batch 32 over MeshPlan(data=2, model=2,
# sequence=2): (Km, Ks, B / Kd, T / Ks, d) — the rows B4 normalizes
P34_LN_SHAPE = (2, 2, TRAIN_LM_BATCH // 2, CFG["seq_len"] // 2,
                CFG["d_model"])
# its flash pairings per layer: every model rank's local heads fold into
# the batch of one launch, Km * B / Kd * H / Km heads; hop 0 the diagonal
# of both sequence ranks, hop 1 rank 1 against chunk 0
P34_FLASH = [(2 * TRAIN_LM_BATCH // 2 * CFG["n_heads"], 512, 512, 16, True),
             (TRAIN_LM_BATCH // 2 * CFG["n_heads"], 512, 512, 16, False)]
# TP decode's concurrent requests and their longest prompt (as phase 2's)
P34_REQUESTS, P34_PROMPT_MAX = 8, 200
P35_BATCH, P35_SIDE = 8, 224


def _p34_args(zero, steps=P34_STEPS, batch=TRAIN_LM_BATCH, layers=None):
    """``tools/train_transformer_lm``'s flags at the documented width."""
    import argparse
    return argparse.Namespace(
        steps=steps, batch=batch, seq_len=CFG["seq_len"],
        vocab=CFG["vocab_size"], d_model=CFG["d_model"],
        heads=CFG["n_heads"], layers=layers or CFG["n_layers"],
        d_ff=CFG["d_ff"], lr=P34_LR, attention="ring", seed=0,
        log_every=10 ** 9, chaos="", report=False, device="cuda",
        zero=zero, **P34_PLAN)


def _p34_want(zero):
    """Launches a step of B1, B4 and B5-B7 over P34_PLAN, by formula."""
    kd, ks, layers = P34_PLAN["data"], P34_PLAN["sequence"], CFG["n_layers"]
    want = {"fused_sgd_momentum": kd * zero,
            "fused_layer_norm": kd * (2 * layers + 1)}
    for n in FLASH_KERNELS:
        want[n + "/wgmma"] = kd * layers * ks
    return want


def _p34_train(card):
    """(a): ``train()`` of ``tools/train_transformer_lm`` at P34_PLAN,
    zero=0 then zero=1; tokens/s, peak memory, the loss drop and the
    launches a step against their formulas.  Returns the launches."""
    import torch
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    from mxnet_tpu_torch.ops import pallas_kernels as pk
    from mxnet_tpu_torch.tools import train_transformer_lm as tool
    total, losses = {}, {}
    for zero in (0, 1):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pk.reset_launch_counts()
        fo.reset_launch_counts()
        stats = tool.train(_p34_args(zero), logger=lambda *a: None)
        peak = torch.cuda.max_memory_allocated()
        counts = dict(pk.launch_counts(), **fo.launch_counts())
        want = _p34_want(zero)
        got = {k: counts.get(k, 0) for k in want}
        for k in want:
            total[k.split("/")[0]] = total.get(k.split("/")[0], 0) + got[k]
        formula = ("B1 = data x zero = %d; B4 = data x (2 layers + 1) = "
                   "%d; B5-B7 = data x layers x sequence = %d each"
                   % (want["fused_sgd_momentum"], want["fused_layer_norm"],
                      want["flash_dq/wgmma"]))
        print("phase 34 (a): train_transformer_lm %s, zero=%d, batch %d x "
              "%d, %d steps: %.1f tokens/s (%.1f after the first step); "
              "peak memory %.3f GiB; loss %.4f -> %.4f (losses %s); "
              "launches a step %s (%s) [%s]"
              % (stats["plan"], zero, TRAIN_LM_BATCH, CFG["seq_len"],
                 P34_STEPS, stats["tokens_per_sec"],
                 stats["tokens_per_sec_steady"], peak / 2 ** 30,
                 stats["head_loss"], stats["final_loss"],
                 ["%.4f" % v for v in stats["losses"]],
                 {k: v / P34_STEPS for k, v in got.items()}, formula, card))
        if got != {k: v * P34_STEPS for k, v in want.items()}:
            raise RuntimeError("phase 34 (a): zero=%d launches %r, want %r "
                               "a step" % (zero, got, want))
        if not np.isfinite(stats["losses"]).all() \
                or not stats["final_loss"] < stats["head_loss"]:
            raise RuntimeError("phase 34 (a): losses %r" % stats["losses"])
        RUNS["phase 34 zero=%d" % zero] = stats["tokens_per_sec_steady"]
        losses[zero] = stats["losses"]
    dl = float(np.abs(np.subtract(losses[0], losses[1])).max())
    print("phase 34 (a): zero=0 vs zero=1 over %d steps: max |dloss| %.3g "
          "(tol %g)" % (P34_STEPS, dl, LM_LOSS_TOL_SEQ))
    if dl > LM_LOSS_TOL_SEQ:
        raise RuntimeError("phase 34 (a): zero=0 and zero=1 losses differ "
                           "by %.3g" % dl)
    return total


def _p34_parity():
    """(b): two steps at one layer of {model: 2} and {data: 2, model: 2,
    sequence: 2} at zero=0, and of the latter at zero=1 (B1 on each data
    rank's strided (Km, shard) columns), against the collapsed plan and
    the zero=0 run on the card and against the CPU."""
    import torch
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    from mxnet_tpu_torch.parallel import DataParallelTrainer, MeshPlan
    from mxnet_tpu_torch.transformer import TransformerLM, TransformerLMConfig
    (x, y), = _lm_batches(1, 2, seed=13)
    runs = {}
    for key, plan, device, zero in (
            ("m2_cuda", MeshPlan(model=2), "cuda", 0),
            ("m2_cpu", MeshPlan(model=2), "cpu", 0),
            ("d2m2s2_cuda", MeshPlan(**P34_PLAN), "cuda", 0),
            ("d2m2s2_cpu", MeshPlan(**P34_PLAN), "cpu", 0),
            ("d2m2s2z1_cuda", MeshPlan(**P34_PLAN), "cuda", 1),
            ("d2m2s2z1_cpu", MeshPlan(**P34_PLAN), "cpu", 1),
            ("collapsed_cuda", MeshPlan(), "cuda", 0)):
        tr = DataParallelTrainer(
            TransformerLM(TransformerLMConfig(**dict(CFG, n_layers=1),
                                              attention="ring")), None,
            "sgd", dict(LM_SGD), mesh_plan=plan, zero=zero, device=device)
        fo.reset_launch_counts()
        losses = [float(tr.step(x, y)) for _ in range(2)]
        b1 = fo.launch_counts()["fused_sgd_momentum"]
        want = 2 * plan.size("data") * zero if device == "cuda" else 0
        if not np.isfinite(losses).all() or b1 != want:
            raise RuntimeError("phase 34 (b) %s: losses %r, B1 launched %d "
                               "times (want %d)" % (key, losses, b1, want))
        runs[key] = (losses, tr.mesh_params())
        del tr
    torch.cuda.empty_cache()
    bad = []
    for a, b, ltol in (("m2_cuda", "collapsed_cuda", LM_LOSS_TOL_SEQ),
                       ("d2m2s2_cuda", "collapsed_cuda", LM_LOSS_TOL_SEQ),
                       ("d2m2s2z1_cuda", "d2m2s2_cuda", LM_LOSS_TOL_SEQ),
                       ("m2_cuda", "m2_cpu", LM_LOSS_TOL_DEVICE),
                       ("d2m2s2_cuda", "d2m2s2_cpu", LM_LOSS_TOL_DEVICE),
                       ("d2m2s2z1_cuda", "d2m2s2z1_cpu",
                        LM_LOSS_TOL_DEVICE)):
        dl = max(abs(p - q) for p, q in zip(runs[a][0], runs[b][0]))
        dp = max((float(np.abs(runs[a][1][n] - runs[b][1][n]).max()), n)
                 for n in runs[a][1])
        print("phase 34 (b): one layer, batch 2, 2 steps, %s vs %s: max "
              "|dloss| %.3g (tol %g), max |dparam| %.3g (%s) (tol %g)"
              % (a, b, dl, ltol, dp[0], dp[1], LM_PARAM_TOL))
        if dl > ltol or dp[0] > LM_PARAM_TOL:
            bad.append("%s vs %s: %.3g / %.3g" % (a, b, dl, dp[0]))
    print("phase 34 (b): losses %s" % {k: ["%.7f" % v for v in r[0]]
                                       for k, r in runs.items()})
    if bad:
        raise RuntimeError("phase 34 (b): %s" % "; ".join(bad))


def _p34_b1(card, gen):
    """(b): B1 at the length ZeRO-1 gives it over P34_PLAN, one data
    rank's (Km, shard) columns, Km * shard floats, at data rank 0's and
    data rank 1's offsets into the flat space, against its plain version
    in every OPT_CASES case; timed beside the plain version, the library
    call and the bound."""
    import torch
    from mxnet_tpu_torch.parallel import MeshPlan
    from mxnet_tpu_torch.transformer import TransformerLM, TransformerLMConfig
    from mxnet_tpu_torch.transformer.step import TPZeroPlan
    plan = MeshPlan(**P34_PLAN)
    zp = TPZeroPlan(TransformerLM(TransformerLMConfig(
        **CFG, attention="ring")).mesh_program(plan), plan.size("data"))
    n = plan.size("model") * zp.shard
    name = "fused_sgd_momentum"
    worst = 0.0
    for offset in sorted({0, n % 4}):
        base = [_placed(torch.randn(n, device="cuda", generator=gen), offset)
                for _ in range(4)]
        for case in OPT_CASES:
            s = torch.tensor([0.05, case[3], case[4]], device="cuda")
            want = _opt_plain(name, base, s, case)
            got = _opt_kernel(name, [_placed(a, offset) for a in base], 0.05,
                              case)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=OPT_TOL, atol=OPT_TOL)
                worst = max(worst, float((g - w).abs().max()))
    w, g, m, v = (torch.randn(n, device="cuda", generator=gen)
                  for _ in range(4))
    case = (None, 1e-4, 1.0, torch.tensor(1.0, device="cuda"),
            torch.tensor(1.0, device="cuda"))
    lr_t = torch.tensor(0.05, device="cuda")
    s = torch.tensor([0.05, 1.0, 1.0], device="cuda")
    # CUDA-graph replays, as phase 4 times B1: at this length one eager
    # call is shorter than the host's launch cost
    t = {"kernel": _time_ms(lambda: _opt_kernel(name, (w, g, m, v), lr_t,
                                                case), iters=20, replays=5),
         "plain": _time_ms(lambda: _opt_plain(name, (w, g, m, v), s, case),
                           iters=20, replays=5),
         "library": _time_ms(_opt_library(name, w, g), iters=20,
                             replays=5)}
    per_elem = OPT_KERNELS[name][0]
    print("phase 34 (b): %s at one data rank's ZeRO-1 shard over %s, (%d,) "
          "= Km %d x shard %d, offsets %s: max |err| %.3g over %d cases "
          "(tol %g); device time (CUDA graph) kernel %.5f ms, plain %.5f "
          "ms, SGD(fused=True) %.5f ms, bound %.5f ms (bytes) [%s]"
          % (name, P34_PLAN, n, plan.size("model"), zp.shard,
             sorted({0, n % 4}), worst, len(OPT_CASES), OPT_TOL,
             t["kernel"], t["plain"], t["library"],
             per_elem * n / HBM_BYTES_PER_S * 1e3, card))


def _p34_kernels(card):
    """(b): B1 at its ZeRO-1 shard (``_p34_b1``), B4 at one data rank's
    (Km, Ks, B, T/Ks, d) rows and B5-B7 at the hop pairings of P34_FLASH,
    each against its plain version, timed beside the plain version, the
    library call and the bound."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    from mxnet_tpu_torch.ops import pallas_kernels as pk
    gen = torch.Generator(device="cuda").manual_seed(34)
    _p34_b1(card, gen)
    x = torch.randn(P34_LN_SHAPE, device="cuda", generator=gen)
    d = P34_LN_SHAPE[-1]
    s, b = (torch.randn(d, device="cuda", generator=gen) for _ in "sb")
    got, want = fo.fused_layer_norm(x, s, b), fo.layer_norm_reference(x, s, b)
    torch.testing.assert_close(got, want, rtol=LN_TOL, atol=LN_TOL)
    err = float((got - want).abs().max())
    t = {"kernel": _event_ms(lambda: fo.fused_layer_norm(x, s, b)),
         "plain": _event_ms(lambda: fo.layer_norm_reference(x, s, b)),
         "library": _event_ms(lambda: F.layer_norm(x, (d,), s, b, 1e-5))}
    nbytes = 4 * (2 * x.numel() + 2 * d)
    print("phase 34 (b): fused_layer_norm at %s: max |err| %.3g (tol %g); "
          "kernel %.5f ms, plain %.5f ms, F.layer_norm %.5f ms, bound %.5f "
          "ms (bytes) [%s]" % (P34_LN_SHAPE, err, LN_TOL, t["kernel"],
                               t["plain"], t["library"],
                               nbytes / HBM_BYTES_PER_S * 1e3, card))
    del x, got, want
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        worst = {}
        for case in P34_FLASH:
            _flash_check(case, gen, worst)
        args = _flash_bwd_args(P34_FLASH, gen)
        plain = {"flash_forward_with_lse":
                 lambda a: pk.flash_forward_with_lse_reference(*a[:3], a[6],
                                                               a[7]),
                 "flash_dq": lambda a: pk.flash_dq_reference(*a),
                 "flash_dkv": lambda a: pk.flash_dkv_reference(*a)}
        for name in FLASH_KERNELS:
            call = _flash_call(name, "wgmma")
            ms = sum(_event_ms(lambda a=a: call(a)) for a in args)
            pms = sum(_event_ms(lambda a=a: plain[name](a), 3) for a in args)
            bound, by = _flash_tc_bound(name, P34_FLASH)[:2]
            print("phase 34 (b): %s at %s: max |err| %.3g on the wgmma "
                  "design; %.5f ms a layer, plain %.5f ms, bound %.5f ms "
                  "(%s, split TF32) [%s]"
                  % (name, P34_FLASH, worst[(name, "wgmma")], ms, pms,
                     bound, by, card))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _p34_decode(card):
    """(c): the TP decode program behind ModelFleet and Server: every
    answer equals the collapsed program's ``reference_decode``, and B4
    launched on the path."""
    from mxnet_tpu_torch.ops import fused_optimizer as fo
    from mxnet_tpu_torch.parallel import MeshPlan
    from mxnet_tpu_torch.serving import DecodeRunner, ModelFleet, Server
    from mxnet_tpu_torch.transformer import (DecodeProgram,
                                             TransformerLMConfig,
                                             from_jax_params)
    cfg = TransformerLMConfig(**CFG)
    flat = DecodeProgram(cfg, page_size=PAGE_SIZE)
    host = flat.program.init_params(0)
    prog = DecodeProgram(cfg, plan=MeshPlan(data=1, model=2),
                         page_size=PAGE_SIZE)
    t0 = time.monotonic()
    runner = DecodeRunner(prog, from_jax_params(host, "cuda"),
                          slots=SLOTS, device="cuda")
    warm = time.monotonic() - t0
    oracle = DecodeRunner(flat, from_jax_params(host, "cuda"),
                          slots=SLOTS, warmup=False, device="cuda")
    rng = np.random.RandomState(34)
    prompts = [rng.randint(0, CFG["vocab_size"], size=int(n)).tolist()
               for n in [3, P34_PROMPT_MAX] + list(rng.randint(
                   3, P34_PROMPT_MAX + 1, P34_REQUESTS - 2))]
    refs = [oracle.reference_decode(p, MAX_NEW).tolist() for p in prompts]
    fleet = ModelFleet()
    fleet.register_decode("tp", runner, max_queue=64)
    srv = Server(fleet, port=0)
    host_, port = srv.start()
    url = "http://%s:%d/decode" % (host_, port)
    results = [None] * P34_REQUESTS

    def fire(i):
        results[i] = _post(url, {"prompt": prompts[i], "model": "tp",
                                 "max_new_tokens": MAX_NEW})

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(P34_REQUESTS)]
    try:
        fo.reset_launch_counts()
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.monotonic() - t0
        ln = fo.launch_counts()["fused_layer_norm"]
    finally:
        srv.drain(timeout=120)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("phase 34 (c): a /decode request did not return")
    for i, ((code, body), ref) in enumerate(zip(results, refs)):
        if code != 200 or body["tokens"] != ref:
            raise RuntimeError("phase 34 (c): request %d: HTTP %d, served "
                               "%r, collapsed reference %r"
                               % (i, code, body.get("tokens"), ref))
    stats = fleet.batcher("tp").stats
    need = (2 * CFG["n_layers"] + 1) * (stats.prefills_total
                                        + stats.steps_total)
    print("phase 34 (c): DecodeProgram(plan=MeshPlan(data=1, model=2)), "
          "heads_local %d, behind ModelFleet + Server: %d concurrent POST "
          "/decode x %d tokens all equal the collapsed program's "
          "reference_decode; warmed in %.2f s; %.1f tokens/s; "
          "fused_layer_norm %d launches (>= %d) [%s]"
          % (prog.heads_local, P34_REQUESTS, MAX_NEW, warm,
             P34_REQUESTS * MAX_NEW / wall, ln, need, card))
    if ln < need:
        raise RuntimeError("phase 34 (c): fused_layer_norm launched %d "
                           "times, want >= %d" % (ln, need))


def phase_tensor_parallel():
    """Phase 34: A7(a), model-axis tensor parallelism (module docstring).
    Returns the launches of B1, B4 and B5-B7 in (a)."""
    t_phase = time.monotonic()
    card = _p32_card()
    launches = _p34_train(card)
    _p34_parity()
    _p34_kernels(card)
    _p34_decode(card)
    print("phase 34: %.1f s (the script so far %.1f s) [%s]"
          % (time.monotonic() - t_phase, time.monotonic() - T_START, card))
    return launches


def _p35_symbol_block(card, tmp):
    """(a): a symbolic ResNet-50 checkpoint saved by the port, run as a
    ``gluon.SymbolBlock`` on the card, equal to ``Module.predict``."""
    import torch
    from mxnet_tpu_torch import gluon, initializer, io, module, nd
    from mxnet_tpu_torch.tools.symbols import resnet
    sym = resnet.get_symbol(1000, 50, "3,%d,%d" % (P35_SIDE, P35_SIDE))
    shape = (P35_BATCH, 3, P35_SIDE, P35_SIDE)
    rng = np.random.RandomState(35)
    x = rng.rand(*shape).astype(np.float32)
    y = rng.randint(0, 1000, P35_BATCH).astype(np.float32)
    mod = module.Module(sym, context="cuda")
    mod.bind([("data", shape)], [("softmax_label", y.shape)],
             for_training=False)
    mod.init_params(initializer.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
                    rng=np.random.RandomState(1))
    prefix = tmp + "/resnet50"
    mod.save_checkpoint(prefix, 0)
    want = mod.predict(io.NDArrayIter(x, None, P35_BATCH)).asnumpy()
    del mod
    blk = gluon.SymbolBlock.imports(prefix + "-symbol.json",
                                    ["data", "softmax_label"],
                                    prefix + "-0000.params", ctx="cuda")
    got = blk(nd.array(x, ctx="cuda"),
              nd.array(y, ctx="cuda")).asnumpy()
    torch.cuda.synchronize()
    err = float(np.abs(got - want).max())
    print("phase 35 (a): SymbolBlock.imports of the port's symbolic "
          "ResNet-50 checkpoint (%d parameters) on the card, batch %d x "
          "%d^2: max |prob - Module.predict| %.3g (tol %g) [%s]"
          % (len(blk.collect_params().keys()), P35_BATCH, P35_SIDE, err,
             PROB_TOL, card))
    if not np.isfinite(got).all() or err > PROB_TOL:
        raise RuntimeError("phase 35 (a): SymbolBlock differs from "
                           "Module.predict by %.3g" % err)


def _p35_mixed(card):
    """(b): an FCN-32s style upsampler (``examples/fcn_xs/train_fcn.py:
    117-118``) initialized by ``Mixed([...], [Bilinear(), Xavier()])`` on
    the card: the deconvolution's weights are Bilinear's, exactly."""
    import torch
    from mxnet_tpu_torch import gluon, initializer, nd
    net = gluon.nn.HybridSequential(prefix="fcn32s_")
    with net.name_scope():
        net.add(gluon.nn.Conv2D(21, 1, in_channels=512, prefix="score_"))
        net.add(gluon.nn.Conv2DTranspose(21, 64, strides=32, padding=16,
                                         in_channels=21, use_bias=False,
                                         prefix="upsampling_"))
    net.initialize(initializer.Mixed([".*upsampling.*", ".*"],
                                     [initializer.Bilinear(),
                                      initializer.Xavier()]),
                   ctx="cuda",
                   rng=torch.Generator("cuda").manual_seed(35))
    params = net.collect_params()
    up = params["fcn32s_upsampling_weight"].data().asnumpy()
    want = np.zeros(up.shape, np.float32)
    initializer.Bilinear()._init_weight(None, want, None)
    score = params["fcn32s_score_weight"].data()._data
    out = net(nd.ones((1, 512, 7, 7), ctx="cuda"))
    torch.cuda.synchronize()
    print("phase 35 (b): Mixed([upsampling, .*], [Bilinear(), Xavier()]) "
          "on the card: upsampling weight %s equal to Bilinear's: %s; score "
          "weight std %.4g (Xavier's %.4g); 7 x 7 -> %s [%s]"
          % (up.shape, np.array_equal(up, want),
             float(score.detach().std()),
             np.sqrt(3 / ((512 + 21) / 2.0)) / np.sqrt(3),
             tuple(out.shape), card))
    if not np.array_equal(up, want) or tuple(out.shape) != (1, 21, 224,
                                                             224):
        raise RuntimeError("phase 35 (b): the upsampler's init or shape")


def phase_front_end_names():
    """Phase 35: A1(f), the front-end names (module docstring)."""
    import shutil
    import tempfile
    from mxnet_tpu_torch.tools import op_bench
    t_phase = time.monotonic()
    card = _p32_card()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p35_")
    try:
        _p35_symbol_block(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _p35_mixed(card)
    records, summary = op_bench.main(["--iters", "10", "--device",
                                      "cuda"],
                                     emit=lambda l: print("phase 35 (c): "
                                                          + l))
    if summary["errors"] or summary["timed"] != len(records):
        raise RuntimeError("phase 35 (c): op_bench %r" % (summary,))
    print("phase 35: op_bench timed %d ops on the card; %.1f s (the script "
          "so far %.1f s) [%s]" % (summary["timed"],
                                   time.monotonic() - t_phase,
                                   time.monotonic() - T_START, card))


def _timed(phase, *args, **kwargs):
    """Run one phase; print its seconds and the script's so far (flushed,
    so a cut run shows where its time went)."""
    t0 = time.monotonic()
    out = phase(*args, **kwargs)
    print("chip_smoke: %s %.1f s (the script so far %.1f s)"
          % (phase.__name__, time.monotonic() - t0,
             time.monotonic() - T_START), flush=True)
    return out


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
    t_start = T_START
    try:
        kernel = _timed(phase_kernels)
        runner, host_params, counts = _timed(phase_serve)
        kernel["launches"] = counts[kernel["name"]]
        _timed(phase_cpu_parity, runner, host_params)
        del runner
        bucket = _bucket_size()
        print("phase 4: resnet50_v1 has %d trainable parameters (one "
              "f32 bucket)" % bucket)
        opt_kernels = _timed(phase_opt_kernels, bucket)
        launches = _timed(phase_train, bucket, profile="--profile" in sys.argv)
        for k in opt_kernels:
            k["launches"] = launches[k["name"]]
        _timed(phase_train_parity)
        flash_kernels = _timed(phase_flash_kernels)
        flash = _timed(phase_train_lm, profile="--profile" in sys.argv)
        for k in flash_kernels:
            k["launches"] = flash[k["name"]]
            k["launches_by_design"] = {
                d: flash[k["name"] + "/" + d] for d in ("wgmma", "simt")}
        _timed(phase_train_lm_parity)
        qmm_kernel = _timed(phase_qmm_kernel)
        qmm_kernel["launches"], model = _timed(
            phase_int8_serve, profile="--profile" in sys.argv)
        _timed(phase_int8_parity, model)
        del model
        conv_kernels = _timed(phase_conv_kernel, profile="--profile" in sys.argv)
        launches = _timed(phase_conv_path)
        for k in conv_kernels:
            k["launches"] = launches[k["name"].split("[")[1][:-1]]
        gen_kernels = _timed(phase_gen_kernels)
        launches = _timed(phase_codegen_bench)
        for k in gen_kernels:
            k["launches"] = launches[k["name"]]
        bf16_kernels = _timed(phase_flash_bf16)
        launches = _timed(phase_train_bf16)
        for k in opt_kernels:
            if k["name"] in launches:
                k["launches_bf16"] = launches[k["name"]]
        flash = _timed(phase_train_lm_bf16, profile="--profile" in sys.argv)
        for k in bf16_kernels:
            name = k["name"].split("[")[0]
            k["launches"] = flash[name + "/" + k["design"]]
            k["launches_by_design"] = {
                d: flash[name + "/" + d] for d in BF16_DESIGNS
                if name + "/" + d in flash}
        _timed(phase_benches)
        _timed(phase_gluon_train)
        _timed(phase_gluon_parity)
        launches = _timed(phase_nhwc_train, profile="--profile" in sys.argv)
        for k in opt_kernels:
            if k["name"] == "fused_sgd_momentum":
                k["launches_bf16_nhwc"] = launches
        _timed(phase_nhwc_parity)
        _timed(phase_zoo)
        _timed(phase_ops)
        launches = _timed(phase_optimizers)
        for k in opt_kernels:
            if k["name"] in launches:
                k["launches_phase25"] = launches[k["name"]]
        launches = _timed(phase_data_pipeline)
        for k in opt_kernels:
            if k["name"] == "fused_sgd_momentum":
                k["launches_phase26"] = launches
        _timed(phase_module_train)
        _timed(phase_rnn_ctc)
        _timed(phase_detection)
        _timed(phase_sparse)
        _timed(phase_rest_of_ops)
        launches = _timed(phase_data_parallel)
        for k in opt_kernels + flash_kernels + [kernel]:
            if k["name"] in launches:
                k["launches_phase32"] = launches[k["name"]]
        b1 = _timed(phase_parameter_server)
        for k in opt_kernels:
            if k["name"] == "fused_sgd_momentum":
                k["launches_phase33"] = b1
        launches = _timed(phase_tensor_parallel)
        for k in opt_kernels + flash_kernels + [kernel]:
            if k["name"] in launches:
                k["launches_phase34"] = launches[k["name"]]
        _timed(phase_front_end_names)
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
                      + bf16_kernels + [qmm_kernel] + conv_kernels
                      + gen_kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
