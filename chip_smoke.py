#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mxnet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile]

Twenty-three phases; any failure exits non-zero and prints no result line.

1. **Kernels.** Build every CUDA source of the port with ``nvcc`` (one
   process per source, started together — the six mxgen kernels that
   ``analysis/codegen.py`` emits among them), run each kernel's wrapper on
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
    t1 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ptxas = pool.submit(build.ptxas_report, PTXAS_SOURCES)
        libs = build.build_all(build.KERNEL_SOURCES, emitted)
        report = ptxas.result()
    print("phase 1: lowered the 6 shipped mxgen chains to CUDA in %.2f s; "
          "built %s in %.2f s (one nvcc each, started together, beside "
          "ptxas -v of %s)"
          % (t1 - t0, sorted(libs), time.monotonic() - t1,
             list(PTXAS_SOURCES)))
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
        wrong += ["%s at D = %d" % (name, d) for name in FLASH_KERNELS
                  if ms[(name, chosen[name])] > min(ms[(name, "wgmma")],
                                                    ms[(name, "simt")])]
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
    from mxnet_tpu_torch.analysis import codegen as cg
    from mxnet_tpu_torch.ops import build
    from mxnet_tpu_torch.ops import generated_kernels as gen

    variants, pinned = {}, {}
    for gk in kernels:
        lk = gk.lowered
        if lk.plan not in ("rows", "flat"):
            continue
        vs = {"groups": cg.lower_chain(lk.chain, lk.name + "_groups",
                                       plan="groups")}
        if lk.plan == "rows":
            for c in cg._ROW_CLUSTERS:
                if lk.layout.fits(c) is None:
                    vs["c%d" % c] = cg.lower_chain(
                        lk.chain, "%s_c%d" % (lk.name, c), plan="rows",
                        cluster=c)
            pinned[gk.name] = "c%d" % lk.cluster
        else:
            for t, e in cg._FLAT_SIZES:
                vs["t%d_e%d" % (t, e)] = cg.lower_chain(
                    lk.chain, "%s_t%d_e%d" % (lk.name, t, e), flat=(t, e))
            pinned[gk.name] = "t%d_e%d" % (lk.threads,
                                           lk.layout.per_thread)
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
        wrong += ["%s at D = %d" % (n, d) for n in names
                  if ms[(n, chosen[n])] > min(ms[(n, x)]
                                              for x in BF16_DESIGNS)]
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
ZOO_ITERS, ZOO_WARMUP = 5, 2     # benchmark_score's 20 / 5, cut for time
ZOO_SWEEP_ROUNDS, ZOO_SWEEP_S = 5, 0.3    # the resnet50_v1 layout sweep
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
            k["launches_by_design"] = {
                d: flash[k["name"] + "/" + d] for d in ("wgmma", "simt")}
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
        bf16_kernels = phase_flash_bf16()
        launches = phase_train_bf16()
        for k in opt_kernels:
            if k["name"] in launches:
                k["launches_bf16"] = launches[k["name"]]
        flash = phase_train_lm_bf16(profile="--profile" in sys.argv)
        for k in bf16_kernels:
            name = k["name"].split("[")[0]
            k["launches"] = flash[name + "/" + k["design"]]
            k["launches_by_design"] = {
                d: flash[name + "/" + d] for d in BF16_DESIGNS
                if name + "/" + d in flash}
        phase_benches()
        phase_gluon_train()
        phase_gluon_parity()
        launches = phase_nhwc_train(profile="--profile" in sys.argv)
        for k in opt_kernels:
            if k["name"] == "fused_sgd_momentum":
                k["launches_bf16_nhwc"] = launches
        phase_nhwc_parity()
        phase_zoo()
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
