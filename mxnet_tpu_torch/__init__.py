"""mxnet_tpu_torch — the PyTorch + CUDA port of ``mxnet_tpu`` for NVIDIA
Hopper (H100).

Module paths mirror ``mxnet_tpu`` so each counterpart is found by path.
The port runs on the CUDA device unless a caller passes ``device="cpu"``
(:func:`~mxnet_tpu_torch.base.resolve_device`); every TPU kernel on a
ported path is a hand-written CUDA kernel under ``csrc/``, built with
``nvcc`` at first use (``ops/build.py``).  The JAX package is the
reference the port's tests hold it against; the port never imports it.

Ported so far: decode serving of the TransformerLM —
``transformer`` (config, parameter layout, the KV-cached
``DecodeProgram``), ``serving`` (``DecodeRunner``, continuous batching,
``ModelFleet``, the HTTP ``Server``) and the fused LayerNorm kernel
(``ops.fused_optimizer.fused_layer_norm``); and training of ResNet v1 —
``gluon`` (blocks, parameters, layers, loss, model zoo, weight
carry-over), ``initializer``, ``optimizer``, ``lr_scheduler``,
``context`` and the single-device ``parallel.DataParallelTrainer``,
whose update runs the fused SGD / SGD+momentum / Adam kernels
(``ops.fused_optimizer``); training of the TransformerLM with ring
attention (the flash kernels of ``ops.pallas_kernels``); and int8
serving of a Symbol/Module ResNet — ``ops.registry``, ``ndarray``,
``symbol``, ``executor``, ``module``, ``io``, ``ops.quantization``,
``contrib.quantization``, ``serving.quantize`` and
``serving.runner.ModelRunner``, the fused 1×1 convolutions running the
``qmm_requant`` kernel.  ROADMAP.md lists the rest.
"""
