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
``qmm_requant`` kernel; and the Gluon imperative training path —
``ndarray`` arithmetic, ``autograd``, ``gluon.Trainer``, ``kvstore``
('local' / 'device'), ``metric`` and ``serialization``, which runs the
reference's per-parameter update and none of the hand kernels; and the
rest of the op set with the seeded global RNG (``_rng``, ``random``,
``nd.random``, ``ops.random``), every optimizer of the reference and
``test_utils``; and the data pipeline — ``recordio``, the native libjpeg
decoder (``_native``), ``image``, the record and pipeline iterators of
``io`` with the device tail, and ``gluon.data``; and training through
Symbol, Executor and Module — ``Executor.backward``, the ``module``
package (``Module.fit`` / ``score`` / ``predict``, ``BucketingModule``,
``SequentialModule``), ``model`` (checkpoints, ``FeedForward``),
``callback``, ``monitor`` and ``operator`` (``CustomOp`` through
``nd.Custom``), with ``tools.train_mnist`` and ``tools.train_imagenet``;
and LSTM + CTC — the ``RNN`` op (``ops.rnn``, cuDNN through torch's fused
RNN functions), the CTC loss (``ops.contrib``), ``gluon.rnn``,
``gluon.contrib.rnn``, ``gluon.loss.CTCLoss`` and ``rnn`` (``mx.rnn``),
with ``tools.train_ctc``.  ROADMAP.md lists the rest.

The reference's top-level names load on first use: ``mx.nd``,
``mx.autograd``, ``mx.gluon``, ``mx.metric``, ``mx.kvstore``,
``mx.optimizer``, ``mx.init`` (``initializer``), ``mx.random``,
``mx.sym``, ``mx.test_utils``, ``mx.io``, ``mx.image``, ``mx.recordio``,
``mx.profiler``, ``mx.lr_scheduler``, ``mx.model``, ``mx.mod``
(``module``), ``mx.callback``, ``mx.monitor``, ``mx.Monitor``,
``mx.operator``, ``mx.rnn``, ``mx.MXNetError``, ``mx.cpu()`` and
``mx.gpu()``.
"""
import importlib

_LAZY = {"nd": "ndarray", "ndarray": "ndarray", "autograd": "autograd",
         "gluon": "gluon", "metric": "metric", "kvstore": "kvstore", "kv": "kvstore",
         "optimizer": "optimizer", "init": "initializer",
         "initializer": "initializer", "serialization": "serialization",
         "random": "random", "sym": "symbol", "symbol": "symbol",
         "test_utils": "test_utils", "io": "io", "image": "image",
         "recordio": "recordio", "profiler": "profiler", "name": "name",
         "lr_scheduler": "lr_scheduler", "model": "model", "mod": "module",
         "module": "module", "callback": "callback", "monitor": "monitor",
         "operator": "operator", "rnn": "rnn"}


def __getattr__(name):
    if name in _LAZY:
        return importlib.import_module("." + _LAZY[name], __name__)
    if name == "Monitor":
        from .monitor import Monitor
        return Monitor
    if name == "MXNetError":
        from .base import MXNetError
        return MXNetError
    if name in ("cpu", "gpu", "current_context", "num_gpus"):
        from . import context
        return getattr(context, name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
