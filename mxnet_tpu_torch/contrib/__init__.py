"""``mx.contrib`` of the port (the counterpart of
``mxnet_tpu/contrib/``): ``text`` (vocabulary and token embeddings),
``io`` (``DataLoaderIter``), ``autograd`` (the old API), ``quantization``
(``quantize_model``) and ``tensorboard`` (``LogMetricsCallback``, gated
on a summary writer being importable)."""
from . import autograd
from . import io
from . import quantization
from . import tensorboard
from . import text

__all__ = ["text", "io", "autograd", "quantization", "tensorboard"]
