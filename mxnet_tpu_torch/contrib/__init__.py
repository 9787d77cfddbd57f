"""``contrib`` of the port: ``quantization`` (``quantize_model``); the
rest of ``mxnet_tpu/contrib`` is ROADMAP.md queue A, item 10."""
from . import quantization

__all__ = ["quantization"]
