"""Model zoo of the port (reference: ``mxnet_tpu/gluon/model_zoo``)."""
from . import vision
from .vision import get_model

__all__ = ["vision", "get_model"]
