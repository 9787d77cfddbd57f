"""Model zoo of the port (reference: ``mxnet_tpu/gluon/model_zoo``): the
vision models and ``model_store``."""
from . import model_store, vision
from .vision import get_model

__all__ = ["vision", "model_store", "get_model"]
