"""Gluon of the port (reference: ``mxnet_tpu/gluon``): blocks, parameters,
layers, losses, the ``Trainer``, ResNet v1 and the weight carry-over from
the reference (``utils.from_jax_params``)."""
from . import loss, model_zoo, nn, utils
from .block import Block, HybridBlock
from .parameter import DeferredInitializationError, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict",
           "DeferredInitializationError", "Trainer", "nn", "loss",
           "model_zoo", "utils"]
