"""Gluon of the port (reference: ``mxnet_tpu/gluon``): blocks, parameters,
layers, the softmax cross-entropy loss, ResNet v1 and the weight
carry-over from the reference (``utils.from_jax_params``)."""
from . import loss, model_zoo, nn, utils
from .block import Block, HybridBlock
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict",
           "DeferredInitializationError", "nn", "loss", "model_zoo", "utils"]
