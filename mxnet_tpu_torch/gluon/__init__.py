"""Gluon of the port (reference: ``mxnet_tpu/gluon``): blocks, parameters,
layers, ``contrib.nn`` and ``contrib.rnn``, losses, the ``Trainer``, the
vision model zoo, ``data`` (datasets, samplers, ``DataLoader``, vision
transforms), the recurrent layers and cells of ``rnn`` and the weight
carry-over from the reference (``utils.from_jax_params``)."""
from . import contrib, data, loss, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Parameter", "Constant",
           "ParameterDict",
           "DeferredInitializationError", "Trainer", "contrib", "data", "nn",
           "loss", "model_zoo", "rnn", "utils"]
