"""Text vocabulary and pretrained token embeddings, the port of
``mxnet_tpu/contrib/text/`` (reference: python/mxnet/contrib/text/):
``vocab``, ``embedding`` and ``utils``."""
from . import embedding, utils, vocab
from .embedding import (CompositeEmbedding, CustomEmbedding, FastText,
                        GloVe)
from .utils import count_tokens_from_str
from .vocab import Vocabulary

__all__ = ["embedding", "utils", "vocab", "Vocabulary",
           "count_tokens_from_str", "CustomEmbedding", "GloVe",
           "FastText", "CompositeEmbedding"]
