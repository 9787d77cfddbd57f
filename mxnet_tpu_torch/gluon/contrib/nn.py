"""``gluon.contrib.nn``: the port of ``mxnet_tpu/gluon/contrib/nn.py``
(``Concurrent``, ``HybridConcurrent``, ``Identity``).  ``SparseEmbedding``
needs row_sparse gradients, which the port does not have: it raises,
naming ROADMAP.md queue A, item 10."""
from __future__ import annotations

from ... import ndarray as nd
from ..block import Block, HybridBlock
from ..nn.basic_layers import HybridConcurrent, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding"]


class Concurrent(Sequential):
    """Children run on the same input, their outputs joined on ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        out = [block(x) for block in self._children.values()]
        return nd.concat(*out, dim=self.axis)


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Block):
    """An embedding over a row_sparse weight (reference:
    ``gluon/contrib/nn.py:31``)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "contrib.nn.SparseEmbedding: row_sparse gradients are "
            "ROADMAP.md queue A, item 10")
