"""``gluon.contrib.nn``: the port of ``mxnet_tpu/gluon/contrib/nn.py``
(``Concurrent``, ``HybridConcurrent``, ``Identity``, ``SparseEmbedding``).
``SparseEmbedding``'s weight is marked ``grad_stype="row_sparse"``; as in
the reference, that is a flag only: its gradient and update are dense."""
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
    """An embedding whose weight's gradient is marked row_sparse
    (reference: ``gluon/contrib/nn.py:31-55``)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype,
                grad_stype="row_sparse")

    def forward(self, x):
        return nd.Embedding(x, self.weight.data(),
                            input_dim=self._input_dim,
                            output_dim=self._output_dim, sparse_grad=True)

    def __repr__(self):
        return "SparseEmbedding(%d -> %d)" % (self._input_dim,
                                              self._output_dim)
