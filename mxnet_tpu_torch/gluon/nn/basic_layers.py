"""Gluon basic layers: the port of ``mxnet_tpu/gluon/nn/basic_layers.py``
(``Sequential``, ``HybridSequential``, ``Dense``, ``Activation``,
``BatchNorm``, ``Flatten``).  The other layers of that module are
ROADMAP.md queue A, item 1."""
from __future__ import annotations

import numpy as np

from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "BatchNorm", "Flatten"]


class _SequentialMixin:
    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)()
            net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._children.values())


class Sequential(_SequentialMixin, Block):
    """Stack of blocks executed sequentially."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x


class HybridSequential(_SequentialMixin, HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """Fully-connected layer; input above 2-D is flattened when
    ``flatten`` (reference: basic_layers.py Dense)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self._flatten = flatten
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer,
                    dtype=dtype, allow_deferred_init=True)
            else:
                self.bias = None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None
            if self.act is not None:
                self.register_child(self.act, "act")

    def infer_param_shapes(self, x, *args):
        if self.weight._deferred_init:
            in_units = int(np.prod(x.shape[1:])) if self._flatten \
                else x.shape[-1]
            self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self.act is not None:
            out = self.act(out)
        return out


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type or "activation"

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class BatchNorm(HybridBlock):
    """Reference: basic_layers.py BatchNorm (axis=1, NCHW).  Training mode
    normalizes with the batch statistics and updates the moving ones
    (``ops/nn.py`` ``BatchNorm``); inference mode uses the moving ones."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        self._in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def infer_param_shapes(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            if p._deferred_init:
                p.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           eps=self._epsilon, momentum=self._momentum,
                           fix_gamma=not self._scale,
                           use_global_stats=self._use_global_stats,
                           axis=self._axis, _train=self.training)
