"""Gluon basic layers: the port of ``mxnet_tpu/gluon/nn/basic_layers.py``.

Layers that behave differently in training (``BatchNorm``, ``Dropout``)
read :meth:`Block._train_flag`: ``autograd.is_training()`` when called on
NDArrays, ``nn.Module``'s mode when called on tensors.  ``Dropout``
draws its masks from the ``torch.Generator`` it is given, or from the
seeded generator of the data's device (``_rng``, reseeded by
``mx.random.seed``) when none is, so a run is repeatable from one seed;
its masks are not the reference's (a JAX PRNG stream), only their law
is.
"""
from __future__ import annotations

import numpy as np

from ... import ndarray as nd
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "BatchNorm", "Flatten", "LeakyReLU", "PReLU", "ELU", "SELU",
           "Swish", "GELU", "Dropout", "InstanceNorm", "LayerNorm",
           "Embedding", "Lambda", "HybridLambda", "HybridConcurrent"]


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
                           axis=self._axis, _train=self._train_flag())


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    def __init__(self, alpha_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(1,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class Swish(HybridBlock):
    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class GELU(HybridBlock):
    """The tanh approximation, as the reference's ``jax.nn.gelu``."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Dropout(HybridBlock):
    """Inverted dropout of ``rate``, the mask shared along ``axes``, drawn
    from ``generator`` (module docstring)."""

    def __init__(self, rate, axes=(), generator=None, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes
        self._generator = generator

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes,
                         _train=self._train_flag(),
                         generator=self._generator)


class _Norm(HybridBlock):
    """gamma and beta of the size of the input's ``axis``."""

    def __init__(self, axis, epsilon, beta_initializer, gamma_initializer,
                 in_channels, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         init=gamma_initializer,
                                         allow_deferred_init=True)
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        init=beta_initializer,
                                        allow_deferred_init=True)

    def infer_param_shapes(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta):
            if p._deferred_init:
                p.shape = (c,)


class InstanceNorm(_Norm):
    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(axis, epsilon, beta_initializer, gamma_initializer,
                         in_channels, **kwargs)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class LayerNorm(_Norm):
    """``ops.nn.LayerNorm``, as the reference's layer (its fused kernel B4
    belongs to the TransformerLM)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(axis, epsilon, beta_initializer, gamma_initializer,
                         in_channels, **kwargs)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        # sparse_grad marks the weight's gradient row_sparse, a flag only:
        # the gradient is dense and the update dense, as in the reference
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype,
                grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class Lambda(Block):
    """A function over NDArrays as a block: a callable, or the name of an
    ``nd`` function."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func_impl = getattr(nd, function)
            self._func_name = function
        else:
            self._func_impl = function
            self._func_name = function.__name__

    def forward(self, *args):
        return self._func_impl(*args)


class HybridLambda(HybridBlock):
    """``function(F, x, *args)`` over tensors as a block, or the name of an
    op of ``F``."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func_name = function
            self._func = lambda F, *args: getattr(F, function)(*args)
        else:
            self._func = function
            self._func_name = function.__name__

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)


class HybridConcurrent(HybridBlock):
    """Children run on the same input, their outputs joined on ``axis``
    (reference: gluon/contrib/nn/basic_layers.py)."""

    def __init__(self, axis=1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, block):
        self.register_child(block)

    def hybrid_forward(self, F, x):
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self.axis)
