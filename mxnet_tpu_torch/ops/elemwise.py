"""Elementwise, scalar and broadcast operators: the port of
``mxnet_tpu/ops/elemwise.py``.

Each op is one torch call under the reference's name.  Binary ops take
numpy broadcasting, as the reference's do; comparisons and logical ops
return the left operand's dtype (1.0 / 0.0), not bool.  ``round`` and
``rint`` round half to even, as ``jnp.round`` does.  The
``_scatter_*`` ops keep a sparse array's storage in MXNet; an op here
takes dense tensors (sparse arrays live in ``ndarray/sparse.py``), on
which they are the plain scalar and elementwise ops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from .registry import register

__all__ = ["cast", "clip", "add_n", "hard_sigmoid", "block_grad",
           "grad_add", "identity_with_attr_like_rhs"]


def _binary(name, fn, aliases=()):
    register(name, arg_names=["lhs", "rhs"], aliases=aliases,
             doc="Elementwise %s(lhs, rhs) with numpy broadcasting "
                 "(reference: src/operator/tensor/elemwise_binary_op.cc)."
                 % name.lstrip("_"))(lambda lhs, rhs: fn(lhs, rhs))


def _unary(name, fn, aliases=()):
    register(name, aliases=aliases,
             doc="Elementwise %s(data) (reference: src/operator/tensor/"
                 "elemwise_unary_op.cc)." % name.lstrip("_"))(
                     lambda data: fn(data))


def _scalar(name, fn):
    register(name,
             doc="Elementwise %s(data, scalar) against a python scalar "
                 "(reference: src/operator/tensor/elemwise_binary_scalar_"
                 "op.cc)." % name.lstrip("_"))(fn)


def _as(fn):
    """``fn`` with its result in the left operand's dtype."""
    return lambda lhs, rhs: fn(lhs, rhs).to(lhs.dtype)


_ARITH = [("add", torch.add), ("sub", torch.sub), ("mul", torch.mul),
          ("div", torch.div), ("mod", torch.remainder),
          ("power", torch.pow), ("maximum", torch.maximum),
          ("minimum", torch.minimum), ("hypot", torch.hypot)]
_COMPARE = [("equal", torch.eq), ("not_equal", torch.ne),
            ("greater", torch.gt), ("greater_equal", torch.ge),
            ("lesser", torch.lt), ("lesser_equal", torch.le),
            ("logical_and", torch.logical_and),
            ("logical_or", torch.logical_or),
            ("logical_xor", torch.logical_xor)]

_binary("elemwise_add", torch.add, aliases=("_plus", "_add"))
_binary("elemwise_sub", torch.sub, aliases=("_minus", "_sub"))
_binary("elemwise_mul", torch.mul, aliases=("_mul",))
_binary("elemwise_div", torch.div, aliases=("_div",))
_binary("_power", torch.pow, aliases=("_Power",))
for _n, _f in _ARITH:
    _binary("broadcast_" + _n, _f)
    if _n in ("maximum", "minimum", "mod", "hypot"):
        _binary("_" + _n, _f)
for _n, _f in _COMPARE:
    _binary("_" + _n, _as(_f))
    _binary("broadcast_" + _n, _as(_f))


def _t(d, scalar):
    """``scalar`` as a 0-dim tensor of ``d``'s dtype and device, for the
    torch calls that take no python number on that side (a fill: a
    tensor made from a Python number on the card would be a synchronizing
    copy)."""
    return d.new_full((), scalar)


_scalar("_plus_scalar", lambda data, scalar=0.0: data + scalar)
_scalar("_minus_scalar", lambda data, scalar=0.0: data - scalar)
_scalar("_rminus_scalar", lambda data, scalar=0.0: scalar - data)
_scalar("_mul_scalar", lambda data, scalar=1.0: data * scalar)
_scalar("_div_scalar", lambda data, scalar=1.0: data / scalar)
_scalar("_rdiv_scalar", lambda data, scalar=1.0: scalar / data)
_scalar("_power_scalar", lambda data, scalar=1.0: torch.pow(data, scalar))
_scalar("_rpower_scalar", lambda data, scalar=1.0: torch.pow(scalar, data))
_scalar("_mod_scalar", lambda data, scalar=1.0: torch.remainder(data, scalar))
_scalar("_rmod_scalar",
        lambda data, scalar=1.0: torch.remainder(_t(data, scalar), data))
_scalar("_maximum_scalar",
        lambda data, scalar=0.0: torch.clamp(data, min=scalar))
_scalar("_minimum_scalar",
        lambda data, scalar=0.0: torch.clamp(data, max=scalar))
_scalar("_hypot_scalar",
        lambda data, scalar=0.0: torch.hypot(data, _t(data, scalar)))
for _n, _f in _COMPARE:
    _scalar("_%s_scalar" % _n,
            (lambda f: lambda data, scalar=0.0: f(
                data, _t(data, scalar)).to(data.dtype))(_f))


@register("smooth_l1")
def smooth_l1(data, scalar=1.0):
    """Smooth L1 with transition point 1/scalar^2 (reference:
    src/operator/tensor/elemwise_unary_op.cc SmoothL1)."""
    s2 = scalar * scalar
    return torch.where(data.abs() < 1.0 / s2, 0.5 * (scalar * data) ** 2,
                       data.abs() - 0.5 / s2)


def _cbrt(x):
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


for _n, _f in [
        ("abs", torch.abs), ("sign", torch.sign), ("rint", torch.round),
        ("round", torch.round), ("ceil", torch.ceil), ("floor", torch.floor),
        ("trunc", torch.trunc), ("fix", torch.trunc),
        ("square", torch.square), ("sqrt", torch.sqrt),
        ("rsqrt", torch.rsqrt), ("cbrt", _cbrt),
        ("rcbrt", lambda x: 1.0 / _cbrt(x)), ("exp", torch.exp),
        ("log", torch.log), ("log10", torch.log10), ("log2", torch.log2),
        ("log1p", torch.log1p), ("expm1", torch.expm1), ("sin", torch.sin),
        ("cos", torch.cos), ("tan", torch.tan), ("arcsin", torch.asin),
        ("arccos", torch.acos), ("arctan", torch.atan),
        ("sinh", torch.sinh), ("cosh", torch.cosh), ("tanh", torch.tanh),
        ("arcsinh", torch.asinh), ("arccosh", torch.acosh),
        ("arctanh", torch.atanh), ("degrees", torch.rad2deg),
        ("radians", torch.deg2rad), ("reciprocal", torch.reciprocal),
        ("logical_not", lambda x: torch.logical_not(x).to(x.dtype)),
        ("gamma", lambda x: torch.exp(torch.lgamma(x))),
        ("gammaln", torch.lgamma), ("erf", torch.erf),
        ("erfinv", torch.erfinv), ("relu", torch.relu),
        ("sigmoid", torch.sigmoid), ("softsign", TF.softsign)]:
    _unary(_n, _f)
_unary("negative", torch.neg, aliases=("_neg",))
_unary("identity", lambda data: data, aliases=("_copy", "_copyto"))


@register("BlockGrad", aliases=("stop_gradient",))
def block_grad(data):
    """Stops gradient flow (reference: src/operator/tensor/
    elemwise_unary_op_basic.cc BlockGrad)."""
    return data.detach()


@register("Cast", aliases=("cast",))
def cast(data, dtype="float32"):
    """Cast to ``dtype`` (reference: src/operator/tensor/elemwise_unary_op.cc
    Cast)."""
    from ..precision import torch_dtype
    return data.to(torch_dtype(dtype))


def _clip(data, lo, hi):
    """``min(max(data, lo), hi)`` whose gradient at ``data == lo`` or
    ``hi`` is 0.5, as ``jnp.clip``'s is (torch's ``maximum`` / ``minimum``
    split a tie's gradient; ``clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(data, data.new_tensor(lo)),
                         data.new_tensor(hi))


@register("clip")
def clip(data, a_min=0.0, a_max=1.0):
    """Clamp into [a_min, a_max] (reference: src/operator/tensor/
    matrix_op.cc clip; the gradient at the bounds is the reference's,
    ``_clip``)."""
    return _clip(data, a_min, a_max)


@register("add_n", arg_names=["args"], aliases=("ElementWiseSum", "_sum"))
def add_n(*args):
    """Sum of N arrays (reference: src/ndarray/ndarray.cc ElementwiseSum)."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("hard_sigmoid")
def hard_sigmoid(data, alpha=0.2, beta=0.5):
    """clip(alpha*x + beta, 0, 1) (reference: src/operator/tensor/
    elemwise_unary_op_basic.cc:109)."""
    return _clip(data * alpha + beta, 0, 1)


@register("_grad_add", arg_names=["lhs", "rhs"])
def grad_add(lhs, rhs):
    """lhs + rhs: the gradient-accumulation node of ``grad_req="add"``
    (reference: elemwise_binary_op_basic.cc _grad_add)."""
    return lhs + rhs


@register("_identity_with_attr_like_rhs", arg_names=["lhs", "rhs"])
def identity_with_attr_like_rhs(lhs, rhs):
    """lhs, carrying rhs's storage attributes in the reference."""
    return lhs


_scalar("_scatter_plus_scalar", lambda data, scalar=0.0: data + scalar)
_scalar("_scatter_minus_scalar", lambda data, scalar=0.0: data - scalar)
_binary("_scatter_elemwise_div", torch.div)
