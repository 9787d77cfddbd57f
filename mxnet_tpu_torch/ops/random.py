"""Sampling operators: the port of ``mxnet_tpu/ops/random.py``.

Every sampler draws from the seeded generator of its output's device
(``_rng.next_generator``), or from the ``generator`` its caller passes:
torch's Philox on the card, its Mersenne twister on the host.  The
reference samples with JAX's threefry, so a draw is held to the
reference by its law, not by its stream; within the port one seed repeats
bitwise on each device.

- ``_random_*`` (``:24-92``) take scalar parameters and ``shape``, and
  draw on ``ctx`` (the card unless the caller asks for the CPU).
- ``_sample_*`` (``:142-200``) take parameter tensors: the output has
  the parameters' shape followed by ``shape``, each parameter set
  drawing its own block.
- Gamma draws are ``torch._standard_gamma`` times the scale; the
  negative binomial is Poisson(Gamma(k, (1 - p) / p)), and the
  generalized one the reference's Poisson(Gamma(1 / alpha, mu * alpha))
  (Poisson(mu) at alpha = 0).
- ``_sample_multinomial`` draws category indices from rows of
  probabilities (clipped at 1e-30, as the reference's logits are), with
  their log-probabilities as a second output under ``get_prob``;
  ``_shuffle`` permutes along axis 0.
"""
from __future__ import annotations

import torch

from .. import _rng
from ..precision import torch_dtype
from .init import ctx_device as _dev
from .init import shape_tuple as _shape
from .registry import register

__all__ = ["random_uniform", "random_normal", "random_gamma",
           "random_exponential", "random_poisson",
           "random_negative_binomial", "random_gen_neg_binomial",
           "random_randint", "sample_multinomial", "shuffle"]


def _gen(generator, device):
    return generator if generator is not None \
        else _rng.next_generator(device)


def _dt(dtype, default="float32"):
    return torch_dtype(dtype or default)


def _gamma(alpha, g):
    """Standard Gamma(alpha) draws of ``alpha``'s shape (float32)."""
    return torch._standard_gamma(alpha, generator=g)


def _full(v, shape, device):
    return torch.full(shape, float(v), dtype=torch.float32, device=device)


@register("_random_uniform", arg_names=[],
          aliases=("uniform", "random_uniform"))
def random_uniform(low=0.0, high=1.0, shape=(), dtype="float32", ctx=None,
                   generator=None):
    """``shape`` draws uniform in [low, high) (reference:
    src/operator/random/sample_op.cc)."""
    dev = _dev(ctx)
    return torch.empty(_shape(shape), dtype=_dt(dtype), device=dev).uniform_(
        float(low), float(high), generator=_gen(generator, dev))


@register("_random_normal", arg_names=[], aliases=("normal", "random_normal"))
def random_normal(loc=0.0, scale=1.0, shape=(), dtype="float32", ctx=None,
                  generator=None):
    """``shape`` draws from Normal(loc, scale)."""
    dev = _dev(ctx)
    z = torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                    generator=_gen(generator, dev))
    return z * scale + loc


@register("_random_gamma", arg_names=[], aliases=("random_gamma",))
def random_gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32", ctx=None,
                 generator=None):
    """``shape`` draws from Gamma(alpha) times the scale ``beta``."""
    dev = _dev(ctx)
    a = _full(alpha, _shape(shape), dev)
    return (_gamma(a, _gen(generator, dev)) * beta).to(_dt(dtype))


@register("_random_exponential", arg_names=[],
          aliases=("random_exponential",))
def random_exponential(lam=1.0, shape=(), dtype="float32", ctx=None,
                       generator=None):
    """``shape`` draws from Exponential(lam) (rate ``lam``)."""
    dev = _dev(ctx)
    e = torch.empty(_shape(shape), dtype=torch.float32, device=dev)
    e.exponential_(1.0, generator=_gen(generator, dev))
    return (e / lam).to(_dt(dtype))


@register("_random_poisson", arg_names=[], aliases=("random_poisson",))
def random_poisson(lam=1.0, shape=(), dtype="float32", ctx=None,
                   generator=None):
    """``shape`` draws from Poisson(lam)."""
    dev = _dev(ctx)
    return torch.poisson(_full(lam, _shape(shape), dev),
                         generator=_gen(generator, dev)).to(_dt(dtype))


def _neg_binomial(k, p, g):
    """Poisson(Gamma(k) * (1 - p) / p) over tensors of one shape."""
    return torch.poisson(_gamma(k, g) * ((1.0 - p) / p), generator=g)


def _gen_neg_binomial(mu, alpha, g):
    """Poisson(Gamma(1 / alpha) * mu * alpha) over tensors of one shape."""
    return torch.poisson(_gamma(1.0 / alpha, g) * (mu * alpha), generator=g)


@register("_random_negative_binomial", arg_names=[],
          aliases=("random_negative_binomial",))
def random_negative_binomial(k=1, p=1.0, shape=(), dtype="float32", ctx=None,
                             generator=None):
    """``shape`` draws from NegBinomial(k, p), failures before the k-th
    success, as a Gamma-Poisson mixture."""
    dev = _dev(ctx)
    s = _shape(shape)
    return _neg_binomial(_full(k, s, dev), _full(p, s, dev),
                         _gen(generator, dev)).to(_dt(dtype))


@register("_random_generalized_negative_binomial", arg_names=[],
          aliases=("random_generalized_negative_binomial",))
def random_gen_neg_binomial(mu=1.0, alpha=1.0, shape=(), dtype="float32",
                            ctx=None, generator=None):
    """``shape`` draws from GNB(mu, alpha): mean ``mu``, variance ``mu +
    alpha * mu^2``; Poisson(mu) at alpha = 0."""
    dev = _dev(ctx)
    s = _shape(shape)
    g = _gen(generator, dev)
    if alpha == 0:
        out = torch.poisson(_full(mu, s, dev), generator=g)
    else:
        out = _gen_neg_binomial(_full(mu, s, dev), _full(alpha, s, dev), g)
    return out.to(_dt(dtype))


@register("_random_randint", arg_names=[], aliases=("random_randint",))
def random_randint(low=0, high=1, shape=(), dtype="int32", ctx=None,
                   generator=None):
    """``shape`` integers uniform in [low, high)."""
    dev = _dev(ctx)
    return torch.randint(int(low), int(high), _shape(shape),
                         dtype=_dt(dtype, "int32"), device=dev,
                         generator=_gen(generator, dev))


def _multinomial_outputs(params):
    return 2 if params.get("get_prob") else 1


@register("_sample_multinomial", aliases=("sample_multinomial",),
          num_outputs=_multinomial_outputs)
def sample_multinomial(data, shape=(), get_prob=False, dtype="int32",
                       generator=None):
    """Category indices drawn from each row of probabilities ``data``:
    ``data.shape[:-1] + shape``; under ``get_prob`` also the drawn
    categories' log-probabilities (reference:
    src/operator/random/sample_multinomial_op.cc)."""
    s = _shape(shape)
    n = 1
    for d in s:
        n *= d
    probs = torch.clamp(data.float(), min=1e-30)
    rows = probs.reshape(-1, probs.shape[-1])
    idx = torch.multinomial(rows, n, replacement=True,
                            generator=_gen(generator, data.device))
    lead = tuple(data.shape[:-1])
    samp = idx.reshape(lead + s)
    out = samp.to(_dt(dtype, "int32"))
    if not get_prob:
        return out
    lp = torch.log(rows).gather(1, idx).reshape(samp.shape)
    return out, lp


def _params_to(x, full):
    """Parameter tensor ``x`` broadcast over the trailing ``shape`` axes."""
    x = x.float()
    return x.reshape(tuple(x.shape) + (1,) * (len(full) - x.dim())) \
        .expand(full)


def _sample2(name, a_name, b_name, draw, doc):
    def fn(a, b, shape=(), dtype=None, generator=None):
        full = tuple(a.shape) + _shape(shape)
        g = _gen(generator, a.device)
        out = draw(_params_to(a, full), _params_to(b, full), full, g)
        return out if dtype is None else out.to(_dt(dtype))

    fn.__name__ = name.lstrip("_")
    fn.__doc__ = doc
    register(name, arg_names=[a_name, b_name])(fn)
    return fn


def _uniform_draw(lo, hi, full, g):
    u = torch.empty(full, device=lo.device).uniform_(generator=g)
    return u * (hi - lo) + lo


def _normal_draw(mu, sig, full, g):
    return torch.randn(full, device=mu.device, generator=g) * sig + mu


_sample2("_sample_uniform", "low", "high", _uniform_draw,
         "Per-element uniform draws in [low, high) (reference: src/operator/"
         "random/multisample_op.cc).")
_sample2("_sample_normal", "low", "high", _normal_draw,
         "Per-element Normal(mu, sigma) draws.")
_sample2("_sample_gamma", "low", "high",
         lambda a, b, full, g: _gamma(a.contiguous(), g) * b,
         "Per-element Gamma(alpha) draws times the scale beta.")
_sample2("_sample_negative_binomial", "k", "p",
         lambda k, p, full, g: _neg_binomial(k.contiguous(), p, g),
         "Per-element NegBinomial(k, p) draws (Gamma-Poisson).")
_sample2("_sample_generalized_negative_binomial", "mu", "alpha",
         lambda mu, a, full, g: _gen_neg_binomial(
             mu, torch.clamp(a, min=1e-9).contiguous(), g),
         "Per-element GNB(mu, alpha) draws, alpha clipped at 1e-9.")


def _sample1(name, draw, doc):
    def fn(data, shape=(), dtype=None, generator=None):
        full = tuple(data.shape) + _shape(shape)
        g = _gen(generator, data.device)
        return draw(_params_to(data, full), full, g).to(_dt(dtype))

    fn.__name__ = name.lstrip("_")
    fn.__doc__ = doc
    register(name, arg_names=["data"])(fn)
    return fn


def _exponential_draw(lam, full, g):
    e = torch.empty(full, device=lam.device).exponential_(1.0, generator=g)
    return e / lam


_sample1("_sample_poisson",
         lambda lam, full, g: torch.poisson(lam.contiguous(), generator=g),
         "Per-element Poisson(lam) draws.")
_sample1("_sample_exponential", _exponential_draw,
         "Per-element Exponential(lam) draws.")


@register("_shuffle", aliases=("shuffle",))
def shuffle(data, generator=None):
    """A random permutation of ``data`` along its first axis (reference:
    src/operator/random/shuffle_op.cc)."""
    perm = torch.randperm(data.shape[0], device=data.device,
                          generator=_gen(generator, data.device))
    return data[perm]
