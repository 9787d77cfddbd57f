"""``mx.random``: the port of ``mxnet_tpu/random.py`` — global seeding and
the module-level samplers, which are ``nd.random``'s."""
from __future__ import annotations

from .ndarray import random as _nd_random

__all__ = ["seed", "uniform", "normal", "randn", "poisson", "exponential",
           "gamma", "multinomial", "shuffle", "randint", "negative_binomial",
           "generalized_negative_binomial"]


# every device's generator and numpy's global RNG, whatever ``ctx`` names
# (the reference's reseeds all devices too)
seed = _nd_random.seed
uniform = _nd_random.uniform
normal = _nd_random.normal
randn = _nd_random.randn
poisson = _nd_random.poisson
exponential = _nd_random.exponential
gamma = _nd_random.gamma
multinomial = _nd_random.multinomial
shuffle = _nd_random.shuffle
randint = _nd_random.randint
negative_binomial = _nd_random.negative_binomial
generalized_negative_binomial = _nd_random.generalized_negative_binomial
