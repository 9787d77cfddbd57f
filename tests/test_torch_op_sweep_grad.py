"""The reference's operator sweep through both registries (gradients).

Every case of ``tests/test_op_sweep.py``'s ``ALL_CASES`` marked for a
gradient check, whose op the port registers: the gradient of
``sum(cos(out))`` (the reference sweep's scalarization) with respect to
each floating input, by ``jax.grad`` of the reference's op and by torch's
autograd of the port's, on the same seeded inputs.  Limit 1e-5, relative
to the larger of 1 and the gradient's largest magnitude.  The
even-numbered cases run here, the odd ones in
``tests/test_torch_op_sweep_grad_b.py``; the forward outputs are
``tests/test_torch_op_sweep.py`` and ``..._b.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg
from test_op_sweep import ALL_CASES

treg.load_all()
SEED = 0
GRAD_TOL = 1e-5

GRAD_CASES = [(n, i, c) for n, i, c in ALL_CASES
              if c.grad and n in set(treg.list_ops())]
HERE = GRAD_CASES[::2]


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def grads_both(name, case):
    """{input index: (reference gradient, port gradient)} over the float
    inputs."""
    jop, top = jreg.get(name), treg.get(name)
    np_in = case.inputs(np.random.RandomState(SEED))
    jparams, tparams = dict(case.params), dict(case.params)
    if jop.needs_train:
        jparams["_train"] = True
    if top.needs_train:
        tparams["_train"] = True
    floats = tuple(k for k, x in enumerate(np_in)
                   if np.issubdtype(x.dtype, np.floating))

    def scalar(*xs):
        out = _first(jop.fn(*xs, **jparams))
        return jnp.sum(jnp.cos(out.astype(jnp.float32)))

    jg = jax.grad(scalar, argnums=floats)(*[jnp.asarray(x) for x in np_in])
    tin = [torch.from_numpy(np.array(x)) for x in np_in]
    for k in floats:
        tin[k].requires_grad_(True)
    out = _first(top.fn(*tin, **tparams))
    torch.cos(out.float()).sum().backward()
    return {k: (np.asarray(g), tin[k].grad)
            for k, g in zip(floats, jg)}


def check_case(name, case):
    for k, (want, got) in grads_both(name, case).items():
        got = np.zeros_like(want) if got is None else got.numpy()
        assert got.shape == want.shape, (name, k)
        scale = max(1.0, float(np.abs(want.astype(np.float64)).max(
            initial=0.0)))
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale,
                                   err_msg="%s input %d" % (name, k))


@pytest.mark.parametrize("name,i,case", HERE,
                         ids=["%s-%d" % (n, i) for n, i, _ in HERE])
def test_gradient_matches_reference(name, i, case):
    check_case(name, case)
