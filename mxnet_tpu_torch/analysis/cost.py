"""Kernel-declared cost models: the ``KERNEL_COSTS`` registry of
``mxnet_tpu/analysis/cost.py:169-191``.

A kernel declares what one call costs — ``{"flops", "transcendentals",
"bytes_read", "bytes_written"}`` — keyed by its name; the generated
kernels of ``ops/generated_kernels.py`` declare theirs from the chain's
modeled byte split when they are registered.  The rest of mxcost (the
tape, liveness and budget gates) is ROADMAP.md queue A, item 13.
"""
from __future__ import annotations

__all__ = ["KERNEL_COSTS", "declare_kernel_cost"]

# kernel name -> cost fn(eqn) -> {"flops", "transcendentals",
# "bytes_read", "bytes_written"}
KERNEL_COSTS = {}


def declare_kernel_cost(kernel_name):
    """Decorator: register ``fn(eqn) -> cost dict`` for a kernel."""
    def wrap(fn):
        KERNEL_COSTS[str(kernel_name)] = fn
        return fn
    return wrap
