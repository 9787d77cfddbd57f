"""The seeded global RNG: the port of ``mxnet_tpu/_rng.py``.

The reference derives a JAX PRNG key for every draw from one seeded
numpy ``RandomState`` (``next_key``), with a provider stack so that a
traced program draws from a key passed in as an argument.  The port runs
its hybridized blocks and executors eagerly, so it needs no stack: each
device has one explicit ``torch.Generator``, created lazily on that
device, and every random op of the port draws from
:func:`next_generator` of its output's device, in the order the program
makes the draws.  Nothing draws from torch's default generators.

:func:`seed` keeps the reference's contract: it reseeds every device's
generator and numpy's global RNG (``np.random.seed``), which the
initializers draw from when no ``rng=`` is given.  Before any
:func:`seed`, a generator starts from a nondeterministic seed, as the
reference's provider starts from numpy's unseeded state.
:func:`get_state` / :func:`set_state` snapshot and restore numpy's global
state and every generator's, so a resumed run draws the same sequence.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .base import as_torch_device

__all__ = ["seed", "next_generator", "get_state", "set_state"]

_lock = threading.Lock()
# the last seed given to seed(), None before the first
_seed = [None]
# device -> its generator
_gens = {}


def _key(device):
    dev = torch.device(as_torch_device(device))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _make(dev):
    g = torch.Generator(device=dev)
    if _seed[0] is None:
        g.seed()
    else:
        g.manual_seed(_seed[0])
    return g


def next_generator(device="cpu"):
    """The generator of ``device``: every random draw on that device
    comes from it (the port's ``next_key``).  The meta device (shape
    inference) draws nothing and has none: None."""
    dev = _key(device)
    if dev.type == "meta":
        return None
    g = _gens.get(dev)
    if g is None:
        with _lock:
            g = _gens.get(dev)
            if g is None:
                g = _gens[dev] = _make(dev)
    return g


def seed(seed_val):
    """``mx.random.seed``: every device's generator and numpy's global RNG
    start again from ``seed_val`` (reference: ``_rng.seed``)."""
    s = int(seed_val)
    with _lock:
        _seed[0] = s
        for g in _gens.values():
            g.manual_seed(s)
    np.random.seed(s)


def get_state():
    """A snapshot of numpy's global state and every generator's (what a
    checkpoint records so a resumed run draws the same sequence)."""
    with _lock:
        return {"numpy_state": np.random.get_state(), "seed": _seed[0],
                "generators": {str(d): g.get_state().clone()
                               for d, g in _gens.items()}}


def set_state(state):
    """Restore a :func:`get_state` snapshot.  A device with no generator
    in it starts afresh from the snapshot's seed at its next draw."""
    np.random.set_state(state["numpy_state"])
    with _lock:
        _seed[0] = state["seed"]
        _gens.clear()
        for name, st in state["generators"].items():
            dev = torch.device(name)
            g = torch.Generator(device=dev)
            g.set_state(st)
            _gens[dev] = g
