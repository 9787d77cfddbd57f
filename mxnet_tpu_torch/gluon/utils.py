"""Carry a reference block's weights into the port's block.

:func:`from_jax_params` takes ``{name: numpy array}`` as the reference's
``collect_params()`` gives it (every parameter's ``.data()._data`` turned
to numpy), trainable weights and BatchNorm moving statistics alike, and
loads it into the port's block.

Names are matched relative to each side's block prefix: the outermost
block's prefix carries a process-wide counter (``resnetv10_`` here may
be ``resnetv13_`` in the process that built the reference), so
``<alias><n>_`` on the reference side matches ``<alias><m>_`` here.
"""
from __future__ import annotations

import re

import numpy as np

from ..base import MXNetError, resolve_device

__all__ = ["from_jax_params", "relative_names"]


def _prefix_pattern(prefix):
    m = re.fullmatch(r"(.*?)\d+_", prefix)
    return re.compile(re.escape(m.group(1)) + r"\d+_" if m
                      else re.escape(prefix))


def relative_names(names, prefix):
    """``{name relative to the block prefix: full name}`` for ``names``
    that all start with one prefix of the form of ``prefix`` (the same
    alias, any counter); raises :class:`MXNetError` otherwise."""
    pat = _prefix_pattern(prefix)
    out, seen = {}, set()
    for n in names:
        m = pat.match(n)
        if m is None:
            raise MXNetError("parameter %r is outside the block prefix %r"
                             % (n, prefix))
        seen.add(m.group(0))
        out[n[m.end():]] = n
    if len(seen) > 1:
        raise MXNetError("parameters come from several blocks: prefixes %s"
                         % sorted(seen))
    return out


def from_jax_params(block, arrays, device=None):
    """Load ``arrays`` (``{reference name: numpy array}``) into ``block``.

    ``device`` (default CUDA, see ``resolve_device``) is where an
    uninitialized (or deferred) parameter is created; an initialized one
    must already live there.  Raises :class:`MXNetError` on a missing
    name, an extra name or a wrong shape, before anything is written."""
    dev = resolve_device(device)
    params = block.collect_params()
    mine = relative_names(list(params.keys()), block.prefix)
    theirs = relative_names(list(arrays.keys()), block.prefix)
    missing = sorted(set(mine) - set(theirs))
    extra = sorted(set(theirs) - set(mine))
    if missing or extra:
        raise MXNetError("from_jax_params: missing %s, extra %s"
                         % (missing, extra))
    for rel, name in mine.items():
        p, a = params[name], np.asarray(arrays[theirs[rel]])
        shape = p.shape
        if shape is None or len(shape) != a.ndim or any(
                s not in (0, d) for s, d in zip(shape, a.shape)):
            raise MXNetError("from_jax_params: %s has shape %s, the array "
                             "%s" % (name, shape, a.shape))
        if p._data is not None and p._data.device != dev:
            raise MXNetError("from_jax_params: %s lives on %s, not %s"
                             % (name, p._data.device, dev))
    for rel, name in mine.items():
        params[name].set_data(np.asarray(arrays[theirs[rel]]), device=dev)
    return block
