"""Gluon utilities: the port of ``mxnet_tpu/gluon/utils.py``
(``split_data``, ``split_and_load``, ``clip_global_norm``,
``check_sha1``; ``download`` raises, the port fetching nothing), and the
carrying of a reference block's weights into the port's block.

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

import hashlib
import math
import re
import warnings

import numpy as np

from .. import ndarray as nd
from ..base import MXNetError, resolve_device
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download", "from_jax_params", "relative_names"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` cut along ``batch_axis`` into ``num_slice`` slices, the last
    taking the remainder when ``even_split`` is off."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError("batch size %d cannot be evenly split into %d "
                         "slices" % (size, num_slice))
    step = size // num_slice
    return [data.slice_axis(batch_axis, i * step,
                            (i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split into one slice per context and each slice placed on
    its context."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Scale ``arrays`` in place so their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling (a host float)."""
    total = math.sqrt(sum(float(a.norm().asscalar()) ** 2 for a in arrays))
    if not np.isfinite(total):
        warnings.warn("nan or inf in gradient norm")
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a *= scale
    return total


def check_sha1(filename, sha1_hash):
    """Whether ``filename``'s SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            sha1.update(block)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, **kwargs):
    """The port fetches nothing over the network: place the file locally
    and open it by path."""
    raise MXNetError("gluon.utils.download(%r): the port does not fetch "
                     "files; place the file locally" % (url,))


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
