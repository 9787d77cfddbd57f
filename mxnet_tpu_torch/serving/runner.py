"""ModelRunner: a bound Module behind fixed padded batch buckets — the
port of ``mxnet_tpu/serving/runner.py``.

Every request batch is zero-padded up to the smallest bucket that fits,
every bucket runs once at load (``warmup()``), and the executor's set of
executed signatures (``Module.jit_cache_keys()``) lets callers assert that
steady-state traffic never adds one (``recompiles_since_warmup() == 0``).
The runner runs where its Module is bound, which must be ``device`` (the
CUDA device unless the caller asks for the CPU).

Not ported yet: Gluon blocks as the model (ROADMAP.md queue A, item 2)
and the modeled cost (``modeled_cost()`` is ``{}`` and
``modeled_peak_hbm()`` None until mxcost, item 13, as the reference
reports for a model it cannot price; a memory cap raises, naming it).
"""
from __future__ import annotations

import os
import threading

import numpy as _np

from ..base import MXNetError, resolve_device
from ..context import current_device

__all__ = ["ModelRunner", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (1, 4, 16, 64)


class ModelRunner:
    """Bucketed forward over a bound, initialized Module.

    Parameters
    ----------
    model : Module, bound (``for_training=False``) with its parameters set
    buckets : ascending batch sizes run at load; requests pad up to the
        smallest fitting bucket, larger batches split into max-bucket
        chunks
    example_shape : per-example input shape (no batch dim); inferred from
        the Module's ``data_shapes``
    dtype : input dtype (the Module's data desc by default)
    lint : run SRV001/SRV002 over the Module's symbol at load; an error
        finding (a graph that is not batch-polymorphic) raises
    warmup : run every bucket now and snapshot the signature baseline
    device : where the Module must be bound (default: the CUDA device)
    """

    def __init__(self, model, buckets=DEFAULT_BUCKETS, example_shape=None,
                 dtype=None, lint=True, warmup=True, hbm_cap_bytes=None,
                 provenance=None, device=None):
        if hbm_cap_bytes is None:
            hbm_cap_bytes = int(os.environ.get(
                "MXTPU_SERVING_HBM_CAP", "0")) or None
        if hbm_cap_bytes:
            raise NotImplementedError(
                "ModelRunner(hbm_cap_bytes=...) checks a modeled memory "
                "cost (SRV003): ROADMAP.md queue A, item 13")
        self.hbm_cap_bytes = None
        self.provenance = dict(provenance) if provenance else None
        if not buckets:
            raise MXNetError("ModelRunner needs at least one bucket")
        self.buckets = tuple(sorted(int(b) for b in set(buckets)))
        if self.buckets[0] < 1:
            raise MXNetError("buckets must be positive, got %r"
                             % (self.buckets,))
        if not (hasattr(model, "bind") and hasattr(model, "binded")):
            raise NotImplementedError(
                "ModelRunner over a Gluon block is ROADMAP.md queue A, "
                "item 2; pass a bound Module")
        if not model.binded or not model.params_initialized:
            raise MXNetError("ModelRunner needs a bound, initialized Module")
        self.device = current_device() if device is None \
            else resolve_device(device)
        if model.context != self.device:
            raise MXNetError("the Module is bound on %s, the runner's device "
                             "is %s" % (model.context, self.device))
        self._model = model
        self._lock = threading.Lock()
        desc = model.data_shapes[0]
        self._data_name = desc.name
        self.example_shape = tuple(desc.shape[1:]) \
            if example_shape is None else tuple(example_shape)
        self.dtype = dtype or getattr(desc, "dtype", _np.float32)
        if lint:
            self._lint_symbol()
        self._warm_keys = frozenset()
        self.warmed_up = False
        if warmup:
            self.warmup()

    def _lint_symbol(self):
        from ..analysis import ERROR, lint_serving, render_text
        shapes = {d.name: d.shape for d in self._model.data_shapes}
        findings = lint_serving(self._model.symbol, data_shapes=shapes)
        errors = [f for f in findings if f.severity == ERROR]
        if errors:
            raise MXNetError("symbol cannot be served recompile-free:\n%s"
                             % render_text(errors))
        if findings:
            import warnings
            warnings.warn("serving lint:\n%s" % render_text(findings))

    def modeled_cost(self):
        """``{}``: the static cost model is ROADMAP.md queue A, item 13."""
        return {}

    def modeled_peak_hbm(self):
        """None: not modeled (ROADMAP.md queue A, item 13); a fleet counts
        such a runner against its cap only with an explicit
        ``hbm_bytes``."""
        return None

    @property
    def max_batch(self):
        return self.buckets[-1]

    def bucket_for(self, n):
        """Smallest bucket that fits ``n`` requests (``n`` capped at the
        max bucket by the chunking in forward_batch)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _forward_bucket(self, x):
        """Forward one exactly-bucket-sized array; returns numpy output."""
        from .. import io as _io
        from .. import ndarray as nd
        data = [nd.array(x, ctx=self.device, dtype=x.dtype)]
        label = None
        if self._model.label_shapes:
            # the label feed's batch axis follows the bucket too, so the
            # executed signatures stay one per bucket
            label = [nd.array(_np.zeros((x.shape[0],) + tuple(d.shape[1:]),
                                        _np.float32), ctx=self.device)
                     for d in self._model.label_shapes]
        self._model.forward(_io.DataBatch(data=data, label=label),
                            is_train=False)
        return self._model.get_outputs()[0].asnumpy()

    def forward_batch(self, x):
        """Run ``x`` of shape ``(n,) + example_shape`` through the model,
        padding up to the nearest bucket (splitting above the max bucket),
        and return outputs for exactly the ``n`` real rows."""
        x = _np.ascontiguousarray(x, dtype=_np.dtype(self.dtype))
        if x.shape[1:] != self.example_shape:
            raise MXNetError(
                "request shape %r does not match example_shape %r"
                % (x.shape[1:], self.example_shape))
        n = x.shape[0]
        if n == 0:
            raise MXNetError("empty request batch")
        outs = []
        with self._lock:
            for start in range(0, n, self.max_batch):
                chunk = x[start:start + self.max_batch]
                bucket = self.bucket_for(chunk.shape[0])
                if chunk.shape[0] < bucket:
                    pad = _np.zeros((bucket - chunk.shape[0],)
                                    + self.example_shape, dtype=x.dtype)
                    chunk_in = _np.concatenate([chunk, pad], axis=0)
                else:
                    chunk_in = chunk
                outs.append(self._forward_bucket(chunk_in)[:chunk.shape[0]])
        return _np.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]

    def predict(self, example):
        """Single-example convenience: ``example_shape`` in, one row out."""
        return self.forward_batch(_np.asarray(example)[None])[0]

    def warmup(self):
        """Run every bucket once, then snapshot the executed signatures;
        any growth of the set under traffic is a steady-state recompile."""
        for b in self.buckets:
            self._forward_bucket(_np.zeros((b,) + self.example_shape,
                                           dtype=_np.dtype(self.dtype)))
        self._warm_keys = frozenset(self.jit_cache_keys())
        self.warmed_up = True
        return self._warm_keys

    def jit_cache_keys(self):
        return set(self._model.jit_cache_keys())

    def recompiles_since_warmup(self):
        """Signatures added after warmup — 0 under steady-state traffic."""
        return len(self.jit_cache_keys() - self._warm_keys)

    def __repr__(self):
        return "<ModelRunner Module buckets=%s example=%s on %s>" % (
            list(self.buckets), self.example_shape, self.device)
