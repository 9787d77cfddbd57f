"""Mixed-precision policy: the port of ``mxnet_tpu/precision.py``
(``:149-271``) — bf16 compute with f32 masters and dynamic loss scaling.

- **dtype policy**: :func:`torch_dtype` reads a dtype name through the
  one table of names (``DTYPE_NAMES``, also ``Parameter.cast``'s);
  :func:`resolve_dtype` maps the trainer's ``dtype=`` knob to a torch
  dtype (``float32`` / ``bfloat16``); :func:`is_reduced` says whether
  loss scaling and master weights apply.
- **dynamic loss scaling**: :func:`init_loss_scale` gives the
  device-resident state (a 0-dim f32 scale and an int32 counter of
  consecutive finite steps), :func:`all_finite` the per-step inf/nan
  probe as a 0-dim bool tensor, and :func:`loss_scale_update` one tick of
  the grow/backoff machine, spelled with ``torch.where`` / ``minimum`` /
  ``maximum`` exactly as the reference's ``jnp`` spelling, so its
  ``(scale, good)`` sequence is bitwise the reference's.  None of them
  reads a value back to the host: a trainer that keeps the state on the
  card never synchronizes on it, and reads it only in ``flush()``.
- **telemetry**: :func:`record_loss_scale` publishes the live scale
  (``mxtpu_loss_scale``) and newly skipped steps
  (``mxtpu_loss_scale_skipped_steps_total``) through
  ``telemetry/metrics.py``.

``PRECISION_MASTER_F32`` and ``PRECISION_F32_GRAD_REDUCE`` keep the
reference's names.  Nothing in the port reads them: they are the
reference's mutation seams for its static analysis (ROADMAP.md queue A,
item 13).  The port's ZeRO-1 tier always keeps the f32 masters as each
rank's shard and reduces the gradients in f32 (``parallel/zero.py``).
"""
from __future__ import annotations

import torch

__all__ = ["PRECISION_MASTER_F32", "PRECISION_F32_GRAD_REDUCE",
           "LOSS_SCALE_INIT", "GROWTH_FACTOR", "BACKOFF_FACTOR",
           "GROWTH_INTERVAL", "MAX_SCALE", "MIN_SCALE", "DTYPE_NAMES",
           "torch_dtype", "resolve_dtype",
           "is_reduced", "init_loss_scale", "all_finite",
           "loss_scale_update", "record_loss_scale"]

# mutation seams of the reference's budget gates (module docstring)
PRECISION_MASTER_F32 = True
PRECISION_F32_GRAD_REDUCE = True

# the loss-scale state machine's pinned constants
LOSS_SCALE_INIT = 2.0 ** 15
GROWTH_FACTOR = 2.0
BACKOFF_FACTOR = 0.5
GROWTH_INTERVAL = 200
MAX_SCALE = 2.0 ** 24
MIN_SCALE = 1.0

# the dtype names the port takes: the trainer's ``dtype=`` knob
# (:func:`resolve_dtype`) and ``Parameter.cast`` both read them
DTYPE_NAMES = {"f32": torch.float32, "fp32": torch.float32,
               "float32": torch.float32, "bf16": torch.bfloat16,
               "bfloat16": torch.bfloat16, "fp16": torch.float16,
               "float16": torch.float16, "half": torch.float16}


def torch_dtype(spec):
    """The torch dtype of ``spec``: a torch dtype, a name in
    ``DTYPE_NAMES`` (any case) or anything ``numpy.dtype`` takes."""
    if isinstance(spec, torch.dtype):
        return spec
    if isinstance(spec, str) and spec.lower() in DTYPE_NAMES:
        return DTYPE_NAMES[spec.lower()]
    import numpy as np
    return torch.from_numpy(np.empty(0, dtype=np.dtype(spec))).dtype


def resolve_dtype(spec):
    """The trainer's ``dtype=`` knob -> ``torch.float32`` or
    ``torch.bfloat16``.  ``None`` means float32; a name, a torch dtype or
    a numpy dtype are taken (:func:`torch_dtype`)."""
    if spec is None:
        return torch.float32
    try:
        dtype = torch_dtype(spec)
    except TypeError:
        dtype = None
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("dtype must be float32 or bfloat16, got %r"
                         % (spec,))
    return dtype


def is_reduced(dtype):
    """True when ``dtype`` is a sub-f32 compute dtype (loss scaling and
    master weights apply)."""
    return dtype == torch.bfloat16


def init_loss_scale(device=None, init=LOSS_SCALE_INIT):
    """``(scale, good_steps)`` on ``device``: a 0-dim f32 scale and a 0-dim
    int32 counter of consecutive finite steps."""
    return (torch.full((), init, dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def all_finite(tensors):
    """0-dim bool tensor: every element of every tensor is finite (True
    for no tensors).  Nothing is read back to the host."""
    tensors = list(tensors)
    if not tensors:
        return torch.ones((), dtype=torch.bool)
    out = torch.isfinite(tensors[0]).all()
    for t in tensors[1:]:
        out = torch.logical_and(out, torch.isfinite(t).all())
    return out


def loss_scale_update(scale, good_steps, grads_finite,
                      growth_factor=GROWTH_FACTOR,
                      backoff_factor=BACKOFF_FACTOR,
                      growth_interval=GROWTH_INTERVAL,
                      max_scale=MAX_SCALE, min_scale=MIN_SCALE):
    """One tick of the grow/backoff machine:

    - finite grads: ``good_steps += 1``; after ``growth_interval``
      consecutive finite steps the scale grows by ``growth_factor``
      (capped at ``max_scale``) and the counter resets;
    - non-finite grads: the step is skipped, the scale shrinks by
      ``backoff_factor`` (floored at ``min_scale``), the counter resets.

    Returns ``(new_scale, new_good_steps)``, 0-dim f32 and int32 tensors
    on the scale's device; the caller derives "skipped" from
    ``grads_finite``."""
    scale = torch.as_tensor(scale, dtype=torch.float32)
    dev = scale.device
    good = torch.as_tensor(good_steps, dtype=torch.int32, device=dev)
    fin = torch.as_tensor(grads_finite, dtype=torch.bool, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    # the bounds as fill kernels, not host copies: no synchronization
    cap, floor = torch.full((), max_scale, **f32), \
        torch.full((), min_scale, **f32)
    grown_now = torch.logical_and(fin, good + 1 >= growth_interval)
    new_scale = torch.where(
        fin,
        torch.where(grown_now,
                    torch.minimum(scale * growth_factor, cap), scale),
        torch.maximum(scale * backoff_factor, floor))
    new_good = torch.where(torch.logical_and(fin,
                                             torch.logical_not(grown_now)),
                           good + 1, torch.zeros_like(good))
    return new_scale, new_good


def record_loss_scale(scale, skipped_delta=0, run_id=None):
    """Publish the live scale and any newly skipped steps through the
    telemetry registry (host values: call where a read is cheap, as
    ``DataParallelTrainer.flush`` does)."""
    from .telemetry.metrics import registry

    labels = {"run_id": run_id} if run_id else {}
    registry().gauge(
        "mxtpu_loss_scale",
        "current dynamic loss scale (mixed-precision training)"
    ).set(float(scale), **labels)
    if skipped_delta:
        registry().counter(
            "mxtpu_loss_scale_skipped_steps_total",
            "optimizer steps skipped on non-finite gradients"
        ).inc(int(skipped_delta), **labels)
