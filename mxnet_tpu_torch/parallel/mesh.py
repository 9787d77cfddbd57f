"""MeshPlan: the ``data × model × sequence × pipe`` declaration.

The counterpart of ``MeshPlan`` in ``mxnet_tpu/parallel/mesh.py``.  The
arithmetic (``size``/``present``/``total``/``axis_sizes``/
``batch_axes``/``resolve``/``coerce``/``describe``) is the reference's;
what a plan may hold, and where its ranks live, is narrower:

- The port runs a plan on **one device**.  The ranks of its ``sequence``
  axis are a leading dimension of size K of the activations — the
  ``vmap(axis_name="sequence")`` spelling of the reference's
  per-replica program: ``ppermute`` is ``torch.roll`` along that
  dimension, ``pmean`` a mean over it, ``axis_index`` an ``arange``.
  The numbers are those of the reference's plan; no O(T/K) memory per
  card is claimed.  Spreading the ranks over cards with NCCL is
  ROADMAP.md queue A, items 6-7.
- ``data`` therefore resolves to 1; a plan with ``data > 1`` can be
  declared, but :meth:`MeshPlan.on_one_device` (which the trainer calls)
  raises, naming item 6 (distributed data parallel).
- ``model > 1`` raises: the tensor-parallel layers over NCCL are item 7.
- ``pipeline > 1`` raises: the 1F1B pipeline is the rest of item 8.
"""
from __future__ import annotations

__all__ = ["MeshPlan"]


class MeshPlan:
    """A 2-4D mesh as pure declaration: ``data × model × sequence × pipe``.

    Any axis of size 1 **collapses**: it is absent from every collective.
    ``data=None`` defers the data-axis size to :meth:`resolve`."""

    AXES = ("data", "model", "sequence", "pipe")

    def __init__(self, data=None, model=1, sequence=1, pipeline=1):
        self.data = None if data is None else int(data)
        self.model = int(model)
        self.sequence = int(sequence)
        self.pipe = int(pipeline)
        for name in ("data", "model", "sequence", "pipe"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError("MeshPlan axis %r must be >= 1, got %r"
                                 % (name, v))
        if self.model > 1:
            raise NotImplementedError(
                "MeshPlan(model=%d): model-axis sharding over NCCL is not "
                "ported yet (ROADMAP.md queue A, item 7)" % self.model)
        if self.pipe > 1:
            raise NotImplementedError(
                "MeshPlan(pipeline=%d): the 1F1B pipeline is not ported yet "
                "(ROADMAP.md queue A, item 8, parallel/pipeline.py)"
                % self.pipe)

    @classmethod
    def coerce(cls, plan):
        """A MeshPlan from a MeshPlan / dict /
        (data, model, sequence[, pipeline]) tuple.  Dicts accept
        ``pipeline`` (the constructor kwarg) or ``pipe`` (the axis
        name) interchangeably."""
        if plan is None or isinstance(plan, cls):
            return plan
        if isinstance(plan, dict):
            plan = dict(plan)
            if "pipe" in plan:
                plan["pipeline"] = plan.pop("pipe")
            bad = set(plan) - {"data", "model", "sequence", "pipeline"}
            if bad:
                raise ValueError("MeshPlan axes are %r, got unknown %r"
                                 % (cls.AXES, sorted(bad)))
            return cls(**plan)
        if isinstance(plan, (tuple, list)) and len(plan) in (3, 4):
            return cls(*plan)
        raise ValueError("mesh_plan must be a MeshPlan, a "
                         "{data/model/sequence/pipeline: size} dict or "
                         "a (data, model, sequence[, pipeline]) tuple, "
                         "got %r" % (plan,))

    def resolve(self, n_devices):
        """Fill a deferred data-axis size from the device count.  Returns
        a fully-specified plan; raises when the device pool does not
        factor."""
        ms = self.model * self.sequence * self.pipe
        if self.data is not None:
            return self
        if n_devices % ms:
            raise ValueError(
                "cannot resolve MeshPlan(model=%d, sequence=%d, "
                "pipeline=%d) over %d devices: model*sequence*pipe=%d "
                "does not divide the pool"
                % (self.model, self.sequence, self.pipe, n_devices, ms))
        return MeshPlan(data=n_devices // ms, model=self.model,
                        sequence=self.sequence, pipeline=self.pipe)

    def on_one_device(self):
        """The plan as the port runs it: every rank on one device, so a
        deferred ``data`` axis resolves to 1; ``data > 1`` raises."""
        if self.size("data") > 1:
            raise NotImplementedError(
                "MeshPlan(data=%d): the port runs a plan's ranks on one "
                "device; data parallelism over NCCL is ROADMAP.md queue A, "
                "item 6" % self.data)
        return self if self.data is not None else MeshPlan(
            data=1, model=self.model, sequence=self.sequence,
            pipeline=self.pipe)

    def size(self, axis):
        v = getattr(self, axis)
        return 1 if v is None else int(v)

    @property
    def total(self):
        return (self.size("data") * self.model * self.sequence
                * self.pipe)

    def present(self, axis):
        """True when ``axis`` survives collapse (size > 1)."""
        return self.size(axis) > 1

    def axis_names(self):
        """The collapsed axis tuple (size-1 axes dropped); a fully
        degenerate plan keeps a single size-1 ``data`` axis."""
        names = tuple(a for a in self.AXES if self.present(a))
        return names or ("data",)

    def axis_sizes(self):
        """Collapsed ``{axis: size}``."""
        return {a: self.size(a) for a in self.axis_names()}

    def batch_axes(self):
        """The axes a (batch, tokens) batch is sharded over — what the
        gradient mean covers; ``("sequence",)`` or ``()`` in the port."""
        return tuple(a for a in ("data", "sequence") if self.present(a))

    def describe(self):
        return {"data": self.size("data"), "model": self.model,
                "sequence": self.sequence, "pipeline": self.pipe,
                "axes": list(self.axis_names())}

    def __repr__(self):
        return "MeshPlan(data=%r, model=%d, sequence=%d, pipeline=%d)" % (
            self.data, self.model, self.sequence, self.pipe)

    def __eq__(self, other):
        return (isinstance(other, MeshPlan) and self.data == other.data
                and self.model == other.model
                and self.sequence == other.sequence
                and self.pipe == other.pipe)
