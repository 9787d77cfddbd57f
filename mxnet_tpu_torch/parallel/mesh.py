"""Meshes and ``MeshPlan``: the port of ``mxnet_tpu/parallel/mesh.py``.

**Meshes** (``make_mesh``, ``data_parallel_mesh``, ``replicated``,
``batch_sharded``, reference ``mesh.py:21-45,194-200``).  A port
:class:`Mesh` names the device of each rank and how its ranks reach each
other, which is one of two placements (``parallel/comm.py``):

- **in-process ranks**: every rank names one device and the K ranks run
  in turn on it, the counterpart of the reference's
  ``make_mesh((k,), ("data",), devices)`` on one card; a one-card host
  trains at any K this way (NCCL refuses two ranks on one GPU).
- **one rank per process** over ``torch.distributed`` (NCCL on cards,
  gloo on the CPU): ``data_parallel_mesh()`` once a process group is up,
  or ``make_mesh(..., process_group=True)``; each process holds its rank.

The placement is chosen when the mesh is built and never swapped.
``PartitionSpec`` and ``NamedSharding`` are the reference's names for a
layout; here they only declare one (a batch split over ``data``, or a
parameter replicated).

**``MeshPlan``** (``data × model × sequence × pipe``): the arithmetic
(``size``/``present``/``total``/``axis_sizes``/``batch_axes``/
``resolve``/``coerce``/``describe``) is the reference's; what a plan may
hold, and where its ranks live, is narrower:

- The port runs a plan on **one device**.  The ranks of its ``model``
  and ``sequence`` axes are two leading dimensions of the activations,
  ``(Km, Ks, B, T/Ks, ...)`` — the ``vmap(axis_name=...)`` spelling of
  the reference's per-replica program.  Over the sequence dimension
  ``ppermute`` is ``torch.roll``, ``pmean`` a mean, ``axis_index`` an
  ``arange``; over the model dimension ``psum`` is a sum broadcast back,
  ``pmax`` an ``amax``, ``axis_index`` an ``arange`` and a tiled
  ``all_gather`` a concatenation (``transformer/layers.py``).  The
  model collectives sit inside each layer (the row-parallel psum after
  attention and the FFN, the vocab psum and pmax in the loss), so every
  model rank's partial must exist before the next op: the model ranks
  cannot run in turn.  The ranks of the ``data`` axis do run in turn,
  each on its rows of the batch (``transformer/step.py``).  The numbers
  are those of the reference's plan; no O(T/K) memory, nor a 1/Km share
  of the parameters, per card is claimed.
- :meth:`MeshPlan.build_mesh` returns an in-process :class:`Mesh` on one
  device.  The reference's ``axis_env`` feeds ``jax.make_jaxpr`` and
  has no counterpart here.
- ``pipeline > 1`` raises: the 1F1B pipeline is the rest of item 8.
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["make_mesh", "data_parallel_mesh", "local_device_count",
           "replicated", "batch_sharded", "MeshPlan", "Mesh",
           "NamedSharding", "PartitionSpec"]


class PartitionSpec(tuple):
    """A layout per dimension, by mesh axis name (``None``: not split);
    ``PartitionSpec()`` is replicated (the reference's jax name)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


class NamedSharding:
    """A mesh and a :class:`PartitionSpec`: where a tensor's parts live."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    @property
    def device(self):
        """The device this process puts a tensor of this layout on."""
        return self.mesh.local_device

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and self.mesh is other.mesh
                and self.spec == other.spec)

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


class Mesh:
    """Named axes over ranks, each rank naming its device.

    ``process_group`` False: every rank lives in this process (they must
    all name one device, and run in turn on it); True: one rank per
    process over the default ``torch.distributed`` group, this process
    holding rank ``get_rank()`` on ``devices`` of that rank."""

    def __init__(self, devices, axis_names, process_group=False):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_group = bool(process_group)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError("mesh of shape %r needs %d axis names, got %r"
                             % (self.devices.shape, self.devices.ndim,
                                self.axis_names))

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def axis_size(self, axis):
        return int(self.shape.get(axis, 1))

    @property
    def local_device(self):
        """The device of this process's ranks."""
        if self.process_group:
            import torch.distributed as dist
            return self.devices.flat[dist.get_rank()]
        return self.devices.flat[0]

    def comm(self, axis="data"):
        """The collectives over ``axis`` for this mesh's placement
        (``parallel/comm.py``)."""
        from . import comm as _comm
        k = self.axis_size(axis)
        if self.process_group:
            return _comm.ProcessGroupComm(k, self.local_device)
        devs = {str(d) for d in self.devices.flat}
        if len(devs) != 1:
            raise ValueError(
                "the ranks of an in-process mesh run in turn on one device; "
                "this mesh names %s.  One rank per card is one process per "
                "card over torch.distributed (data_parallel_mesh() after "
                "init_process_group); the ranks of a multi-card process are "
                "ROADMAP.md queue A, item A6(c)" % sorted(devs))
        return _comm.InProcessComm(k, self.local_device)

    def __repr__(self):
        return "Mesh(%r, %s%s)" % (self.shape, self.local_device,
                                   ", process_group" if self.process_group
                                   else "")


def _device_list(devices):
    from ..base import resolve_device
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            resolve_device(None)   # raises: no CUDA device
        return [torch.device("cuda", i) for i in range(n)]
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    return [resolve_device(d) for d in devices]


def local_device_count():
    """Cards visible to this process (the reference's local device
    count)."""
    return torch.cuda.device_count()


def make_mesh(shape=None, axis_names=("data",), devices=None,
              process_group=False):
    """Build a :class:`Mesh`.  ``shape`` is a tuple matching
    ``axis_names``; default: every device on one ``data`` axis.  A list
    naming one device K times puts K in-process ranks on it.  With
    ``process_group=True`` the ranks are the processes of the default
    ``torch.distributed`` group (``devices``: each rank's device; default
    this process's card, or the CPU under gloo)."""
    if process_group:
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("make_mesh(process_group=True) needs "
                               "torch.distributed.init_process_group first")
        world = dist.get_world_size()
        if devices is None:
            if dist.get_backend() == "nccl":
                devices = [torch.device("cuda", torch.cuda.current_device())
                           ] * world
            else:
                devices = ["cpu"] * world
        devs = _device_list(devices)
        if shape is None:
            shape = (world,) + (1,) * (len(axis_names) - 1)
        if int(_np.prod(shape)) != world or len(devs) != world:
            raise ValueError("a process-group mesh has one rank per process: "
                             "shape %r and %d devices against world size %d"
                             % (shape, len(devs), world))
    else:
        devs = _device_list(devices)
        if shape is None:
            shape = (len(devs),) + (1,) * (len(axis_names) - 1)
    n = int(_np.prod(shape))
    if n > len(devs):
        raise ValueError("mesh shape %r needs %d devices, have %d"
                         % (shape, n, len(devs)))
    arr = _np.empty(n, dtype=object)
    for i, d in enumerate(devs[:n]):
        arr[i] = d
    return Mesh(arr.reshape(shape), axis_names, process_group=process_group)


def data_parallel_mesh(num=None):
    """All ranks on one ``data`` axis: the world of the process group
    once one is up (one rank per process), else one rank per card
    visible to this process (``num`` of them)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return make_mesh(None, ("data",), process_group=True)
    devices = _device_list(None)
    if num is not None:
        devices = devices[:num]
    return make_mesh((len(devices),), ("data",), devices)


def replicated(mesh):
    return NamedSharding(mesh, PartitionSpec())


def batch_sharded(mesh, axis="data"):
    """Sharding for a batch tensor: leading dim split on ``axis``."""
    return NamedSharding(mesh, PartitionSpec(axis))


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
        deferred ``data`` axis resolves to 1; a declared ``data`` axis
        runs its ranks in turn."""
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
        gradient mean covers."""
        return tuple(a for a in ("data", "sequence") if self.present(a))

    def batch_spec(self):
        """``PartitionSpec`` of a ``(batch, tokens)`` batch: rows over
        ``data``, tokens over ``sequence`` (collapsed axes absent)."""
        return PartitionSpec("data" if self.present("data") else None,
                             "sequence" if self.present("sequence")
                             else None)

    def build_mesh(self, devices=None):
        """An in-process :class:`Mesh` over the plan's collapsed axes, every
        rank on one device (``devices``: one device, or a list naming
        it; default the card)."""
        plan = self.on_one_device()
        names = plan.axis_names()
        shape = tuple(plan.size(a) for a in names)
        devs = _device_list(devices)
        if len({str(d) for d in devs}) != 1:
            raise ValueError(
                "MeshPlan.build_mesh runs every rank on one device; got %s "
                "(the ranks of a multi-card process are ROADMAP.md queue "
                "A, item A6(c))" % sorted({str(d) for d in devs}))
        return make_mesh(shape, names, devs[:1] * plan.total)

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
