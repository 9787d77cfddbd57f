"""Device contexts: the port of ``mxnet_tpu/context.py``.

:class:`Context` is the reference's type (``device_type``,
``device_typeid``, ``device_id``, equality, a hash, ``str(ctx) ==
"cpu(0)"``), with ``gpu`` mapped to CUDA.  ``with ctx:`` makes it the
default of :func:`current_context` in this thread until the block ends;
scopes nest, and each thread has its own.  ``torch.device`` cannot be
subclassed, so a ``Context`` converts through
:func:`~mxnet_tpu_torch.base.resolve_device` wherever the port takes a
``ctx`` or a ``device`` (``ctx.torch_device()`` is its device, unchecked;
``ctx.type`` and ``ctx.index`` read as that device's).  A ``Context``
equals only a ``Context``, as in the reference: compare one with a
``torch.device`` through
:func:`~mxnet_tpu_torch.base.as_torch_device`.  ``NDArray.context`` is a
``Context``.

With no context set the default is the card: :func:`current_context`
is ``gpu(current CUDA device)`` and raises without one, as does
``gpu()``.  ``with use(device):`` is an alias of entering
``Context(device)`` that yields the ``torch.device``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .base import MXNetError, resolve_device

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "num_gpus",
           "current_context", "current_device", "gpu_memory_info", "use"]


class Context:
    """A device context; ``with ctx:`` sets the thread's default."""

    # .value: the thread's current context; .stack: what each open
    # ``with`` block replaced
    _default_ctx = threading.local()

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared"}
    devstr2type = {"cpu": 1, "gpu": 2, "cuda": 2, "cpu_pinned": 3,
                   "cpu_shared": 5}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
            return
        if isinstance(device_type, str) and device_type.startswith("cuda:"):
            device_type = torch.device(device_type)
        if isinstance(device_type, torch.device):
            if device_type.type not in ("cpu", "cuda"):
                raise MXNetError("unsupported device %r (want cuda or cpu)"
                                 % (device_type,))
            self.device_typeid = 1 if device_type.type == "cpu" else 2
            self.device_id = 0 if device_type.index is None \
                else int(device_type.index)
            if device_type.type == "cuda" and device_type.index is None \
                    and torch.cuda.is_available():
                self.device_id = torch.cuda.current_device()
            return
        if device_type not in Context.devstr2type:
            raise MXNetError("unknown device type %r (known: %s)"
                             % (device_type, sorted(Context.devstr2type)))
        self.device_typeid = Context.devstr2type[device_type]
        self.device_id = int(device_id)

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    def torch_device(self):
        """The ``torch.device`` of this context: the host for the CPU
        types, ``cuda:<id>`` for ``gpu`` (not checked against the
        machine; :func:`~mxnet_tpu_torch.base.resolve_device` checks)."""
        if self.device_typeid == 2:
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    @property
    def type(self):
        """``torch.device``'s type of this context: ``cpu`` or ``cuda``."""
        return "cuda" if self.device_typeid == 2 else "cpu"

    @property
    def index(self):
        """``torch.device``'s index: the card's id, None on the host."""
        return self.device_id if self.device_typeid == 2 else None

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def _stack(self):
        stack = getattr(Context._default_ctx, "stack", None)
        if stack is None:
            stack = Context._default_ctx.stack = []
        return stack

    def __enter__(self):
        # a per-thread stack, not one saved slot per instance: the same
        # Context may be entered in two threads or twice nested
        self._stack().append(getattr(Context._default_ctx, "value", None))
        Context._default_ctx.value = self
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        Context._default_ctx.value = self._stack().pop()

    def empty_cache(self):
        """Release the card's cached blocks (the reference frees the GPU
        pool); nothing to do on the host."""
        if self.device_typeid == 2 and torch.cuda.is_available():
            with torch.cuda.device(self.device_id):
                torch.cuda.empty_cache()


# the thread-local behind current_context() (``.value``)
_default = Context._default_ctx


def cpu(device_id=0):
    """The host (one host, whatever the id)."""
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    """Page-locked host memory: the host's device for the port's arrays."""
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    """CUDA device ``device_id``; raises :class:`MXNetError` without one."""
    ctx = Context("gpu", device_id)
    dev = resolve_device(ctx)
    if dev.index >= torch.cuda.device_count():
        raise MXNetError("gpu(%d): only %d CUDA device(s)"
                         % (device_id, torch.cuda.device_count()))
    return ctx


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context():
    """The thread's context (set by ``with ctx:`` or :func:`use`), else
    the current CUDA device's (raising when there is no card)."""
    cur = getattr(Context._default_ctx, "value", None)
    if cur is not None:
        return cur
    return Context(resolve_device(None))


def current_device():
    """:func:`current_context` as a checked ``torch.device``."""
    return resolve_device(getattr(Context._default_ctx, "value", None))


def gpu_memory_info(device_id=0):
    """``(free, total)`` bytes of CUDA device ``device_id``
    (``cudaMemGetInfo``, as the reference's); raises without a card."""
    dev = resolve_device(Context("gpu", device_id))
    return tuple(int(v) for v in torch.cuda.mem_get_info(dev))


@contextlib.contextmanager
def use(device):
    """Make ``device`` (a ``Context``, ``torch.device`` or string) the
    default of :func:`current_context` inside the ``with`` block, in
    this thread; yields its ``torch.device``."""
    ctx = Context(device)
    dev = resolve_device(ctx)
    with ctx:
        yield dev
