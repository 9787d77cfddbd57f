"""``mod`` — the Module API (the port of ``mxnet_tpu/module/``): inference
through :class:`Module`; ``BucketingModule`` and ``SequentialModule`` are
ROADMAP.md queue A, item 4."""
from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]
