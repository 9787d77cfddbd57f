"""``mod`` — the Module API, the port of ``mxnet_tpu/module/``:
``Module`` (training and inference on one device), ``BucketingModule``,
``SequentialModule`` and the loops of ``BaseModule``."""
from .base_module import BaseModule, BatchEndParam
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "BatchEndParam"]
