"""``nd`` — the imperative NDArray namespace of the port (the counterpart
of ``mxnet_tpu/ndarray/``).  Functions are generated from the op
registry (``register.py``); ``nd.contrib.<op>`` holds the ``_contrib_*``
ops without their prefix.  Sparse arrays are ROADMAP.md queue A,
item 10."""
from __future__ import annotations

import sys
import types

from ..ops import registry as _reg
from .ndarray import NDArray, array, invoke, np_dtype, torch_dtype
from .register import populate as _populate

__all__ = ["NDArray", "array", "invoke", "np_dtype", "torch_dtype",
           "contrib"]

_reg.load_all()
contrib = types.ModuleType(__name__ + ".contrib")
sys.modules[contrib.__name__] = contrib
_populate(sys.modules[__name__], contrib)
