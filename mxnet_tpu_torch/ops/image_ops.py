"""The ``_image_*`` ops behind ``nd.image``: the port of
``mxnet_tpu/ops/image_ops.py`` (reference: src/operator/image/
image_random.cc).  Divisions are by a 0-d tensor on the data's device,
so the card divides as the CPU does (a Python divisor becomes a
multiplication by its reciprocal there)."""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["image_to_tensor", "image_normalize"]


@register("_image_to_tensor", arg_names=["data"])
def image_to_tensor(data):
    """HWC uint8 in [0, 255] -> CHW float32 in [0, 1]; NHWC -> NCHW."""
    x = data.to(torch.float32)
    x = x / x.new_full((), 255.0)
    return x.permute(2, 0, 1) if x.dim() == 3 else x.permute(0, 3, 1, 2)


def _per_channel(v, data):
    """``v`` (a number or a sequence) as a tensor of ``data``'s dtype on
    its device, shaped to broadcast over CHW / NCHW channels."""
    t = torch.as_tensor(v, dtype=data.dtype)
    if t.dim():
        t = t.reshape((-1, 1, 1) if data.dim() != 4 else (1, -1, 1, 1))
    return t.to(data.device, non_blocking=True)


@register("_image_normalize", arg_names=["data"])
def image_normalize(data, mean=0.0, std=1.0):
    """``(data - mean) / std`` per channel of CHW / NCHW tensors."""
    return (data - _per_channel(mean, data)) / _per_channel(std, data)
