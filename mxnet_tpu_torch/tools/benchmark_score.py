"""Inference throughput of the vision model zoo: the port of
``examples/image_classification/benchmark_score.py``.

    python -m mxnet_tpu_torch.tools.benchmark_score [--network resnet50_v1]
        [--batch-sizes 1,2,4,8,16,32] [--image-shape 3,224,224]
        [--layout NCHW|NHWC] [--iters 20] [--warmup 5] [--cpu]

:func:`score` is the reference's: ``get_model(network, classes=1000)``,
Xavier initialization, ``hybridize(static_alloc=True)``, ``warmup``
forwards, then ``iters`` forwards of one batch of uniform [0, 1) images
timed on the host clock up to the last output's ``wait_to_read``;
images/s.  The weights are drawn on the device from a seeded
``torch.Generator``; the images from ``numpy.random.RandomState(0)``.
``--layout NHWC`` (ResNet only, as in the reference's zoo) feeds
``(N, H, W, C)`` images to a channels-last net; ``--image-shape`` stays
``C,H,W``.

Prints the reference's lines and, on the card, its name and power limit
as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
gives them.  Runs on the card unless ``--cpu`` is given; with no card and
no ``--cpu`` it raises.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from .. import initializer, nd
from ..base import resolve_device
from ..gluon.model_zoo import vision

__all__ = ["setup", "rate", "score", "card", "main"]


def setup(network, batch_size, image_shape, ctx=None, layout="NCHW"):
    """``(net, images)`` of :func:`score` on ``ctx`` (default: the card),
    built and initialized, not yet run."""
    dev = resolve_device(ctx)
    kwargs = {"classes": 1000}
    if layout != "NCHW":
        kwargs["layout"] = layout
    net = vision.get_model(network, **kwargs)
    net.initialize(initializer.Xavier(), ctx=dev,
                   rng=torch.Generator(device=dev).manual_seed(0))
    net.hybridize(static_alloc=True)
    shape = tuple(image_shape)
    if layout == "NHWC":
        shape = shape[1:] + shape[:1]
    rng = np.random.RandomState(0)
    x = nd.array(rng.rand(batch_size, *shape).astype(np.float32), ctx=dev)
    return net, x


def rate(net, x, iters=20, warmup=5):
    """Images/s of ``iters`` forwards of ``net`` on ``x`` after ``warmup``
    (module docstring)."""
    for _ in range(warmup):
        net(x).wait_to_read()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = net(x)
    out.wait_to_read()
    return x.shape[0] * iters / (time.perf_counter() - t0)


def score(network, batch_size, image_shape, iters=20, warmup=5, ctx=None,
          layout="NCHW"):
    """Images/s of ``iters`` timed forwards of ``network`` at
    ``batch_size`` (module docstring) on ``ctx`` (default: the card)."""
    net, x = setup(network, batch_size, image_shape, ctx, layout)
    return rate(net, x, iters, warmup)


def card():
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    """Run the command line; returns ``[(batch size, images/s), ...]``."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--network", default="resnet50_v1")
    parser.add_argument("--batch-sizes", default="1,2,4,8,16,32")
    parser.add_argument("--image-shape", default="3,224,224")
    parser.add_argument("--layout", default="NCHW", choices=("NCHW", "NHWC"))
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host instead of the card")
    args = parser.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    shape = tuple(int(i) for i in args.image_shape.split(","))
    print("network: %s (device: %s, layout %s)" % (args.network, dev,
                                                    args.layout))
    if dev.type == "cuda":
        print(card())
    out = []
    for bs in (int(b) for b in args.batch_sizes.split(",")):
        ips = score(args.network, bs, shape, args.iters, args.warmup,
                    ctx=dev, layout=args.layout)
        print("batch size %3d, image %s, %8.1f images/sec"
              % (bs, "x".join(map(str, shape)), ips))
        out.append((bs, ips))
    return out


if __name__ == "__main__":
    main()
