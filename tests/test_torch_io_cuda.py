"""The data pipeline of mxnet_tpu_torch on the card (marked ``cuda``;
skipped without one).  This file imports no JAX, so it runs on the GPU
host:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_io_cuda.py

- The device tail on the card is bitwise its plain version (the same
  torch ops on the CPU) in float32 and bfloat16, NCHW and NHWC: both are
  IEEE division and round-to-nearest-even casts.
- With CUDA initialised in the parent, the pipeline's and the
  ``DataLoader``'s worker processes never initialise it (each worker
  checks after every batch, and a ``DataLoader`` probe reports it).
- ``DeviceFeedIter`` with a transform holds at most ``depth`` batches on
  the card under a slow consumer, and its batches equal the CPU tail's.
"""
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import io
from mxnet_tpu_torch.gluon import data
from mxnet_tpu_torch.io import bench, make_device_tail
from mxnet_tpu_torch.io.pipeline import ImagePipelineIter

MEAN = (123.68, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.zeros(1, device="cuda")
    assert torch.cuda.is_initialized()


def _cuda_probe(samples):
    # runs in a DataLoader worker (module-level: the worker imports this
    # file, which imports no JAX)
    return np.array([torch.cuda.is_initialized(), os.getpid()])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_tail_on_the_card_is_bitwise_its_plain_version(card, dtype, layout):
    rng = np.random.RandomState(0)
    u8 = torch.from_numpy(rng.randint(0, 256, (32, 56, 56, 3)).astype(
        np.uint8))
    tail = make_device_tail(MEAN, STD, dtype, layout)
    got = tail(u8.cuda())
    want = tail(u8)
    assert got.device.type == "cuda" and got.dtype == want.dtype
    assert got.is_contiguous()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_workers_never_initialise_cuda(card):
    with tempfile.TemporaryDirectory() as tmp:
        rec, idx = bench.fixture_rec(24, tmp)
        it = ImagePipelineIter(num_workers=2, seed=0, path_imgrec=rec,
                               path_imgidx=idx, batch_size=8,
                               data_shape=(3, 224, 224), resize=256)
        try:
            batches = [b.data[0].asnumpy() for b in it]
        finally:
            it.close()
    assert len(batches) == 3 and batches[0].shape == (8, 3, 224, 224)
    loader = data.DataLoader(data.SimpleDataset(list(range(8))), 2,
                             batchify_fn=_cuda_probe, num_workers=2)
    try:
        probes = list(loader)
    finally:
        loader.shutdown()
    assert len(probes) == 4
    assert not any(p[0] for p in probes)
    assert all(p[1] != os.getpid() for p in probes)


@pytest.mark.cuda
def test_device_feed_with_transform_holds_depth_batches(card):
    rng = np.random.RandomState(1)
    u8 = rng.randint(0, 256, (64, 32, 32, 3)).astype(np.uint8)
    y = np.arange(64, dtype=np.float32)
    tail = make_device_tail(MEAN, STD, "bfloat16", "NCHW")
    feed = io.DeviceFeedIter(io.NDArrayIter(u8, y, 8), transform=tail,
                             depth=2)
    got = []
    for b in feed:
        time.sleep(0.02)
        assert b.data[0].context.type == "cuda"
        got.append(b.data[0]._data.cpu())
    assert len(got) == 8 and feed.live_slots_max <= 2
    want = tail(torch.from_numpy(u8))
    assert torch.equal(torch.cat(got), want)
