"""MNIST training through ``Module.fit``: the port of
``examples/image_classification/train_mnist.py``.

    python -m mxnet_tpu_torch.tools.train_mnist [--network mlp|lenet]
        [--data-dir DIR] [--batch-size 64] [--lr 0.1] [--num-epochs 5]
        [--kv-store local] [--model-prefix P] [--load-epoch N] [--cpu]

The MLP (128-64-10) or LeNet (two 5x5 tanh convolutions with max pools,
500 hidden, 10 classes) under ``SoftmaxOutput``; ``MNISTIter`` over the
idx files of ``--data-dir``, or, when they are absent, 2,048 seeded
uniform images with random labels (3/4 train, 1/4 validation), as the
reference's script does.  SGD with momentum 0.9, ``Xavier``
initialization, ``Speedometer`` every 50 batches, a checkpoint per epoch
with ``--model-prefix``.  Runs on the card unless ``--cpu`` is given.
:func:`main` returns the trained module.
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from .. import callback, initializer, io, model, module, symbol as sym
from ..context import cpu, gpu

__all__ = ["get_mlp", "get_lenet", "get_iters", "main"]


def get_mlp():
    data = sym.Variable("data")
    data = sym.Flatten(data)
    fc1 = sym.FullyConnected(data, num_hidden=128, name="fc1")
    act1 = sym.Activation(fc1, act_type="relu")
    fc2 = sym.FullyConnected(act1, num_hidden=64, name="fc2")
    act2 = sym.Activation(fc2, act_type="relu")
    fc3 = sym.FullyConnected(act2, num_hidden=10, name="fc3")
    return sym.SoftmaxOutput(fc3, name="softmax")


def get_lenet():
    data = sym.Variable("data")
    conv1 = sym.Convolution(data, kernel=(5, 5), num_filter=20)
    tanh1 = sym.Activation(conv1, act_type="tanh")
    pool1 = sym.Pooling(tanh1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    conv2 = sym.Convolution(pool1, kernel=(5, 5), num_filter=50)
    tanh2 = sym.Activation(conv2, act_type="tanh")
    pool2 = sym.Pooling(tanh2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    flatten = sym.Flatten(pool2)
    fc1 = sym.FullyConnected(flatten, num_hidden=500)
    tanh3 = sym.Activation(fc1, act_type="tanh")
    fc2 = sym.FullyConnected(tanh3, num_hidden=10)
    return sym.SoftmaxOutput(fc2, name="softmax")


def get_iters(args):
    """``(train, val)``: the idx files of ``args.data_dir``, or the
    seeded synthetic set."""
    img = os.path.join(args.data_dir, "train-images-idx3-ubyte.gz")
    lab = os.path.join(args.data_dir, "train-labels-idx1-ubyte.gz")
    flat = args.network == "mlp"
    if os.path.isfile(img) and os.path.isfile(lab):
        train = io.MNISTIter(image=img, label=lab,
                             batch_size=args.batch_size, flat=flat)
        vimg = os.path.join(args.data_dir, "t10k-images-idx3-ubyte.gz")
        vlab = os.path.join(args.data_dir, "t10k-labels-idx1-ubyte.gz")
        val = io.MNISTIter(image=vimg, label=vlab,
                           batch_size=args.batch_size, flat=flat,
                           shuffle=False) if os.path.isfile(vimg) else None
        return train, val
    logging.warning("MNIST files not found under %s — using synthetic data",
                    args.data_dir)
    rng = np.random.RandomState(0)
    n = 2048
    X = rng.rand(n, 784).astype(np.float32) if flat else \
        rng.rand(n, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.float32)
    split = n * 3 // 4
    return (io.NDArrayIter(X[:split], y[:split], args.batch_size,
                           shuffle=True),
            io.NDArrayIter(X[split:], y[split:], args.batch_size))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--network", default="mlp", choices=["mlp", "lenet"])
    parser.add_argument("--data-dir", default=os.path.join(
        "~", ".mxnet", "datasets", "mnist"))
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--num-epochs", type=int, default=5)
    parser.add_argument("--kv-store", default="local")
    parser.add_argument("--model-prefix", default=None)
    parser.add_argument("--load-epoch", type=int, default=None)
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU (default: the card)")
    args = parser.parse_args(argv)
    args.data_dir = os.path.expanduser(args.data_dir)
    return args


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    net = get_mlp() if args.network == "mlp" else get_lenet()
    train, val = get_iters(args)
    mod = module.Module(net, context=cpu() if args.cpu else gpu())
    checkpoint = callback.do_checkpoint(args.model_prefix) \
        if args.model_prefix else None
    arg_params = aux_params = None
    begin = 0
    if args.model_prefix and args.load_epoch is not None:
        _, arg_params, aux_params = model.load_checkpoint(
            args.model_prefix, args.load_epoch)
        begin = args.load_epoch
    mod.fit(train, eval_data=val, kvstore=args.kv_store, optimizer="sgd",
            optimizer_params={"learning_rate": args.lr, "momentum": 0.9},
            initializer=initializer.Xavier(), num_epoch=args.num_epochs,
            arg_params=arg_params, aux_params=aux_params, begin_epoch=begin,
            batch_end_callback=callback.Speedometer(args.batch_size, 50),
            epoch_end_callback=checkpoint)
    return mod


if __name__ == "__main__":
    main()
