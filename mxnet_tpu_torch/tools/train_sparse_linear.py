"""Sparse linear classification on a row-sparse weight: the port of
``examples/sparse/linear_classification.py``.

    python -m mxnet_tpu_torch.tools.train_sparse_linear [--feat-dim 1000]
        [--nnz 20] [--batch-size 64] [--num-batches 100] [--lr 1.0]
        [--kv-store local] [--ctx gpu|cpu]

Reference: MXNet's ``example/sparse/linear_classification``.  A LibSVM
file with a planted linear rule (:func:`write_libsvm`, the example's
writer, byte for byte) feeds ``io.LibSVMIter``, whose CSR batches are
built on the host and moved to the device.  The ``(feat_dim, 1)`` weight
lives in a kvstore that runs SGD at push time.  Each step
(:func:`train_step`): ``row_sparse_pull`` of the batch's rows (into a
dense array: the whole stored weight, copied), the scores as the sparse
``dot`` of the batch and the weight, the sigmoid on the host, the
gradient ``X^T (p - y) / B`` as the transposed sparse ``dot``, cast to
``row_sparse`` and ``retain``-ed to the batch's rows, and its push (the
store's lazy row-wise SGD).  The script asserts that the running
accuracy passes 0.7, as the example does.  Runs on the card unless
``--ctx cpu``; :func:`main` returns the accuracy, each batch's
probabilities and the final weight.
"""
from __future__ import annotations

import argparse
import logging
import os
import shutil
import tempfile

import numpy as np

from .. import io, kvstore, nd, optimizer
from ..context import cpu, gpu, use
from ..ndarray import sparse

__all__ = ["write_libsvm", "parse_args", "make_store", "train_step",
           "STEP_PARTS", "main"]

# the parts of a step, in order, each ending at one ``marks`` call
STEP_PARTS = ("to device", "pull", "forward dot", "host sigmoid",
              "transpose dot", "cast_storage", "retain", "push + update")


def write_libsvm(path, num_samples, feat_dim, nnz, rng):
    """Write a LibSVM text file with a planted linear rule (the input
    format of the reference's example/sparse/linear_classification)."""
    w_true = rng.randn(feat_dim).astype(np.float32)
    with open(path, "w") as f:
        for _ in range(num_samples):
            idx = np.sort(rng.choice(feat_dim, nnz, replace=False))
            val = rng.randn(nnz).astype(np.float32)
            label = 1.0 if (w_true[idx] * val).sum() > 0 else 0.0
            toks = " ".join("%d:%.5f" % (i, v) for i, v in zip(idx, val))
            f.write("%g %s\n" % (label, toks))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--feat-dim", type=int, default=1000)
    parser.add_argument("--nnz", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--num-batches", type=int, default=100)
    parser.add_argument("--lr", type=float, default=1.0)
    parser.add_argument("--kv-store", default="local")
    parser.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    return parser.parse_args(argv)


def make_store(kv_store, feat_dim, lr):
    """The store holding the zero ``(feat_dim, 1)`` weight under
    ``"weight"``, running SGD at ``lr`` at push time (on the current
    device)."""
    kv = kvstore.create(kv_store)
    kv.init("weight", nd.zeros((feat_dim, 1)))
    kv.set_optimizer(optimizer.create("sgd", learning_rate=lr))
    return kv


def train_step(kv, w_local, batch, device, marks=None):
    """One step on ``batch`` (a host batch of ``LibSVMIter``); returns the
    probabilities and the labels, numpy.  ``marks(part)`` is called as
    each of :data:`STEP_PARTS` ends."""
    mark = marks or (lambda part: None)
    x_csr = batch.data[0]
    y = batch.label[0].asnumpy()
    batch_rows = np.unique(x_csr.indices.asnumpy())
    x_csr = x_csr.as_in_context(device)
    mark("to device")
    kv.row_sparse_pull("weight", out=w_local,
                       row_ids=nd.array(batch_rows.astype(np.float32)))
    mark("pull")
    # forward: CSR x dense on the device, no densify
    score = sparse.dot(x_csr, w_local)
    mark("forward dot")
    p = 1.0 / (1.0 + np.exp(-score.asnumpy()[:, 0]))
    mark("host sigmoid")
    # grad wrt w = X^T (p - y) / B, via the transpose sparse dot,
    # shipped as row_sparse over only the touched rows
    err = ((p - y) / len(y)).astype(np.float32)[:, None]
    gw = sparse.dot(x_csr, nd.array(err), transpose_a=True)
    mark("transpose dot")
    rsp = sparse.cast_storage(gw, "row_sparse")
    mark("cast_storage")
    grad = sparse.retain(rsp, nd.array(batch_rows.astype(np.int64),
                                       dtype=np.int64))
    mark("retain")
    kv.push("weight", grad)   # the store's lazy row-wise SGD
    mark("push + update")
    return p, y


def main(argv=None, batch_end_callback=None, workdir=None):
    """Write the data, train, assert.  ``batch_end_callback(step, p, kv)``
    runs after each push; ``workdir`` holds the LibSVM file (a temporary
    directory, removed after, otherwise).  Returns (running accuracy,
    each batch's probabilities, the final weight as numpy)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = cpu() if args.ctx == "cpu" else gpu()
    rng = np.random.RandomState(0)
    tmp = None if workdir else tempfile.mkdtemp(prefix="mxtpu_libsvm_")
    try:
        path = os.path.join(workdir or tmp, "train.libsvm")
        write_libsvm(path, args.batch_size * args.num_batches,
                     args.feat_dim, args.nnz, rng)
        # LibSVMIter yields CSR batches (reference: src/io/iter_libsvm.cc)
        it = io.LibSVMIter(data_libsvm=path, data_shape=(args.feat_dim,),
                           batch_size=args.batch_size)
        with use(device):
            kv = make_store(args.kv_store, args.feat_dim, args.lr)
            w_local = nd.zeros((args.feat_dim, 1))
            correct = total = 0
            probs = []
            for step, batch in enumerate(it):
                p, y = train_step(kv, w_local, batch, device)
                probs.append(p)
                correct += int(((p > 0.5) == (y > 0.5)).sum())
                total += len(y)
                if batch_end_callback is not None:
                    batch_end_callback(step, p, kv)
                if step % 20 == 0:
                    logging.info("step %d  running acc %.3f", step,
                                 correct / max(total, 1))
            weight = nd.zeros((args.feat_dim, 1))
            kv.pull("weight", out=weight)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    logging.info("final running accuracy: %.3f", correct / total)
    assert correct / total > 0.7, "sparse linear model failed to learn"
    return correct / total, probs, weight.asnumpy()


if __name__ == "__main__":
    main()
