"""Wide & Deep on sparse categorical features: the port of
``examples/wide_deep/train.py``.

    python -m mxnet_tpu_torch.tools.train_wide_deep [--num-fields 4]
        [--vocab 50] [--batch-size 64] [--num-batches 120] [--lr 0.5]
        [--ctx gpu|cpu]

Reference: MXNet's ``example/sparse/wide_deep``.  Each sample holds
``num_fields`` categorical ids one-hot in a ``num_fields * vocab`` space,
labelled by a planted per-id weight vector; :func:`write_libsvm` (the
example's writer, byte for byte) writes them and ``io.LibSVMIter`` reads
them back as CSR batches, built on the host and moved to the device.
The model (:class:`WideDeep`): a wide ``Dense(1)`` over the densified
one-hot batch plus a deep path, the per-field ids read back from the CSR
columns through an ``Embedding`` (8) and an MLP (32, relu; 1).  Gluon and
autograd, Adam at 0.01 (the example's ``--lr`` is parsed and unused, as
there), ``SigmoidBinaryCrossEntropyLoss``.  The running accuracy stays
on the device until the log lines and the end; the script asserts that
it passes 0.75, as the example does.  Runs on the card unless ``--ctx
cpu``; :func:`main` returns the accuracy and each batch's mean loss.
"""
from __future__ import annotations

import argparse
import logging
import os
import shutil
import tempfile

import numpy as np

from .. import autograd, gluon, init, io
from ..context import cpu, gpu, use

__all__ = ["write_libsvm", "WideDeep", "parse_args", "main"]


def write_libsvm(path, n, num_fields, vocab, rng):
    """Each sample: num_fields categorical ids one-hot in a vocab*fields
    space; label from a planted per-id weight vector."""
    w_true = rng.randn(num_fields * vocab).astype(np.float32)
    ids = rng.randint(0, vocab, size=(n, num_fields))
    with open(path, "w") as f:
        for row in ids:
            feats = [f_i * vocab + v for f_i, v in enumerate(row)]
            label = 1.0 if w_true[feats].sum() > 0 else 0.0
            f.write("%g %s\n" % (label,
                                 " ".join("%d:1" % i for i in feats)))
    return num_fields * vocab


class WideDeep(gluon.HybridBlock):
    def __init__(self, feat_dim, num_fields, embed_dim=8, hidden=32,
                 **kwargs):
        super().__init__(**kwargs)
        self._num_fields = num_fields
        with self.name_scope():
            # wide: one weight per one-hot feature (the linear part)
            self.wide = gluon.nn.Dense(1, in_units=feat_dim, use_bias=True)
            # deep: per-field embedding -> MLP
            self.embed = gluon.nn.Embedding(feat_dim, embed_dim)
            self.fc1 = gluon.nn.Dense(hidden, activation="relu")
            self.fc2 = gluon.nn.Dense(1)

    def hybrid_forward(self, F, dense_x, feat_ids):
        wide = self.wide(dense_x)
        emb = self.embed(feat_ids)                       # (B, F, E)
        deep = self.fc2(self.fc1(F.Flatten(emb)))
        return wide + deep


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--num-fields", type=int, default=4)
    parser.add_argument("--vocab", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--num-batches", type=int, default=120)
    parser.add_argument("--lr", type=float, default=0.5)
    parser.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    return parser.parse_args(argv)


def main(argv=None, batch_end_callback=None):
    """Write the data, train, assert.  ``batch_end_callback(step, net,
    loss)`` runs after each update.  Returns (running accuracy, each
    batch's mean loss)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = cpu() if args.ctx == "cpu" else gpu()
    rng = np.random.RandomState(0)
    tmp = tempfile.mkdtemp(prefix="mxtpu_widedeep_")
    try:
        path = os.path.join(tmp, "train.libsvm")
        feat_dim = write_libsvm(path, args.batch_size * args.num_batches,
                                args.num_fields, args.vocab, rng)
        it = io.LibSVMIter(data_libsvm=path, data_shape=(feat_dim,),
                           batch_size=args.batch_size)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with use(device):
        net = WideDeep(feat_dim, args.num_fields)
        net.initialize(init.Xavier())
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.01})
        loss_fn = gluon.loss.SigmoidBinaryCrossEntropyLoss()
        correct, total, losses = None, 0, []
        for step, batch in enumerate(it):
            x_csr = batch.data[0].as_in_context(device)
            y = batch.label[0].as_in_context(device)
            dense_x = x_csr.todense()                 # wide one-hot input
            # deep path reads the per-field ids back from the CSR columns,
            # reshaped and cast on the device
            feat_ids = x_csr.indices.astype(np.float32) \
                .reshape((-1, args.num_fields))
            with autograd.record():
                logit = net(dense_x, feat_ids)
                loss = loss_fn(logit, y.reshape((-1, 1)))
            loss.backward()
            trainer.step(args.batch_size)
            losses.append(loss.mean())
            if batch_end_callback is not None:
                batch_end_callback(step, net, loss)
            # device-resident hit counter: fetched only at the periodic
            # log and the final accuracy
            hits = ((logit.reshape((-1,)) > 0).astype(np.float32)
                    == y).astype(np.float32).sum()
            correct = hits if correct is None else correct + hits
            total += y.shape[0]
            if step % 20 == 0:
                logging.info("step %d  running acc %.3f", step,
                             float(correct.asscalar()) / max(total, 1))
        acc = float(correct.asscalar()) / total
    logging.info("final running accuracy: %.3f", acc)
    assert acc > 0.75, "wide&deep failed to learn"
    return acc, [float(v.asscalar()) for v in losses]


if __name__ == "__main__":
    main()
