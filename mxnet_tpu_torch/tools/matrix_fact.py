"""Matrix factorization for recommendation: the port of
``examples/recommenders/matrix_fact.py``.

    python -m mxnet_tpu_torch.tools.matrix_fact [--num-users 200]
        [--num-items 150] [--rank 8] [--batch-size 256] [--epochs 12]
        [--ctx gpu|cpu]

Reference: MXNet's ``example/recommenders`` (demo1-MF) and
``example/sparse/matrix_factorization``.  User and item embeddings of
``rank`` and a bias per user and per item (:class:`MFBlock`, hybridized);
a rating is their dot product plus the biases.  The data are 8,192
synthetic low-rank ratings with noise (:func:`synthetic_ratings`, the
example's draws).  Gluon and autograd, Adam at 0.02, ``L2Loss``; the
epoch's loss stays on the device until the epoch ends.  The script
asserts that the last epoch's mean squared error is under 0.3 of the
first's, as the example does.  Runs on the card unless ``--ctx cpu``;
:func:`main` returns each epoch's mean squared error.
"""
from __future__ import annotations

import argparse
import logging

import numpy as np

from .. import autograd, gluon, init, nd
from ..context import cpu, gpu, use

__all__ = ["MFBlock", "synthetic_ratings", "parse_args", "main"]


class MFBlock(gluon.HybridBlock):
    def __init__(self, num_users, num_items, rank, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.user_embed = gluon.nn.Embedding(num_users, rank)
            self.item_embed = gluon.nn.Embedding(num_items, rank)
            self.user_bias = gluon.nn.Embedding(num_users, 1)
            self.item_bias = gluon.nn.Embedding(num_items, 1)

    def hybrid_forward(self, F, users, items):
        p = self.user_embed(users)
        q = self.item_embed(items)
        pred = F.sum(p * q, axis=-1)
        return pred + self.user_bias(users).reshape((-1,)) \
            + self.item_bias(items).reshape((-1,))


def synthetic_ratings(num_users, num_items, rank, n, rng):
    u_true = rng.randn(num_users, rank).astype(np.float32) / np.sqrt(rank)
    i_true = rng.randn(num_items, rank).astype(np.float32) / np.sqrt(rank)
    users = rng.randint(0, num_users, n)
    items = rng.randint(0, num_items, n)
    ratings = (u_true[users] * i_true[items]).sum(-1) \
        + 0.05 * rng.randn(n).astype(np.float32)
    return users, items, ratings.astype(np.float32)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--num-users", type=int, default=200)
    parser.add_argument("--num-items", type=int, default=150)
    parser.add_argument("--rank", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--epochs", type=int, default=12)
    parser.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    return parser.parse_args(argv)


def main(argv=None, batch_end_callback=None):
    """Train and assert.  ``batch_end_callback(step, net, loss)`` runs
    after each update.  Returns each epoch's mean squared error."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = cpu() if args.ctx == "cpu" else gpu()
    rng = np.random.RandomState(0)
    users, items, ratings = synthetic_ratings(
        args.num_users, args.num_items, args.rank, 8192, rng)
    with use(device):
        net = MFBlock(args.num_users, args.num_items, args.rank)
        net.initialize(init.Normal(0.05))
        net.hybridize()
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.02})
        loss_fn = gluon.loss.L2Loss()
        n = len(ratings)
        mses = []
        step = 0
        for epoch in range(args.epochs):
            perm = rng.permutation(n)
            total = None  # device-resident running sum: no per-step sync
            for s in range(0, n - args.batch_size + 1, args.batch_size):
                sel = perm[s:s + args.batch_size]
                u = nd.array(users[sel].astype(np.float32))
                i = nd.array(items[sel].astype(np.float32))
                r = nd.array(ratings[sel])
                with autograd.record():
                    pred = net(u, i)
                    loss = loss_fn(pred, r)
                loss.backward()
                trainer.step(args.batch_size)
                if batch_end_callback is not None:
                    batch_end_callback(step, net, loss)
                step += 1
                m = loss.mean()
                total = m if total is None else total + m
            # the epoch's end: one fetch; L2Loss is half the squared error
            mses.append(2 * float(total.asscalar()) / (n // args.batch_size))
            logging.info("epoch %d  mse %.4f", epoch, mses[-1])
    assert mses[-1] < mses[0] * 0.3, (mses[0], mses[-1])
    logging.info("done: mse %.4f -> %.4f", mses[0], mses[-1])
    return mses


if __name__ == "__main__":
    main()
