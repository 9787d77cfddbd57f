"""A stacked autoencoder with a KL sparseness penalty: the port of
``examples/autoencoder/train_ae.py``.

    python -m mxnet_tpu_torch.tools.train_ae [--epochs 15] [--ctx gpu|cpu]

Reference: MXNet's ``example/autoencoder/``.  The data: 1,024 points of
a random linear map of 4 latent factors into 64 dimensions plus noise
(``RandomState(0)``).  The model (:class:`AutoEncoder`): Dense(32, relu)
and Dense(8, sigmoid) encode, Dense(32, relu) and Dense(64) decode; its
sparse variant passes the code through ``nd.IdentityAttachKLSparseReg``
(target 0.05, penalty 0.05).  Each trains for ``--epochs`` epochs of
batches of 64 (``io.NDArrayIter``, shuffled once; its host batches moved
to the device) under ``L2Loss``, ``gluon.Trainer("adam")`` at 3e-3 and
Xavier initialization.  The script
asserts, as the example does, that the plain model's last loss falls
below a quarter of the predict-the-mean baseline and that the sparse
code's mean activation falls below 0.6 of the plain one's.  Runs on the
card unless ``--ctx cpu``; :func:`main` returns the four numbers it
prints.  ``AutoEncoder(hidden=, code=, dim=)`` builds other widths (the
card check trains MNIST's 784-500-500-2000-10 stack with it).
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import autograd, gluon, init, io, nd
from ..context import cpu, current_device, gpu, use

__all__ = ["DIM", "LATENT", "make_data", "AutoEncoder", "train",
           "parse_args", "main"]

DIM, LATENT = 64, 4


def make_data(rng, n):
    """``n`` points near a ``LATENT``-dimensional subspace of ``DIM``."""
    basis = rng.randn(LATENT, DIM).astype(np.float32)
    z = rng.randn(n, LATENT).astype(np.float32)
    return z @ basis + rng.randn(n, DIM).astype(np.float32) * 0.05


class AutoEncoder(gluon.Block):
    """Dense relu layers of ``hidden`` widths and a ``code``-wide sigmoid
    code, mirrored back to ``dim`` outputs; with ``sparse_reg`` the code
    carries the KL sparseness penalty of that weight.  Called on
    NDArrays, as the example's is."""

    def __init__(self, sparse_reg=0.0, hidden=(32,), code=8, dim=DIM):
        super().__init__()
        self._enc = [gluon.nn.Dense(h, activation="relu") for h in hidden]
        self._enc.append(gluon.nn.Dense(code, activation="sigmoid"))
        self._dec = [gluon.nn.Dense(h, activation="relu")
                     for h in reversed(hidden)]
        self._dec.append(gluon.nn.Dense(dim))
        for i, layer in enumerate(self._enc + self._dec):
            self.register_child(layer, "layer%d" % i)
        self.sparse_reg = sparse_reg

    def encode(self, x):
        for layer in self._enc:
            x = layer(x)
        if self.sparse_reg:
            x = nd.IdentityAttachKLSparseReg(
                x, sparseness_target=0.05, penalty=self.sparse_reg)
        return x

    def forward(self, x):
        x = self.encode(x)
        for layer in self._dec:
            x = layer(x)
        return x


def train(net, X, epochs, lr=3e-3):
    """Adam on the L2 reconstruction loss, the batches moved to the
    current context; returns the last batch's mean loss."""
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": lr})
    l2 = gluon.loss.L2Loss()
    it = io.NDArrayIter(X, None, 64, shuffle=True)
    device = current_device()
    mse = None
    for _ in range(epochs):
        it.reset()
        for b in it:
            x = b.data[0].as_in_context(device)
            with autograd.record():
                loss = l2(net(x), x).mean()
            loss.backward()
            trainer.step(x.shape[0])
        mse = float(loss.asscalar())
    return mse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    return ap.parse_args(argv)


def main(argv=None):
    """Train both variants and assert as the example does.  Returns
    (baseline, trained loss, plain code mean, sparse code mean)."""
    args = parse_args(argv)
    rng = np.random.RandomState(0)
    X = make_data(rng, 1024)
    with use(cpu() if args.ctx == "cpu" else gpu()):
        net = AutoEncoder()
        net.initialize(init.Xavier())
        base = float(gluon.loss.L2Loss()(
            nd.array(np.full_like(X, X.mean())), nd.array(X))
            .mean().asscalar())
        final = train(net, X, args.epochs)
        print("baseline (predict mean) %.4f -> trained %.4f" % (base, final))
        assert final < base * 0.25, (base, final)

        # sparse variant: the KL penalty drives the mean activation toward
        # the target
        sp = AutoEncoder(sparse_reg=0.05)
        sp.initialize(init.Xavier())
        train(sp, X, args.epochs)
        code_plain = net.encode(nd.array(X[:256])).asnumpy().mean()
        code_sparse = sp.encode(nd.array(X[:256])).asnumpy().mean()
    print("mean code activation: plain %.3f sparse %.3f"
          % (code_plain, code_sparse))
    assert code_sparse < code_plain * 0.6, (code_plain, code_sparse)
    print("autoencoder OK")
    return base, final, float(code_plain), float(code_sparse)


if __name__ == "__main__":
    main()
