"""Speech-style CTC training through ``BucketingModule``: the port of
``examples/speech_recognition/train_ctc.py``.

    python -m mxnet_tpu_torch.tools.train_ctc [--batch-size 16]
        [--num-hidden 64] [--vocab 28] [--feat-dim 39] [--buckets 40,80]
        [--num-batches 60] [--lr 2e-3] [--ctx gpu|cpu]

A DeepSpeech-like net: two bidirectional LSTM layers (``FusedRNNCell``,
one ``RNN`` node) over ``(batch, T, feat_dim)`` features, a
``FullyConnected`` to ``vocab + 1`` symbols per frame and
``contrib.ctc_loss`` (blank 0) under ``MakeLoss``; one symbol per bucket
length, bound at the longest and switched per batch.  The batches are
the reference's synthetic ones (``RandomState(0)``: a bucket drawn per
batch, Gaussian features with a weak label signal, 8 labels a row), so
the script runs offline.  Adam, ``Xavier`` initialization (the flat RNN
vector takes its ``FusedRNN`` initializer).  Runs on the card unless
``--ctx cpu``; :func:`main` returns the losses (the batch mean of each
step).
"""
from __future__ import annotations

import argparse
import logging

import numpy as np

from .. import initializer, io, module, nd, rnn, symbol as sym
from ..context import cpu, gpu

__all__ = ["build_sym", "synthetic_batches", "parse_args", "buckets_of",
           "make_module", "main"]

MAX_LABEL = 8


def build_sym(seq_len, num_hidden, vocab):
    """The bucket's symbol: ``(loss, data names, label names)``."""
    data = sym.Variable("data")            # (N, T, F)
    label = sym.Variable("label")          # (N, L)
    cell = rnn.FusedRNNCell(num_hidden, num_layers=2, mode="lstm",
                            bidirectional=True, prefix="lstm_")
    outputs, _ = cell.unroll(seq_len, data, layout="NTC")  # (N, T, 2H)
    pred = sym.Reshape(outputs, shape=(-1, num_hidden * 2))
    pred = sym.FullyConnected(pred, num_hidden=vocab + 1, name="pred")
    pred = sym.Reshape(pred, shape=(-4, -1, seq_len, 0))
    pred = sym.swapaxes(pred, dim1=0, dim2=1)  # (T, N, vocab + 1)
    loss = sym.contrib.ctc_loss(pred, label)
    return sym.MakeLoss(loss), ("data",), ("label",)


def synthetic_batches(num, batch_size, buckets, feat_dim, vocab, max_label):
    """The reference's batches: per batch a bucket length T, features
    (batch, T, feat_dim) and labels (batch, max_label) in [1, vocab), each
    label's feature raised over 4 frames."""
    rng = np.random.RandomState(0)
    for _ in range(num):
        T = buckets[rng.randint(len(buckets))]
        x = rng.randn(batch_size, T, feat_dim).astype(np.float32)
        lab = rng.randint(1, vocab, (batch_size, max_label)) \
            .astype(np.float32)
        for b in range(batch_size):
            for j in range(min(max_label, T // 4)):
                t = int(lab[b, j]) % feat_dim
                x[b, j * 4:(j + 1) * 4, t] += 2.0
        yield io.DataBatch(
            [nd.array(x, ctx="cpu")], [nd.array(lab, ctx="cpu")],
            bucket_key=T,
            provide_data=[io.DataDesc("data", (batch_size, T, feat_dim))],
            provide_label=[io.DataDesc("label", (batch_size, max_label))])


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--num-hidden", type=int, default=64)
    parser.add_argument("--vocab", type=int, default=28)
    parser.add_argument("--feat-dim", type=int, default=39)
    parser.add_argument("--buckets", default="40,80")
    parser.add_argument("--num-batches", type=int, default=60)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    return parser.parse_args(argv)


def buckets_of(args):
    return [int(b) for b in args.buckets.split(",")]


def make_module(args):
    """The bound, initialized ``BucketingModule`` with its optimizer."""
    buckets = buckets_of(args)

    def sym_gen(seq_len):
        return build_sym(seq_len, args.num_hidden, args.vocab)

    mod = module.BucketingModule(
        sym_gen, default_bucket_key=max(buckets),
        context=gpu() if args.ctx == "gpu" else cpu())
    mod.bind([("data", (args.batch_size, max(buckets), args.feat_dim))],
             [("label", (args.batch_size, MAX_LABEL))])
    mod.init_params(initializer.Xavier())
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": args.lr})
    return mod


def main(argv=None, batch_end_callback=None):
    """Train; ``batch_end_callback(i, batch, mod)`` runs after each
    update.  Returns the losses."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    mod = make_module(args)
    losses = []
    for i, batch in enumerate(synthetic_batches(
            args.num_batches, args.batch_size, buckets_of(args),
            args.feat_dim, args.vocab, MAX_LABEL)):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        # the device scalar is read on the host only where it is logged
        # and after the loop
        loss = mod.get_outputs()[0].mean()
        losses.append(loss)
        if i % 10 == 0:
            logging.info("batch %d  ctc loss %.3f", i, float(loss.asscalar()))
        if batch_end_callback is not None:
            batch_end_callback(i, batch, mod)
    losses = [float(v.asscalar()) for v in losses]
    logging.info("loss %.3f -> %.3f", losses[0], losses[-1])
    return losses


if __name__ == "__main__":
    main()
