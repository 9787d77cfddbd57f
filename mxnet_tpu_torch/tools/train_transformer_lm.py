"""Train a transformer LM on a ``data × model × sequence`` mesh: the port
of ``examples/long_context/train_transformer_lm.py``.

    python -m mxnet_tpu_torch.tools.train_transformer_lm \\
        --data 2 --model 2 --sequence 2 [--device cpu]

``DataParallelTrainer(mesh_plan=...)`` over
``transformer.TransformerLM``: tensor-parallel (Megatron) layers over
``model``, ring (or Ulysses) attention over ``sequence``, optional
ZeRO-1 over ``data`` — every rank on one device (``parallel/mesh.py``).
The corpus is the example's seeded Markov-bigram token stream, so the
loss drop is deterministic and the same at every mesh shape.  The loop
carries the example's ``train.step`` chaos probe (``--chaos`` or
``MXTPU_CHAOS``).  Runs on the card unless ``--device cpu``.
:func:`train` returns the example's stats (plan, first / head / final
loss, the losses, tokens/s, steps; and tokens/s after the first step,
``tokens_per_sec_steady``); ``--report`` reads the trainer's
``mesh_report``, which is ROADMAP.md queue A, item 13, and raises.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

__all__ = ["make_corpus", "batches", "train", "parse_args", "main"]


def make_corpus(vocab, length, seed=7):
    """Seeded Markov-bigram stream: each token strongly prefers one
    successor, so even a small LM has structure to learn and the loss
    curve is deterministic (the example's, draw for draw)."""
    rng = np.random.RandomState(seed)
    succ = rng.permutation(vocab)
    out = np.empty(length, np.int32)
    tok = 0
    for i in range(length):
        out[i] = tok
        tok = int(succ[tok]) if rng.rand() < 0.8 \
            else int(rng.randint(vocab))
    return out


def batches(corpus, batch, seq_len, steps, seed=11):
    """Deterministic (tokens, shifted-labels) windows; labels are the
    GLOBALLY shifted next tokens, so sequence-parallel chunks need no
    cross-rank label exchange."""
    rng = np.random.RandomState(seed)
    hi = len(corpus) - seq_len - 1
    for _ in range(steps):
        starts = rng.randint(0, hi, size=batch)
        x = np.stack([corpus[s:s + seq_len] for s in starts])
        y = np.stack([corpus[s + 1:s + seq_len + 1] for s in starts])
        yield x, y


def train(args, logger=print):
    """Train as the example does; ``args`` holds its flags (and
    ``device``).  Returns the stats dict."""
    import torch

    from .. import random as mx_random
    from ..base import resolve_device
    from ..parallel import DataParallelTrainer, MeshPlan
    from ..resilience import chaos
    from ..transformer import TransformerLM, TransformerLMConfig

    if getattr(args, "report", False):
        raise NotImplementedError(
            "--report reads the trainer's mesh_report, the static cost "
            "and shard analysis: ROADMAP.md queue A, item 13")
    if args.chaos:
        os.environ["MXTPU_CHAOS"] = args.chaos
        chaos.install_from_env()
    mx_random.seed(args.seed)
    device = resolve_device(getattr(args, "device", None))
    cfg = TransformerLMConfig(
        vocab_size=args.vocab, d_model=args.d_model,
        n_heads=args.heads, n_layers=args.layers, d_ff=args.d_ff,
        seq_len=args.seq_len, attention=args.attention)
    plan = MeshPlan(data=args.data, model=args.model,
                    sequence=args.sequence)
    trainer = DataParallelTrainer(
        TransformerLM(cfg), None, "sgd",
        {"learning_rate": args.lr, "momentum": 0.9},
        mesh_plan=plan, zero=args.zero, device=device)

    corpus = make_corpus(args.vocab, 4096, seed=args.seed + 7)
    losses = []
    t0 = t1 = time.perf_counter()
    for step, (x, y) in enumerate(
            batches(corpus, args.batch, args.seq_len, args.steps,
                    seed=args.seed + 11), 1):
        # the elastic tier's per-step probe: seeded schedules can kill or
        # delay this tier's steps too
        chaos.maybe_inject("train.step", step, ctx=step)
        loss = trainer.step(torch.from_numpy(x).to(device),
                            torch.from_numpy(y).to(device))
        losses.append(loss)
        if step == 1:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t1 = time.perf_counter()
        if step % args.log_every == 0:
            logger("step %4d  loss %.4f" % (step, float(loss)))
    trainer.flush()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    vals = [float(v) for v in losses]
    head = float(np.mean(vals[:3])) if len(vals) >= 3 else vals[0]
    tail = float(np.mean(vals[-3:]))
    tokens = args.batch * args.seq_len * args.steps
    stats = {
        "plan": trainer.mesh_plan.describe(),
        "first_loss": vals[0], "head_loss": head, "final_loss": tail,
        "losses": vals, "tokens_per_sec": tokens / max(wall, 1e-9),
        "steps": args.steps,
        # after the first step (its allocations and first launches)
        "tokens_per_sec_steady": (tokens - args.batch * args.seq_len)
        / max(t0 + wall - t1, 1e-9),
    }
    logger("trained %d steps (%s attention) on %s: loss %.4f -> %.4f, "
           "%.0f tokens/s"
           % (args.steps, cfg.attention, trainer.mesh_plan.describe(),
              head, tail, stats["tokens_per_sec"]))
    return stats


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="train a transformer LM over data x model x sequence")
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--vocab", type=int, default=64)
    parser.add_argument("--d-model", type=int, default=64)
    parser.add_argument("--heads", type=int, default=4)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--d-ff", type=int, default=128)
    parser.add_argument("--lr", type=float, default=0.5)
    parser.add_argument("--data", type=int, default=None,
                        help="data-axis size (default 1: every rank runs "
                             "on the one device)")
    parser.add_argument("--model", type=int, default=1)
    parser.add_argument("--sequence", type=int, default=1)
    parser.add_argument("--zero", type=int, default=0, choices=(0, 1))
    parser.add_argument("--attention", default="ring",
                        choices=("ring", "ulysses", "auto"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--chaos", default="",
                        help="chaos spec, e.g. 'train.step:12:raise'")
    parser.add_argument("--report", action="store_true",
                        help="the modeled collective schedule (ROADMAP.md "
                             "queue A, item 13: raises)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    stats = train(parse_args(argv))
    if stats["final_loss"] >= stats["head_loss"]:
        print("WARNING: loss did not decrease (%.4f -> %.4f)"
              % (stats["head_loss"], stats["final_loss"]))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
