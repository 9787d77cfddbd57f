"""Model-parallel multi-layer LSTM: the port of
``examples/model_parallel_lstm/lstm.py``.

    python -m mxnet_tpu_torch.tools.model_parallel_lstm [--device cpu]

Each LSTM layer's parameters carry their own ``ctx_group``
(``AttrScope``); ``group2ctx`` maps the layers to
``PartitionSpec("model")`` and the decoder to a replicated spec over a
port ``Mesh`` of ``--ranks`` in-process ranks.  The executor records
each argument's sharding (``Executor._sharding``) and keeps the arrays
whole on the mesh's one device (``executor.py``).  Ten steps of plain
SGD on the executor's gradients, the example's; the negative log
likelihood is printed every third step.  Runs on the card unless
``--device cpu``; :func:`main` returns the printed losses and the
executor.
"""
from __future__ import annotations

import argparse

import numpy as np

__all__ = ["lstm_unroll", "main"]


def lstm_unroll(num_layers=2, seq_len=8, input_size=16, num_hidden=32,
                num_embed=16, num_label=10):
    """Per-layer ``ctx_group`` tagging, like the reference's
    ``lstm_unroll``."""
    from .. import symbol as sym
    from ..attribute import AttrScope
    data = sym.Variable("data")            # (seq_len, batch, input_size)
    hidden = data
    for i in range(num_layers):
        with AttrScope(ctx_group="layer%d" % i):
            params = sym.Variable("l%d_params" % i)
            init_h = sym.Variable("l%d_init_h" % i)
            init_c = sym.Variable("l%d_init_c" % i)
            hidden = sym.RNN(hidden, params, init_h, init_c,
                             state_size=num_hidden, num_layers=1,
                             mode="lstm", name="lstm%d" % i)
    with AttrScope(ctx_group="decode"):
        flat = sym.Reshape(hidden, shape=(-1, num_hidden))
        fc = sym.FullyConnected(flat, num_hidden=num_label, name="decoder")
    return sym.SoftmaxOutput(fc, name="softmax")


def _rnn_param_size(input_size, hidden):
    # lstm: 4 gates x (input + hidden + 2 biases)
    return 4 * (hidden * input_size + hidden * hidden + 2 * hidden)


def main(argv=None):
    import torch

    from ..base import resolve_device
    from ..parallel.mesh import PartitionSpec, make_mesh

    parser = argparse.ArgumentParser()
    parser.add_argument("--ranks", type=int, default=8,
                        help="in-process ranks of the model axis")
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    num_layers, seq_len, batch = 2, 8, 4
    input_size = hidden = 16
    num_label = 10

    device = resolve_device(args.device)
    mesh = make_mesh((args.ranks,), ("model",), [device] * args.ranks)
    # each layer's weights shard over the model axis; decoder replicated
    group2ctx = {"layer0": PartitionSpec("model"),
                 "layer1": PartitionSpec("model"),
                 "decode": PartitionSpec()}
    net = lstm_unroll(num_layers, seq_len, input_size, hidden,
                      num_label=num_label)

    rng = np.random.RandomState(0)
    args_ = {"data": rng.randn(seq_len, batch, input_size).astype(
        np.float32),
        "softmax_label": np.tile(np.arange(batch) % num_label,
                                 seq_len).astype(np.float32)}
    for i in range(num_layers):
        in_sz = input_size if i == 0 else hidden
        args_["l%d_params" % i] = (rng.randn(
            _rnn_param_size(in_sz, hidden)).astype(np.float32) * 0.1)
        args_["l%d_init_h" % i] = np.zeros((1, batch, hidden), np.float32)
        args_["l%d_init_c" % i] = np.zeros((1, batch, hidden), np.float32)
    args_["decoder_weight"] = rng.randn(num_label, hidden).astype(
        np.float32) * 0.1
    args_["decoder_bias"] = np.zeros(num_label, np.float32)

    grad_req = {k: ("write" if "params" in k or "decoder" in k else "null")
                for k in args_}
    exe = net.bind(mesh, args=args_, grad_req=grad_req, group2ctx=group2ctx)

    lr = 0.1
    losses = []
    for step in range(10):
        out = exe.forward(is_train=True)[0]
        exe.backward()
        for name, grad in exe.grad_dict.items():
            arr = exe.arg_dict[name]
            arr._set_data(arr._data - lr * grad._data)
        if step % 3 == 0:
            pred = out._data
            label = exe.arg_dict["softmax_label"]._data.long()
            nll = -torch.log(pred[torch.arange(pred.shape[0]), label]
                             + 1e-8)
            losses.append(float(nll.mean()))
            print("step %d  nll %.4f" % (step, losses[-1]))
    print("layer0 params sharding:", exe._sharding("l0_params"))
    print("decoder sharding:", exe._sharding("decoder_weight"))
    return losses, exe


if __name__ == "__main__":
    main()
