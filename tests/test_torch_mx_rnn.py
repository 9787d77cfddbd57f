"""``mx.rnn`` of mxnet_tpu_torch and ``tools/train_ctc.py`` held against
mxnet_tpu on the CPU.

- ``FusedRNNCell.unroll``: the reference's argument names, inferred
  shapes and JSON; bound with the same flat vector, outputs within 1e-5.
  ``unpack_weights`` gives the reference's per-gate arrays bitwise,
  ``pack_weights`` restores the flat vector bitwise, and ``unfuse``'s
  stack of cells computes the fused cell's outputs within 1e-5 in both
  packages (a bidirectional one in the port only: the reference's stack
  raises there, ROADMAP.md C8).
- The symbolic cells (RNN, LSTM, GRU, ``BidirectionalCell``,
  ``ResidualCell``, ``SequentialRNNCell``) unrolled and bound with the
  same weights: outputs within 1e-5.
- ``BucketSentenceIter``: the reference's batches and bucket keys
  bitwise after the same ``random`` / ``numpy`` seeds.
- ``save_rnn_checkpoint`` / ``do_rnn_checkpoint`` write the reference's
  bytes; ``load_rnn_checkpoint`` packs them back bitwise.
- ``tools/train_ctc.py`` at a tiny width, 3 batches over two buckets
  (``examples/speech_recognition/train_ctc.py``'s own ``build_sym`` and
  batches on the reference's side): the same initial parameters bitwise,
  losses within 2e-5 and parameters within 5e-6 after the steps; its
  ``main`` returns those losses.
"""
import importlib.util
import os
import random

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.context import use
from mxnet_tpu_torch.tools import train_ctc

TOL = 1e-5
BOTH = (("ref", mx), ("port", tmx))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, T, C, H = 3, 4, 5, 6


@pytest.fixture(autouse=True)
def _on_cpu():
    with use("cpu"):
        yield


def _close(want, got, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=msg)


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _forward(m, net, data, weights):
    """Bind ``net`` at ``data``'s shape on the CPU, copy ``weights`` in,
    run an inference forward: the outputs as numpy."""
    ex = net.simple_bind(m.cpu(), data=data.shape)
    ex.copy_params_from({k: m.nd.array(v) for k, v in weights.items()})
    return [o.asnumpy() for o in ex.forward(is_train=False, data=data)]


def _weights(net, shape, seed):
    """Seeded arrays for every argument of ``net`` but ``data``."""
    args, _, _ = net.infer_shape(data=shape)
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(net.list_arguments(), args) if n != "data"}


FUSED = [("lstm", 2, True), ("gru", 1, False), ("rnn_tanh", 2, False)]


@pytest.mark.parametrize("mode,layers,bi", FUSED,
                         ids=["%s-L%d-%s" % (m, L, "bi" if b else "uni")
                              for m, L, b in FUSED])
def test_fused_cell_matches_reference(mode, layers, bi):
    x = _x(N, T, C)
    res = {}
    for tag, m in BOTH:
        with m.name.NameManager():
            cell = m.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                      bidirectional=bi, prefix="f_",
                                      get_next_state=True)
            out, states = cell.unroll(T, m.sym.Variable("data"),
                                      layout="NTC")
            net = m.sym.Group([out] + list(states))
        shapes = net.infer_shape(data=x.shape)
        weights = _weights(net, x.shape, seed=1)
        res[tag] = (net.list_arguments(), shapes, net.attr_dict(),
                    _forward(m, net, x, weights), cell, weights)
    ref, port = res["ref"], res["port"]
    assert port[0] == ref[0] and port[1] == ref[1]
    assert port[2]["f_parameters"]["__init__"] == \
        ref[2]["f_parameters"]["__init__"]
    for w, g in zip(ref[3], port[3]):
        _close(w, g)

    # unpack / pack / unfuse
    flat = port[5]["f_parameters"]
    unpacked = {}
    for tag, m in BOTH:
        cell = res[tag][4]
        args = cell.unpack_weights({"f_parameters": m.nd.array(flat)})
        unpacked[tag] = {k: v.asnumpy() for k, v in args.items()}
        packed = cell.pack_weights(args)["f_parameters"].asnumpy()
        np.testing.assert_array_equal(packed, flat)
    assert sorted(unpacked["port"]) == sorted(unpacked["ref"])
    for k, v in unpacked["ref"].items():
        np.testing.assert_array_equal(unpacked["port"][k], v)
    for tag, m in BOTH:
        stack = res[tag][4].unfuse()
        with m.name.NameManager():
            if bi and m is mx:
                # the reference steps its stack, and a BidirectionalCell
                # cannot be stepped (ROADMAP.md C8)
                with pytest.raises(NotImplementedError, match="stepped"):
                    stack.unroll(T, m.sym.Variable("data"), layout="NTC")
                continue
            sout, _ = stack.unroll(T, m.sym.Variable("data"), layout="NTC",
                                   merge_outputs=True)
        got = _forward(m, sout, x, unpacked[tag])
        _close(res[tag][3][0], got[0], msg="unfused " + tag)


def _cells(m):
    return {
        "rnn": lambda: m.rnn.RNNCell(H, activation="relu", prefix="r_"),
        "lstm": lambda: m.rnn.LSTMCell(H, prefix="l_"),
        "gru": lambda: m.rnn.GRUCell(H, prefix="g_"),
        "bi": lambda: m.rnn.BidirectionalCell(
            m.rnn.LSTMCell(H, prefix="bl_"), m.rnn.GRUCell(H, prefix="br_")),
        "stack": lambda: _stack(m),
    }


def _stack(m):
    s = m.rnn.SequentialRNNCell()
    s.add(m.rnn.LSTMCell(H, prefix="s0_"))
    s.add(m.rnn.ResidualCell(m.rnn.GRUCell(H, prefix="s1_")))
    return s


@pytest.mark.parametrize("name", ["rnn", "lstm", "gru", "bi", "stack"])
def test_symbolic_cells_match_reference(name):
    width = H if name == "stack" else C
    x = _x(N, T, width, seed=2)
    res = {}
    for tag, m in BOTH:
        with m.name.NameManager():
            cell = _cells(m)[name]()
            out, states = cell.unroll(T, m.sym.Variable("data"),
                                      layout="NTC", merge_outputs=True)
            net = m.sym.Group([out] + list(states))
        weights = _weights(net, x.shape, seed=3)
        res[tag] = (net.list_arguments(), _forward(m, net, x, weights))
    assert res["port"][0] == res["ref"][0]
    for w, g in zip(res["ref"][1], res["port"][1]):
        _close(w, g)


def test_bucket_sentence_iter_batches_are_the_references():
    rng = np.random.RandomState(4)
    sents = [list(rng.randint(1, 20, rng.randint(2, 12)))
             for _ in range(90)]
    got = {}
    for tag, m in BOTH:
        random.seed(7)
        np.random.seed(7)
        it = m.rnn.BucketSentenceIter(sents, batch_size=6,
                                      buckets=[4, 8, 12], invalid_label=0)
        epochs = []
        for _ in range(2):
            it.reset()
            epochs.append([(b.bucket_key, b.data[0].asnumpy(),
                            b.label[0].asnumpy(), b.provide_data[0].shape)
                           for b in it])
        got[tag] = (epochs, it.default_bucket_key,
                    [tuple(d.shape) for d in it.provide_data])
    assert got["port"][1:] == got["ref"][1:]
    for we, ge in zip(got["ref"][0], got["port"][0]):
        assert len(we) == len(ge) > 0
        for w, g in zip(we, ge):
            assert w[0] == g[0] and w[3] == g[3]
            np.testing.assert_array_equal(g[1], w[1])
            np.testing.assert_array_equal(g[2], w[2])
    empty = tmx.rnn.BucketSentenceIter([[1, 2, 3, 4, 5]] * 20, batch_size=4,
                                       buckets=[2, 8])
    assert all(b.bucket_key == 8 for b in empty)


def test_rnn_checkpoints_are_the_references(tmp_path):
    flat = None
    files = {}
    for tag, m in BOTH:
        with m.name.NameManager():
            cell = m.rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                      bidirectional=True, prefix="c_")
            out, _ = cell.unroll(T, m.sym.Variable("data"), layout="NTC")
            net = m.sym.FullyConnected(m.sym.Reshape(out, shape=(-1, 2 * H)),
                                       num_hidden=3, name="fc")
        if flat is None:
            flat = _weights(net, (N, T, C), seed=5)
        arg = {k: m.nd.array(v) for k, v in flat.items()}
        prefix = str(tmp_path / tag)
        m.rnn.save_rnn_checkpoint(cell, prefix, 1, net, arg, {})
        m.rnn.do_rnn_checkpoint([cell], prefix, period=2)(1, net, arg, {})
        files[tag] = [open(prefix + suffix, "rb").read() for suffix in
                      ("-symbol.json", "-0001.params", "-0002.params")]
        _, loaded, _ = m.rnn.load_rnn_checkpoint(cell, prefix, 2)
        assert sorted(loaded) == sorted(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(loaded[k].asnumpy(), v)
    assert files["port"] == files["ref"]


TINY = dict(batch=4, hidden=8, vocab=6, feat=13, buckets="16,24",
            batches=3, lr=2e-3)


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "ref_train_ctc",
        os.path.join(REPO, "examples", "speech_recognition", "train_ctc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _train(m, build_sym, batches):
    """The example's loop: BucketingModule bound at the longest bucket,
    ``Xavier`` after ``mx.random.seed(0)``, Adam."""
    buckets = [int(b) for b in TINY["buckets"].split(",")]

    def sym_gen(seq_len):
        return build_sym(seq_len, TINY["hidden"], TINY["vocab"])
    mod = m.mod.BucketingModule(sym_gen, default_bucket_key=max(buckets),
                                context=m.cpu())
    mod.bind([("data", (TINY["batch"], max(buckets), TINY["feat"]))],
             [("label", (TINY["batch"], 8))])
    m.random.seed(0)
    mod.init_params(m.init.Xavier())
    init = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": TINY["lr"]})
    losses, keys = [], []
    for b in batches(buckets):
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
        losses.append(float(mod.get_outputs()[0].mean().asscalar()))
        keys.append(b.bucket_key)
    return losses, keys, init, {k: v.asnumpy() for k, v in
                                mod.get_params()[0].items()}


def test_train_ctc_matches_the_reference_example():
    ref = _reference_example()
    args = (TINY["batches"], TINY["batch"])
    rest = (TINY["feat"], TINY["vocab"], 8)
    want = _train(mx, ref.build_sym,
                  lambda bk: ref.synthetic_batches(*args, bk, *rest))
    got = _train(tmx, train_ctc.build_sym,
                 lambda bk: train_ctc.synthetic_batches(*args, bk, *rest))
    assert got[1] == want[1] and len(set(got[1])) == 2
    assert sorted(got[2]) == sorted(want[2]) == [
        "lstm_parameters", "pred_bias", "pred_weight"]
    for k in want[2]:
        np.testing.assert_array_equal(got[2][k], want[2][k])
    _close(want[0], got[0], tol=2e-5, msg="losses")
    for k in want[3]:
        _close(want[3][k], got[3][k], tol=5e-6, msg=k)
    argv = ["--ctx", "cpu", "--batch-size", str(TINY["batch"]),
            "--num-hidden", str(TINY["hidden"]), "--vocab",
            str(TINY["vocab"]), "--feat-dim", str(TINY["feat"]),
            "--buckets", TINY["buckets"], "--num-batches",
            str(TINY["batches"]), "--lr", str(TINY["lr"])]
    tmx.random.seed(0)
    assert train_ctc.main(argv) == got[0]
