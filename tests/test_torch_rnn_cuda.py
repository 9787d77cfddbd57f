"""The RNN op, the CTC loss, the Gluon LSTM and ``tools/train_ctc.py`` of
mxnet_tpu_torch on the card (marked ``cuda``; skipped without one).  This
file imports no JAX, so it runs on the GPU host:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_rnn_cuda.py

With TF32 off, each is held to the same call on the CPU of the card's
host (the RNN through cuDNN on the card, torch's native recurrence on
the CPU), each difference over the larger of 1 and the array's largest
magnitude (the op sweep's rule): the RNN op within 1e-10 in float64 and
1e-4 in float32 (cuDNN's f32 recurrence sits ~1e-5 off a float64 run,
the CPU's under 1e-6: ``chip_smoke.py`` phase 28 (a) prints both), the
Gluon LSTM's steps within 1e-4 for the same reason, CTC within 1e-5.
Nothing launches the port's hand kernels (B1-B10): the reference's RNN
and CTC reach no ``pallas_call``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import contrib, fused_optimizer, generated_kernels
from mxnet_tpu_torch.ops import pallas_kernels, rnn
from mxnet_tpu_torch.tools import train_ctc

COUNTERS = (fused_optimizer, pallas_kernels, generated_kernels)
TOL = 1e-5
RNN_F32_TOL, RNN_F64_TOL = 1e-4, 1e-10


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for m in COUNTERS:
        m.reset_launch_counts()
    yield
    assert not {k: v for m in COUNTERS for k, v in
                m.launch_counts().items() if v}
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _held(got, want, tol=TOL):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _rnn_grads(device, arrays, dtype=torch.float32, **kw):
    ts = [torch.tensor(a, device=device, dtype=dtype, requires_grad=True)
          for a in arrays]
    outs = rnn.rnn(*ts, state_outputs=True, **kw)
    cts = [torch.ones_like(o) for o in outs]
    grads = torch.autograd.grad(outs, ts, cts)
    return [t.detach().cpu().numpy() for t in list(outs) + list(grads)]


def _rnn_held(arrays, kw):
    for dtype, tol in ((torch.float32, RNN_F32_TOL),
                       (torch.float64, RNN_F64_TOL)):
        card_run = _rnn_grads("cuda", arrays, dtype, **kw)
        for c, h in zip(card_run, _rnn_grads("cpu", arrays, dtype, **kw)):
            _held(c, h, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_op_on_the_card_matches_the_cpu(card, mode):
    T, B, I, H, L = 6, 3, 5, 8, 2
    rng = np.random.RandomState(0)
    n = rnn.rnn_param_size(H, I, L, mode, True)
    arrays = [rng.randn(T, B, I).astype(np.float32),
              (rng.randn(n) * 0.3).astype(np.float32),
              (rng.randn(2 * L, B, H) * 0.5).astype(np.float32)]
    if mode == "lstm":
        arrays.append((rng.randn(2 * L, B, H) * 0.5).astype(np.float32))
    kw = dict(state_size=H, num_layers=L, mode=mode, bidirectional=True)
    rnn.reset_launch_counts()
    _rnn_held(arrays, kw)
    assert rnn.launch_counts()["fused"] == 4
    if mode == "lstm":
        kw.update(lstm_state_clip_min=-0.2, lstm_state_clip_max=0.2)
        rnn.reset_launch_counts()
        _rnn_held(arrays, kw)
        assert rnn.launch_counts()["loop"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("blank", ["first", "last"])
def test_ctc_loss_on_the_card_matches_the_cpu(card, blank):
    rng = np.random.RandomState(1)
    x = rng.randn(20, 4, 7).astype(np.float32)
    lab = rng.randint(1, 6, (4, 5)).astype(np.float32)
    lab[1, 3:] = 0 if blank == "first" else -1
    out = {}
    for dev in ("cuda", "cpu"):
        d = torch.tensor(x, device=dev, requires_grad=True)
        loss = contrib.ctc_loss(d, torch.tensor(lab, device=dev),
                                blank_label=blank)
        (g,) = torch.autograd.grad(loss.sum(), d)
        out[dev] = (loss.detach().cpu().numpy(), g.cpu().numpy())
    for c, h in zip(out["cuda"], out["cpu"]):
        _held(c, h)


@pytest.mark.cuda
def test_gluon_lstm_under_ctc_loss_on_the_card_matches_the_cpu(card):
    rng = np.random.RandomState(2)
    x = rng.randn(3, 12, 6).astype(np.float32)
    lab = np.array([[1, 2, 2, -1], [0, 3, -1, -1], [4, -1, -1, -1]],
                   np.float32)
    res = {}
    for dev in ("cuda", "cpu"):
        net = mx.gluon.rnn.LSTM(8, num_layers=2, layout="NTC",
                                bidirectional=True)
        net.initialize(mx.init.Xavier(), ctx=dev,
                       rng=np.random.RandomState(3))
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
        loss_fn = mx.gluon.loss.CTCLoss()
        losses = []
        for _ in range(2):
            with mx.autograd.record():
                loss = loss_fn(net(mx.nd.array(x, ctx=dev)),
                               mx.nd.array(lab, ctx=dev))
            loss.backward()
            trainer.step(3)
            losses.append(loss.asnumpy())
        res[dev] = (losses, {k[len(net.prefix):]: p.data().asnumpy()
                             for k, p in net.collect_params().items()})
    for c, h in zip(res["cuda"][0], res["cpu"][0]):
        _held(c, h, RNN_F32_TOL)
    for k, v in res["cpu"][1].items():
        _held(res["cuda"][1][k], v, RNN_F32_TOL)


@pytest.mark.cuda
def test_train_ctc_runs_on_the_card(card):
    mx.random.seed(0)
    losses = train_ctc.main(["--num-batches", "8"])
    assert len(losses) == 8 and np.isfinite(losses).all()
