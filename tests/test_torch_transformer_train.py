"""TransformerLM training with ring attention: the port held against
mxnet_tpu.

- The plain versions of the flash kernels (``flash_forward_with_lse``,
  ``flash_dq``, ``flash_dkv``) against the Pallas kernels run in
  interpret mode, and ``flash_attention`` forward and gradients against
  the reference's: 1e-5 (f32; the two sum in other orders, the Pallas
  kernels block by block).
- ``ring_attention_sharded`` (K = 2 and 4) and ``ulysses_attention_sharded``
  (K = 2) forward and gradients against the reference's on a K-device
  CPU mesh: 1e-5.
- ``fused_layer_norm`` gradients against the reference's ``custom_vjp``:
  1e-5.
- The slice as a whole: ``DataParallelTrainer(TransformerLM(...), None,
  "sgd", ..., mesh_plan=MeshPlan(sequence=K))`` for K = 1, 2, 4 (and
  Ulysses at K = 2) against the reference's trainer with
  ``MeshPlan(data=1, sequence=K)``, 3 steps at the reference's own tiny
  geometry (``tests/test_transformer.py:26-29``): losses at 2e-5 and
  parameters at 5e-6, the reference's tolerances.
- The refusals name their ROADMAP.md items.
- ``cuda``-marked tests hold each CUDA kernel to its plain version on a
  card (skipped without one; ``chip_smoke.py`` phase 7 runs the same
  checks at the training path's shapes).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import mxnet_tpu as mx
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu.ops import fused_optimizer as jax_fused
from mxnet_tpu.ops import pallas_kernels as jax_pk
from mxnet_tpu.parallel import DataParallelTrainer as JaxTrainer
from mxnet_tpu.parallel import MeshPlan as JaxPlan
from mxnet_tpu.parallel import ring_attention_sharded as jax_ring_sharded
from mxnet_tpu.parallel import \
    ulysses_attention_sharded as jax_ulysses_sharded
from mxnet_tpu.transformer import TransformerLM as JaxLM
from mxnet_tpu.transformer import TransformerLMConfig as JaxConfig
from mxnet_tpu_torch.ops import fused_optimizer as F
from mxnet_tpu_torch.ops import pallas_kernels as pk
from mxnet_tpu_torch.parallel import (DataParallelTrainer, MeshPlan,
                                      ring_attention,
                                      ring_attention_sharded,
                                      ulysses_attention_sharded)
from mxnet_tpu_torch.transformer import TransformerLM, TransformerLMConfig

TOL = 1e-5
LOSS_TOL, PARAM_TOL = 2e-5, 5e-6
CFG = dict(vocab_size=32, d_model=16, n_heads=4, n_layers=1, d_ff=32,
           seq_len=16)
STEPS = 3
SGD = {"learning_rate": 0.1, "momentum": 0.9}

# (BH, Tq, Tk, D): the small width, T over the 128-row Pallas block with a
# ragged tail, and Tq != Tk
FLASH_SHAPES = [(2, 16, 16, 4), (3, 200, 200, 8), (2, 192, 160, 8)]


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


# -- the flash kernels' plain versions ----------------------------------------
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,tq,tk,d", FLASH_SHAPES)
def test_flash_plain_versions_match_pallas(bh, tq, tk, d, causal):
    rng = np.random.RandomState(tq + tk + d)
    q, do = _randn(rng, bh, tq, d), _randn(rng, bh, tq, d)
    k, v = _randn(rng, bh, tk, d), _randn(rng, bh, tk, d)
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    want_o, want_lse = jax_pk.flash_forward_with_lse(jq, jk, jv, causal,
                                                     scale, interpret=True)
    before = pk.launch_counts()
    got_o, got_lse = pk.flash_forward_with_lse(_t(q), _t(k), _t(v), causal,
                                               scale)
    assert got_lse.shape == (bh, tq) and got_lse.dtype == torch.float32
    _close(got_o, want_o, msg="out")
    _close(got_lse, want_lse, msg="lse")
    # the backward kernels on the same (lse, delta)
    delta = jax_pk.flash_delta(want_o, jdo)
    _close(pk.flash_delta(_t(want_o), _t(do)), delta, msg="delta")
    args = (jq, jk, jv, jdo, want_lse, delta, causal, scale)
    targs = tuple(_t(a) for a in args[:6]) + (causal, scale)
    _close(pk.flash_dq(*targs), jax_pk.flash_dq(*args, interpret=True),
           msg="dq")
    got_dk, got_dv = pk.flash_dkv(*targs)
    want_dk, want_dv = jax_pk.flash_dkv(*args, interpret=True)
    _close(got_dk, want_dk, msg="dk")
    _close(got_dv, want_dv, msg="dv")
    # CPU tensors take the plain versions: no kernel launch is counted
    assert pk.launch_counts() == before


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_forward_and_grads_match_reference(causal):
    rng = np.random.RandomState(11)
    B, T, Tk, H, D = 2, 150, 140 if not causal else 150, 2, 8
    q, g = _randn(rng, B, T, H, D), _randn(rng, B, T, H, D)
    k, v = _randn(rng, B, Tk, H, D), _randn(rng, B, Tk, H, D)
    want, vjp = jax.vjp(lambda a, b, c: jax_pk.flash_attention(
        a, b, c, causal=causal), *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    got = pk.flash_attention(tq, tk, tv, causal=causal)
    got.backward(_t(g))
    _close(got.detach(), want, msg="out")
    for t, w, name in zip((tq, tk, tv), want_grads, ("dq", "dk", "dv")):
        _close(t.grad, w, msg=name)


# -- ring / Ulysses attention -------------------------------------------------
def _attention_case(fn_port, fn_jax, k_ranks, causal, B=2, T=32, H=4, D=8,
                    seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, g = (_randn(rng, B, T, H, D) for _ in range(4))
    mesh = Mesh(np.array(jax.devices()[:k_ranks]), ("sp",))
    want, vjp = jax.vjp(lambda a, b, c: fn_jax(a, b, c, mesh, causal=causal),
                        *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    got = fn_port(tq, tk, tv, k_ranks, causal=causal)
    got.backward(_t(g))
    assert got.shape == (B, T, H, D)
    _close(got.detach(), want, msg="out")
    for t, w, name in zip((tq, tk, tv), want_grads, ("dq", "dk", "dv")):
        _close(t.grad, w, msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("k_ranks", [2, 4])
def test_ring_attention_matches_reference(k_ranks, causal):
    before = pk.launch_counts()
    _attention_case(ring_attention_sharded, jax_ring_sharded,
                    k_ranks, causal, seed=k_ranks + causal)
    assert pk.launch_counts() == before


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_reference(causal):
    # H / K = 2 heads per group: the head order of the swap back matters
    _attention_case(ulysses_attention_sharded, jax_ulysses_sharded, 2,
                    causal, seed=7)


def test_ring_attention_takes_a_plan_and_checks_the_rank_dim():
    rng = np.random.RandomState(3)
    q, k, v = (_t(_randn(rng, 2, 1, 8, 2, 4)) for _ in range(3))
    out = ring_attention(q, k, v, MeshPlan(sequence=2), causal=True)
    assert out.shape == q.shape
    with pytest.raises(ValueError, match="K=4"):
        ring_attention(q, k, v, 4)


# -- the LayerNorm backward ---------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 7, 32), (37, 96), (2, 2, 4, 16)])
def test_layer_norm_grads_match_reference(shape):
    rng = np.random.RandomState(len(shape) + shape[-1])
    x = (_randn(rng, *shape) * 3 + 1)
    s, b = _randn(rng, shape[-1]), _randn(rng, shape[-1])
    g = _randn(rng, *shape)
    want, vjp = jax.vjp(jax_fused.fused_layer_norm,
                        *(jnp.asarray(a) for a in (x, s, b)))
    want_grads = vjp(jnp.asarray(g))
    tx, ts, tb = (_t(a).requires_grad_() for a in (x, s, b))
    got = F.fused_layer_norm(tx, ts, tb)
    got.backward(_t(g))
    _close(got.detach(), want, msg="out")
    for t, w, name in zip((tx, ts, tb), want_grads, ("dx", "dscale", "dbias")):
        _close(t.grad, w, msg=name)


# -- the slice: the trainer's mesh tier ---------------------------------------
def _batch(batch=4, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, CFG["vocab_size"],
                    size=(batch, CFG["seq_len"])).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def _jax_train(k_ranks, attention, data=1, zero=0, model=1):
    mx.random.seed(0)
    plan = JaxPlan(data=data, model=model, sequence=k_ranks)
    tr = JaxTrainer(JaxLM(JaxConfig(**CFG, attention=attention)), None, "sgd",
                    dict(SGD), mesh_plan=plan, zero=zero)
    x, y = _batch()
    losses = [float(tr.step(NDArray(jnp.asarray(x)),
                            NDArray(jnp.asarray(y))).asnumpy())
              for _ in range(STEPS)]
    return losses, tr.mesh_params()


@pytest.mark.parametrize("k_ranks,attention", [
    (1, "ring"), (2, "ring"), (4, "ring"), (2, "ulysses")])
def test_trainer_matches_reference_mesh_tier(k_ranks, attention):
    want_losses, want_params = _jax_train(k_ranks, attention)
    plan = MeshPlan(sequence=k_ranks) if k_ranks > 1 else MeshPlan()
    tr = DataParallelTrainer(
        TransformerLM(TransformerLMConfig(**CFG, attention=attention)), None,
        "sgd", dict(SGD), mesh_plan=plan, device="cpu")
    x, y = _batch()
    before = pk.launch_counts(), F.launch_counts()
    losses = []
    for _ in range(STEPS):
        loss = tr.step(x, y)
        assert loss.shape == () and loss.device.type == "cpu"
        losses.append(float(loss))
    assert (pk.launch_counts(), F.launch_counts()) == before
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=LOSS_TOL)
    assert losses[-1] < losses[0]
    got = tr.mesh_params()
    assert list(got) == list(want_params)
    for name, arr in got.items():
        assert arr.dtype == np.float32
        np.testing.assert_allclose(arr, want_params[name], rtol=0,
                                   atol=PARAM_TOL, err_msg=name)
    expect = {1: "local", 2: attention, 4: attention}[k_ranks]
    assert tr._mesh_program.attention_mode == expect


def test_sequence_parallel_kwarg_and_default_plan():
    blk = TransformerLM(TransformerLMConfig(**CFG))
    tr = DataParallelTrainer(blk, None, "sgd", dict(SGD), sequence_parallel=2,
                             device="cpu")
    assert tr.mesh_plan == MeshPlan(data=1, sequence=2)
    tr2 = DataParallelTrainer(blk, None, "sgd", device="cpu")
    assert tr2.mesh_plan == MeshPlan(data=1)
    with pytest.raises(RuntimeError, match="mesh_params"):
        tr2.mesh_params()
    x, _ = _batch()
    a = tr.step(x, np.roll(x, -1, 1))
    b = tr2.step(x, np.roll(x, -1, 1))
    np.testing.assert_allclose(float(a), float(b), rtol=0, atol=LOSS_TOL)


def test_mesh_plan_declares_the_reference_arithmetic():
    plan = MeshPlan(sequence=4)
    assert plan.batch_axes() == ("sequence",)
    assert plan.axis_sizes() == {"sequence": 4}
    assert plan.on_one_device() == MeshPlan(data=1, sequence=4)
    assert plan.on_one_device().total == 4
    assert MeshPlan(data=1).batch_axes() == ()
    jplan = JaxPlan(data=1, sequence=4)
    mine = MeshPlan(data=1, sequence=4)
    assert (mine.describe(), mine.total, mine.axis_sizes()) == (
        jplan.describe(), jplan.total, jplan.axis_sizes())
    cfg = TransformerLMConfig(**CFG)
    prog, jprog = (TransformerLM(cfg).mesh_program(mine),
                   JaxLM(JaxConfig(**CFG)).mesh_program(jplan))
    assert prog.local_batch_shape(8) == jprog.local_batch_shape(8) == (8, 4)
    for name in prog.param_names:
        assert prog.local_shape(name) == jprog.local_shape(name)


def _port_train(plan, zero=0, attention="ring"):
    tr = DataParallelTrainer(
        TransformerLM(TransformerLMConfig(**CFG, attention=attention)), None,
        "sgd", dict(SGD), mesh_plan=plan, zero=zero, device="cpu")
    x, y = _batch()
    losses = [float(tr.step(x, y)) for _ in range(STEPS)]
    return tr, losses


def _assert_mesh_params(got, want_params):
    assert list(got) == list(want_params)
    for name, arr in got.items():
        np.testing.assert_allclose(arr, want_params[name], rtol=0,
                                   atol=PARAM_TOL, err_msg=name)


@pytest.mark.parametrize("make,item", [
    (lambda: MeshPlan(model=2), "item 7"),
    (lambda: MeshPlan(sequence=2, pipeline=2), "item 8"),
    (lambda: (MeshPlan(data=2), 0, (1, 2, 0)), "item 6"),
    (lambda: (MeshPlan(sequence=2), 1, (2, 1, 1)), "item 6"),
], ids=["model", "pipeline", "data", "zero"])
def test_unported_axes_and_modes_raise(make, item):
    if item == "item 6":
        # ported by item 6(a): a data axis of 2 ranks (in turn, each on
        # its rows), and zero=1 beside the sequence ranks, train and are
        # held to the reference's plan at the mesh tier's tolerances
        plan, zero, (seq, data, jzero) = make()
        want_losses, want_params = _jax_train(seq, "ring", data=data,
                                              zero=jzero)
        tr, losses = _port_train(plan, zero=zero)
        np.testing.assert_allclose(losses, want_losses, rtol=0,
                                   atol=LOSS_TOL)
        _assert_mesh_params(tr.mesh_params(), want_params)
        return
    if item == "item 7":
        # ported by item 7(a): the model ranks as a leading dimension,
        # held to the reference's same plan (every other TP plan is held in
        # tests/test_torch_tensor_parallel.py)
        want_losses, want_params = _jax_train(1, "ring", model=2)
        tr, losses = _port_train(make())
        np.testing.assert_allclose(losses, want_losses, rtol=0,
                                   atol=LOSS_TOL)
        _assert_mesh_params(tr.mesh_params(), want_params)
        return
    with pytest.raises(NotImplementedError, match=item):
        make()


def test_data_by_sequence_zero1_matches_reference():
    """``MeshPlan(data=2, sequence=2)`` with ``zero=1``: the data ranks in
    turn around the leading sequence dimension, each data rank's flat
    gradient reduce-scattered after the sequence mean, each updating its
    (shard,) slice; against the reference on 4 virtual devices."""
    want_losses, want_params = _jax_train(2, "ring", data=2, zero=1)
    tr, losses = _port_train(MeshPlan(data=2, sequence=2), zero=1)
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=LOSS_TOL)
    _assert_mesh_params(tr.mesh_params(), want_params)
    zp = tr._mesh_zero_plan
    assert zp.k == 2 and len(tr._mesh_state_leaves) == 2
    assert all(tuple(leaf.shape) == (zp.shard,)
               for leaves in tr._mesh_state_leaves for leaf in leaves)
    assert tr.batch_sharding.spec == ("data", "sequence")


def test_mesh_tier_validates_block_and_batch():
    with pytest.raises(ValueError, match="mesh_program"):
        DataParallelTrainer(object(), None, "sgd", mesh_plan=MeshPlan(),
                            device="cpu")
    tr = DataParallelTrainer(TransformerLM(TransformerLMConfig(**CFG)), None,
                             "sgd", sequence_parallel=2, device="cpu")
    x = np.zeros((4, CFG["seq_len"] // 2), np.int32)
    with pytest.raises(ValueError, match="cfg.seq_len"):
        tr.step(x, x)
    with pytest.raises(ValueError, match="divide by the sequence axis"):
        TransformerLM(TransformerLMConfig(**dict(CFG, seq_len=15))
                      ).mesh_program(MeshPlan(sequence=2))


# -- the CUDA kernels against their plain versions (a card only) --------------
def _cuda_case(bh, tq, tk, d, causal, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(bh, tq, d, device="cuda", generator=gen)
             for _ in range(2))
    k, v = (torch.randn(bh, tk, d, device="cuda", generator=gen)
            for _ in range(2))
    o, lse = pk.flash_forward_with_lse_reference(q, k, v, causal, d ** -0.5)
    return (q, k, v, do, lse, pk.flash_delta(o, do), causal, d ** -0.5)


CUDA_CASES = [(4, 200, 200, 16, True), (3, 97, 130, 64, False),
              (2, 1, 16, 16, True), (2, 70, 70, 128, True)]


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
def test_flash_forward_kernel_matches_plain_on_cuda():
    _needs_cuda()
    for i, case in enumerate(CUDA_CASES):
        q, k, v, _, _, _, causal, scale = _cuda_case(*case, seed=i)
        before = pk.launch_counts()["flash_forward_with_lse"]
        o, lse = pk.flash_forward_with_lse(q, k, v, causal, scale)
        torch.cuda.synchronize()
        assert pk.launch_counts()["flash_forward_with_lse"] == before + 1
        want_o, want_lse = pk.flash_forward_with_lse_reference(q, k, v,
                                                               causal, scale)
        torch.testing.assert_close(o, want_o, rtol=TOL, atol=TOL)
        torch.testing.assert_close(lse, want_lse, rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_flash_dq_kernel_matches_plain_on_cuda():
    _needs_cuda()
    for i, case in enumerate(CUDA_CASES):
        args = _cuda_case(*case, seed=i)
        before = pk.launch_counts()["flash_dq"]
        got = pk.flash_dq(*args)
        torch.cuda.synchronize()
        assert pk.launch_counts()["flash_dq"] == before + 1
        torch.testing.assert_close(got, pk.flash_dq_reference(*args),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_flash_dkv_kernel_matches_plain_on_cuda():
    _needs_cuda()
    for i, case in enumerate(CUDA_CASES):
        args = _cuda_case(*case, seed=i)
        before = pk.launch_counts()["flash_dkv"]
        dk, dv = pk.flash_dkv(*args)
        torch.cuda.synchronize()
        assert pk.launch_counts()["flash_dkv"] == before + 1
        want_dk, want_dv = pk.flash_dkv_reference(*args)
        torch.testing.assert_close(dk, want_dk, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(dv, want_dv, rtol=1e-4, atol=1e-4)
