"""Model-axis tensor parallelism (A7(a)): the port held against mxnet_tpu.

- The port's mesh-tier trainer at every plan the reference's
  ``tests/test_transformer.py:130-180`` holds — ``{model: 2}``,
  ``{data: 2, model: 2}``, ``{model: 2, sequence: 2}``, ``{data: 2,
  model: 2, sequence: 2}``, Ulysses and ``auto`` at ``model=2,
  sequence=2``, ZeRO-1 at ``data=2, model=2`` — against ONE module-scope
  run of the reference's trainer at the collapsed plan (the reference's
  own baseline), 3 steps at its tiny geometry: losses within 2e-5 and
  parameters within 5e-6, the reference's tolerances.
  ``TP_ROW_PSUM = False`` (the reference's mutation seam) must make the
  ``model=2`` run miss them.
- Layout: ``partition_spec``, ``global_shape`` and ``local_shape`` of
  every parameter, the ``MeshPlan`` arithmetic and the divisibility
  errors, against the reference's.
- Checkpoints: a ``model=2`` run resumed bitwise, and a reference ZeRO-1
  ``data=2, model=2`` checkpoint restored by the port (the ``("model",
  "data")`` flat state) and trained one more step within the
  tolerances.
- TP decode: ``DecodeProgram(plan=MeshPlan(data=1, model=2))`` behind
  ``DecodeRunner`` against the reference's at the same plan, logits
  within 1e-4 (``tests/test_torch_decode.py``'s tolerance).
- ``group2ctx`` shardings over a port ``Mesh`` against
  ``tests/test_group2ctx.py:35-100``, and ``tools/model_parallel_lstm``
  (the reference's fitted specs; the sharded executor's numbers equal
  the unsharded one's); ``tools/train_transformer_lm`` against
  the reference example's losses (2e-5) with its chaos probe;
  ``tools/ring_attention_demo`` on the CPU.
- B4 and B5-B7 at the TP layout's shapes on a card: the ``cuda``-marked
  ``tests/test_torch_tensor_parallel_cuda.py`` (no JAX there; ``chip_smoke.py``
  phase 34 runs them at the full width).
"""
import argparse
import contextlib
import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as ref
from mxnet_tpu.ndarray import NDArray as RefNDArray
from mxnet_tpu.parallel import DataParallelTrainer as RefTrainer
from mxnet_tpu.parallel import MeshPlan as RefPlan
from mxnet_tpu.transformer import TransformerLM as RefLM
from mxnet_tpu.transformer import TransformerLMConfig as RefConfig
from mxnet_tpu_torch.ops import fused_optimizer as fo
from mxnet_tpu_torch.ops import pallas_kernels as pk
from mxnet_tpu_torch.parallel import DataParallelTrainer, MeshPlan
from mxnet_tpu_torch.transformer import (TransformerLM, TransformerLMConfig,
                                         layers as tlayers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=32, d_model=16, n_heads=4, n_layers=1, d_ff=32,
           seq_len=16)
STEPS = 3
LOSS_TOL, PARAM_TOL = 2e-5, 5e-6
SGD = {"learning_rate": 0.1, "momentum": 0.9}


def _batch(batch=4, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, CFG["vocab_size"],
                    size=(batch, CFG["seq_len"])).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def _ref_step(tr, x, y):
    return float(tr.step(RefNDArray(jnp.asarray(x)),
                         RefNDArray(jnp.asarray(y))).asnumpy())


@pytest.fixture(scope="module")
def baseline():
    """The reference's trainer at the collapsed plan: losses, params."""
    ref.random.seed(0)
    tr = RefTrainer(RefLM(RefConfig(**CFG)), None, "sgd", dict(SGD),
                    mesh_plan=RefPlan(data=1))
    x, y = _batch()
    losses = [_ref_step(tr, x, y) for _ in range(STEPS)]
    return losses, tr.mesh_params()


def _port(plan, zero=0, attention="ring", steps=STEPS):
    tr = DataParallelTrainer(
        TransformerLM(TransformerLMConfig(**CFG, attention=attention)), None,
        "sgd", dict(SGD), mesh_plan=plan, zero=zero, device="cpu")
    x, y = _batch()
    return tr, [float(tr.step(x, y)) for _ in range(steps)]


def _assert_matches(tr, losses, baseline):
    want_losses, want_params = baseline
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=LOSS_TOL)
    got = tr.mesh_params()
    assert list(got) == list(want_params)
    for name, arr in got.items():
        np.testing.assert_allclose(arr, want_params[name], rtol=0,
                                   atol=PARAM_TOL, err_msg=name)


# -- the trainer at every plan --------------------------------------------------
@pytest.mark.parametrize("plan_kw,zero,attention,mode", [
    ({"model": 2}, 0, "ring", "local"),
    ({"data": 2, "model": 2}, 0, "ring", "local"),
    ({"model": 2, "sequence": 2}, 0, "ring", "ring"),
    ({"data": 2, "model": 2, "sequence": 2}, 0, "ring", "ring"),
    ({"model": 2, "sequence": 2}, 0, "ulysses", "ulysses"),
    ({"model": 2, "sequence": 2}, 0, "auto", "ulysses"),
    ({"data": 2, "model": 2}, 1, "ring", "local"),
], ids=["m2", "d2m2", "m2s2", "d2m2s2", "ulysses", "auto", "zero1"])
def test_tensor_parallel_matches_reference_baseline(baseline, plan_kw, zero,
                                                    attention, mode):
    before = pk.launch_counts(), fo.launch_counts()
    tr, losses = _port(MeshPlan(**plan_kw), zero=zero, attention=attention)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (pk.launch_counts(), fo.launch_counts()) == before
    assert tr._mesh_program.attention_mode == mode
    _assert_matches(tr, losses, baseline)
    if zero:
        # one (Km * shard,) slice of the ("model", "data") space per data
        # rank
        zp = tr._mesh_zero_plan
        assert [tuple(leaf.shape) for leaves in tr._mesh_state_leaves
                for leaf in leaves] == [(2 * zp.shard,)] * 2


def test_row_psum_seam_breaks_model_parallel_parity(baseline, monkeypatch):
    """The reference's mutation seam: without the row-parallel psum every
    rank trains on its own partial activations."""
    monkeypatch.setattr(tlayers, "TP_ROW_PSUM", False)
    tr, losses = _port(MeshPlan(model=2))
    gap = max(abs(a - b) for a, b in zip(losses, baseline[0]))
    assert gap > 100 * LOSS_TOL, gap


# -- layout and validation --------------------------------------------------------
def test_mesh_plan_and_layout_match_reference():
    plan, jplan = (MeshPlan(data=2, model=2, sequence=2),
                   RefPlan(data=2, model=2, sequence=2))
    for a, b in ((plan, jplan), (MeshPlan(model=2, sequence=2).resolve(8),
                                 RefPlan(model=2, sequence=2).resolve(8))):
        assert (a.describe(), a.total, a.axis_sizes(), a.batch_axes(),
                tuple(a.batch_spec())) == (b.describe(), b.total,
                                           b.axis_sizes(), b.batch_axes(),
                                           tuple(b.batch_spec()))
    assert MeshPlan.coerce({"data": 2, "model": 2}) == \
        MeshPlan(data=2, model=2)
    mesh = plan.build_mesh("cpu")
    assert mesh.shape == {"data": 2, "model": 2, "sequence": 2}
    assert not mesh.process_group and mesh.local_device == \
        torch.device("cpu")
    cfg = TransformerLMConfig(**CFG)
    for p, jp in ((plan, jplan), (MeshPlan(), RefPlan(data=1))):
        prog = TransformerLM(cfg).mesh_program(p)
        jprog = RefLM(RefConfig(**CFG)).mesh_program(jp)
        assert prog.param_names == jprog.param_names
        for name in prog.param_names:
            assert tuple(prog.partition_spec(name)) == tuple(
                jprog.partition_spec(name)), name
            assert prog.global_shape(name) == jprog.global_shape(name)
            assert prog.local_shape(name) == jprog.local_shape(name)
        assert prog.local_batch_shape(8) == jprog.local_batch_shape(8)
    # a rank view is a view of the global tensor, and round-trips
    prog = TransformerLM(cfg).mesh_program(plan)
    w = torch.arange(float(np.prod(prog.global_shape("l0_wq")))).view(
        prog.global_shape("l0_wq"))
    stacked = prog.rank_view("l0_wq", w)
    assert tuple(stacked.shape) == (2,) + prog.local_shape("l0_wq")
    assert stacked.data_ptr() == w.data_ptr()
    assert torch.equal(stacked[1], w[:, 2:])
    assert torch.equal(prog.rank_unview("l0_wq", stacked), w)


@pytest.mark.parametrize("extra,plan_kw,match", [
    ({"n_heads": 3, "d_model": 15}, {"model": 2}, "n_heads"),
    ({"d_ff": 33}, {"model": 2}, "d_ff"),
    ({"vocab_size": 33}, {"model": 2}, "vocab_size"),
    ({"attention": "ulysses"}, {"model": 2, "sequence": 4}, "ulysses"),
])
def test_divisibility_errors_match_reference(extra, plan_kw, match):
    for lm, cfgc, planc in ((TransformerLM, TransformerLMConfig, MeshPlan),
                            (RefLM, RefConfig, RefPlan)):
        with pytest.raises(ValueError, match=match):
            lm(cfgc(**dict(CFG, **extra))).mesh_program(planc(**plan_kw))


def test_mesh_context_tag_and_model_parallel_kwarg():
    blk = TransformerLM(TransformerLMConfig(**CFG))
    t1 = DataParallelTrainer(blk, None, "sgd", mesh_plan=MeshPlan(
        data=2, model=2), device="cpu")
    assert t1._mesh_context_tag() == "tp_model"
    t2 = DataParallelTrainer(blk, None, "sgd", mesh_plan=MeshPlan(
        data=2, sequence=2), device="cpu")
    assert t2._mesh_context_tag() == "tp_sequence"
    t3 = DataParallelTrainer(blk, None, "sgd", model_parallel=2,
                             sequence_parallel=2, device="cpu")
    assert t3.mesh_plan == MeshPlan(data=1, model=2, sequence=2)


_ZERO1_GLOO = """
import sys
import numpy as np
import torch
import torch.distributed as dist
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2)
from mxnet_tpu_torch import optimizer
from mxnet_tpu_torch.parallel import MeshPlan
from mxnet_tpu_torch.parallel.comm import ProcessGroupComm
from mxnet_tpu_torch.parallel.zero import _shard_update
from mxnet_tpu_torch.transformer import TransformerLM, TransformerLMConfig
from mxnet_tpu_torch.transformer.step import TPZeroPlan, build_parts
cfg, sgd, steps = eval(sys.argv[4]), eval(sys.argv[5]), int(sys.argv[6])
x, y = (np.load(sys.argv[7])[k] for k in "xy")
program = TransformerLM(TransformerLMConfig(**cfg)).mesh_program(
    MeshPlan(data=2, model=2))
init = program.init_params()
vals = tuple(torch.tensor(init[n], requires_grad=True)
             for n in program.param_names)
zp = TPZeroPlan(program, 2)
opt = optimizer.create("sgd", **sgd)
mom = opt.create_state_multi_precision(0, torch.zeros(2 * zp.shard))


def apply_update(i, w, g, leaves, lr, t):
    _shard_update(opt, w, g, leaves[0], lr, t)
    return w, leaves


grads_part, update_part = build_parts(
    program, apply_update, None, zero=1, zero_plan=zp,
    comm=ProcessGroupComm(2, torch.device("cpu")))
rows = slice(rank * len(x) // 2, (rank + 1) * len(x) // 2)
xs, ys = ([torch.from_numpy(a[rows]).long()[None]] for a in (x, y))
losses = []
for t in range(1, steps + 1):
    opt.num_update = t
    grads, loss = grads_part(vals, xs, ys)
    new_vals, _ = update_part(vals, [(mom,)], grads, opt.lr, t)
    with torch.no_grad():
        for w, nw in zip(vals, new_vals):
            w.copy_(nw)
    losses.append(float(loss))
np.savez(out, losses=np.array(losses), mom=mom.numpy(),
         **{n: v.detach().numpy() for n, v in zip(program.param_names,
                                                  vals)})
dist.destroy_process_group()
"""


def test_tp_zero1_step_over_a_process_group_matches_in_process(tmp_path):
    """The ZeRO-1 step at data=2, model=2 keeps its collectives in the
    comm: over two gloo processes (``ProcessGroupComm``, one data rank
    each, both model ranks in process) the losses, parameters and each
    rank's ``(Km * shard,)`` momentum equal the in-process trainer's."""
    import subprocess
    import sys
    tr, want_losses = _port(MeshPlan(data=2, model=2), zero=1)
    x, y = _batch()
    np.savez(str(tmp_path / "batch.npz"), x=x, y=y)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    outs = [str(tmp_path / ("out%d.npz" % r)) for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _ZERO1_GLOO, str(r), str(tmp_path / "store"),
         outs[r], repr(CFG), repr(SGD), str(STEPS),
         str(tmp_path / "batch.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    want = tr.mesh_params()
    for r, out in enumerate(outs):
        got = dict(np.load(out))
        np.testing.assert_allclose(got["losses"], want_losses, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(
            got["mom"], tr._mesh_state_leaves[r][0].numpy(), rtol=0,
            atol=1e-6)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=1e-6, err_msg=name)


# -- checkpoints -----------------------------------------------------------------
def test_model_parallel_checkpoint_resumes_bitwise(tmp_path):
    tr, _ = _port(MeshPlan(data=2, model=2), zero=1, steps=2)
    tr.save_checkpoint(str(tmp_path), epoch=0, nbatch=1)
    x, y = _batch()
    tr.step(x, y)
    want = tr.mesh_params()
    fresh = DataParallelTrainer(
        TransformerLM(TransformerLMConfig(**CFG)), None, "sgd", dict(SGD),
        mesh_plan=MeshPlan(data=2, model=2), zero=1, device="cpu")
    assert fresh.restore_checkpoint(str(tmp_path))["step"] == 2
    fresh.step(x, y)
    got = fresh.mesh_params()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_reference_zero1_model_checkpoint_cross_loads(tmp_path):
    """The reference's ZeRO-1 snapshot at data=2, model=2 (flat state in
    ("model", "data") order) restored by the port, one more step each."""
    ref.random.seed(0)
    jtr = RefTrainer(RefLM(RefConfig(**CFG)), None, "sgd", dict(SGD),
                     mesh_plan=RefPlan(data=2, model=2), zero=1)
    x, y = _batch()
    for _ in range(2):
        _ref_step(jtr, x, y)
    jtr.save_checkpoint(str(tmp_path), epoch=0, nbatch=1)
    want_states = [np.asarray(v) for v in jtr._mesh_state_leaves]
    want_loss = _ref_step(jtr, x, y)
    want = jtr.mesh_params()
    tr = DataParallelTrainer(
        TransformerLM(TransformerLMConfig(**CFG)), None, "sgd", dict(SGD),
        mesh_plan=MeshPlan(data=2, model=2), zero=1, device="cpu")
    assert tr.restore_checkpoint(str(tmp_path))["step"] == 2
    for got, w in zip(tr._mesh_state_vectors(), want_states):
        np.testing.assert_array_equal(got.numpy(), w)
    np.testing.assert_allclose(float(tr.step(x, y)), want_loss, rtol=0,
                               atol=LOSS_TOL)
    got = tr.mesh_params()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=PARAM_TOL, err_msg=name)


# -- TP decode ---------------------------------------------------------------------
def test_tp_decode_matches_reference_model_plan(monkeypatch):
    from mxnet_tpu.serving.decode import DecodeRunner as RefRunner
    from mxnet_tpu.transformer.decode import DecodeProgram as RefProgram
    from mxnet_tpu_torch.serving.decode import DecodeRunner
    from mxnet_tpu_torch.transformer import DecodeProgram, from_jax_params
    monkeypatch.setenv("MXTPU_FUSED_LAYERNORM", "1")
    dcfg = dict(vocab_size=32, d_model=16, n_heads=4, n_layers=2, d_ff=32,
                seq_len=32)
    jprog = RefProgram(RefConfig(**dcfg), plan=RefPlan(data=1, model=2),
                       page_size=8)
    params = jprog.program.init_params(0)
    jr = RefRunner(jprog, params, slots=2, prefill_buckets=(8, 16),
                   warmup=False)
    prog = DecodeProgram(TransformerLMConfig(**dcfg),
                         plan=MeshPlan(data=1, model=2), page_size=8)
    assert prog.heads_local == 2 and prog.cache_shape(5) == \
        jprog.cache_shape(5)
    assert prog.global_cache_shape(5) == jprog.global_cache_shape(5)
    tr = DecodeRunner(prog, from_jax_params(params, "cpu"), slots=2,
                      prefill_buckets=(8, 16), warmup=False, device="cpu")
    rng = np.random.RandomState(3)
    pt = np.zeros((2, jr.pages_per_seq), np.int32)
    lengths = np.zeros(2, np.int32)
    toks = np.zeros(2, np.int32)
    for slot, n in enumerate((5, 11)):
        prompt = rng.randint(1, dcfg["vocab_size"], size=n).astype(np.int32)
        pages = jr.pool.alloc(3)
        assert tr.pool.alloc(3) == pages
        jl, tl = jr.prefill(prompt, pages), tr.prefill(prompt, pages)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
        pt[slot, :3], lengths[slot], toks[slot] = pages, n, int(jl.argmax())
    for _ in range(4):
        jl = jr.decode_step(pt, lengths, toks)
        tl = tr.decode_step(pt, lengths, toks)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
        toks = jl.argmax(axis=1).astype(np.int32)   # teacher forcing
        lengths += 1
    # the cached decode equals the no-cache oracle, and the collapsed plan
    prompt = rng.randint(1, dcfg["vocab_size"], size=6).astype(np.int32)
    flat = DecodeRunner(DecodeProgram(TransformerLMConfig(**dcfg),
                                      page_size=8),
                        from_jax_params(params, "cpu"), slots=2,
                        prefill_buckets=(8, 16), warmup=False, device="cpu")
    want = flat.reference_decode(prompt, 5)
    np.testing.assert_array_equal(tr.reference_decode(prompt, 5), want)


# -- group2ctx over a port mesh ----------------------------------------------------
def _two_group_net(pkg):
    data = pkg.sym.Variable("data")
    with pkg.AttrScope(ctx_group="g0"):
        fc1 = pkg.sym.FullyConnected(data, num_hidden=32, name="fc1")
        act = pkg.sym.Activation(fc1, act_type="relu")
    with pkg.AttrScope(ctx_group="g1"):
        fc2 = pkg.sym.FullyConnected(act, num_hidden=16, name="fc2")
    return fc2


def test_group2ctx_shardings_match_reference():
    import mxnet_tpu_torch as mx
    from jax.sharding import Mesh as JMesh
    from jax.sharding import PartitionSpec as JP
    from mxnet_tpu.executor import _fit_spec as ref_fit
    from mxnet_tpu_torch.executor import _fit_spec
    from mxnet_tpu_torch.parallel.mesh import PartitionSpec, make_mesh
    jmesh = JMesh(np.asarray(jax.devices()[:8]), ("model",))
    mesh = make_mesh((8,), ("model",), ["cpu"] * 8)
    rng = np.random.RandomState(0)
    args = {"data": rng.randn(4, 8).astype(np.float32),
            "fc1_weight": rng.randn(32, 8).astype(np.float32),
            "fc1_bias": np.zeros(32, np.float32),
            "fc2_weight": rng.randn(16, 32).astype(np.float32),
            "fc2_bias": np.zeros(16, np.float32)}
    jexe = _two_group_net(ref).bind(
        jmesh, args=args, group2ctx={"g0": JP("model"),
                                     "g1": JP(None, "model")})
    exe = _two_group_net(mx).bind(
        mesh, args={k: v.copy() for k, v in args.items()},
        group2ctx={"g0": PartitionSpec("model"),
                   "g1": PartitionSpec(None, "model")})
    assert exe._arg_groups == jexe._arg_groups
    for name in args:
        want = tuple(jexe.arg_dict[name]._data.sharding.spec)
        got = exe._sharding(name)
        assert got.mesh is mesh and tuple(got.spec) == want, name
    out = exe.forward(is_train=True)[0].asnumpy()
    want = jexe.forward(is_train=True)[0].asnumpy()
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)
    exe.backward()
    assert all(np.isfinite(g.asnumpy()).all()
               for g in exe.grad_dict.values())
    for spec, shape in ((("model",), (1, 4)), (("model",), (16, 4)),
                        ((None, "model"), (3, 16))):
        assert tuple(_fit_spec(PartitionSpec(*spec), shape, mesh)) == \
            tuple(ref_fit(JP(*spec), shape, jmesh))
    # Module(group2ctxs=) reaches the executor
    net = mx.sym.SoftmaxOutput(_two_group_net(mx), name="softmax")
    mod = mx.mod.Module(net, context=mesh,
                        group2ctxs={"g0": PartitionSpec("model"),
                                    "g1": PartitionSpec(None, "model")})
    it = mx.io.NDArrayIter(rng.rand(16, 8).astype(np.float32),
                           (np.arange(16) % 4).astype(np.float32), 8)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(initializer=mx.init.Xavier())
    assert mod._exec._sharding("fc1_weight").spec == PartitionSpec("model")
    mod.forward(next(iter(it)), is_train=True)
    mod.backward()
    assert np.isfinite(mod.get_outputs()[0].asnumpy()).all()


def test_model_parallel_lstm_tool_places_and_trains():
    """The example's groups land the reference's fitted specs, and the
    sharded executor's numbers are the unsharded one's (placement changes
    no number, as under GSPMD)."""
    from jax.sharding import Mesh as JMesh
    from jax.sharding import PartitionSpec as JP
    from mxnet_tpu.executor import _fit_spec as ref_fit
    from mxnet_tpu_torch.tools import model_parallel_lstm as tool
    with contextlib.redirect_stdout(io.StringIO()):
        losses, exe = tool.main(["--device", "cpu"])
    assert len(losses) == 4 and losses[-1] < losses[0]
    jmesh = JMesh(np.asarray(jax.devices()[:8]), ("model",))
    for name, spec in (("l0_params", ("model",)), ("l1_params", ("model",)),
                       ("l0_init_h", ("model",)), ("decoder_weight", ())):
        shape = tuple(exe.arg_dict[name].shape)
        assert tuple(exe._sharding(name).spec) == tuple(
            ref_fit(JP(*spec), shape, jmesh)), name
    net = tool.lstm_unroll(2, 8, 16, 16, num_label=10)
    args = {n: a.asnumpy() for n, a in exe.arg_dict.items()}
    plain = net.bind("cpu", args=args, grad_req={
        k: ("write" if "params" in k or "decoder" in k else "null")
        for k in args})
    for e in (exe, plain):
        e.forward(is_train=True)
        e.backward()
    np.testing.assert_array_equal(exe.outputs[0].asnumpy(),
                                  plain.outputs[0].asnumpy())
    for name, g in exe.grad_dict.items():
        np.testing.assert_array_equal(g.asnumpy(),
                                      plain.grad_dict[name].asnumpy())


# -- the entry points ---------------------------------------------------------
def _lm_args(**kw):
    base = dict(steps=4, batch=4, seq_len=16, vocab=32, d_model=16, heads=4,
                layers=1, d_ff=32, lr=0.5, data=2, model=2, sequence=2,
                zero=0, attention="ring", seed=0, log_every=100, chaos="",
                report=False)
    base.update(kw)
    return argparse.Namespace(**base)


def test_train_transformer_lm_tool_matches_reference_example():
    import importlib.util
    from mxnet_tpu_torch.tools import train_transformer_lm as tool
    spec = importlib.util.spec_from_file_location(
        "train_transformer_lm_ref",
        os.path.join(REPO, "examples", "long_context",
                     "train_transformer_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    np.testing.assert_array_equal(tool.make_corpus(32, 512, 7),
                                  mod.make_corpus(32, 512, 7))
    want = mod.train(_lm_args(), logger=lambda *a: None)
    got = tool.train(_lm_args(device="cpu"), logger=lambda *a: None)
    assert got["plan"] == want["plan"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=LOSS_TOL)
    assert got["final_loss"] < got["head_loss"]
    with pytest.raises(NotImplementedError, match="item 13"):
        tool.train(_lm_args(device="cpu", report=True))


def test_train_transformer_lm_chaos_probe():
    from mxnet_tpu_torch.resilience import chaos
    from mxnet_tpu_torch.tools import train_transformer_lm as tool
    try:
        with pytest.raises(chaos.ChaosError, match="train.step"):
            tool.main(["--steps", "6", "--batch", "4", "--seq-len", "32",
                       "--vocab", "32", "--d-model", "16", "--heads", "2",
                       "--layers", "1", "--d-ff", "32", "--model", "2",
                       "--sequence", "2", "--chaos", "train.step:3:raise",
                       "--device", "cpu"])
    finally:
        chaos.uninstall()
        os.environ.pop("MXTPU_CHAOS", None)


def test_ring_attention_demo_runs_on_the_cpu(capsys):
    from mxnet_tpu_torch.tools import ring_attention_demo
    res = ring_attention_demo.main(["--seq-len", "128", "--heads", "4",
                                    "--head-dim", "16", "--ranks", "4",
                                    "--device", "cpu"])
    assert res["ring_ms"] > 0 and res["ulysses_ms"] > 0
    assert res["max_err"] < 1e-5
    assert "ring attention" in capsys.readouterr().out
