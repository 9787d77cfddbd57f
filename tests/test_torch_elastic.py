"""Checkpoints of the port (``mxnet_tpu_torch.resilience.checkpoint``,
``DataParallelTrainer.save_checkpoint`` / ``restore_checkpoint`` /
``fit``) held against mxnet_tpu's.

The cases of ``tests/test_elastic.py:177-310`` and
``tests/test_resilience.py:142-301`` that involve no supervisor,
heartbeat or parameter server, on the port: atomic monolithic snapshots
(pruning, the latest loadable, a SIGKILL during a save), sharded
snapshots (integrity errors by name, the fallback to the last complete
manifest, pruning that keeps referenced shards, a SIGKILL during a shard
write), resize-on-resume at K = 1, 2 and 4 with the full state bitwise,
and bitwise resume of the replicated and ZeRO-1 tiers, in process and
across a SIGKILLed process, and of the mesh tier at ``MeshPlan(data=2,
sequence=2)``.  Then both directions across the packages:
a reference sharded checkpoint saved at K = 4 restores into the port at
K = 2 (and a port one at K = 4 into the reference at K = 2), parameters
and flat optimizer states bitwise, f32 and bf16 (encoded from its raw
bytes, ``"bfloat16"``).  The RNG state belongs to each package's own
generator and is not crossed.

Wall at ``-n 6``: ~40 s (five subprocesses of the port, three reference
trainers).
"""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.parallel import DataParallelTrainer as JaxTrainer
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.resilience import checkpoint as jckpt
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.io import NDArrayIter
from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
from mxnet_tpu_torch.resilience import chaos
from mxnet_tpu_torch.resilience import checkpoint as ckpt

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True)
def _no_chaos_leak():
    yield
    chaos.uninstall()


def _env(**extra):
    env = dict(os.environ)
    env.pop("MXTPU_CHAOS", None)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _mlp(g, hidden=32, classes=10):
    net = g.nn.HybridSequential()
    net.add(g.nn.Dense(hidden, activation="relu"))
    net.add(g.nn.Dense(classes))
    return net


def _zero_trainer(k, zero=1, seed=3, dtype=None):
    """``tests/test_elastic.py:_zero_trainer`` on the port: K in-process
    ranks on the CPU."""
    mxt.random.seed(seed)
    np.random.seed(seed)
    net = _mlp(gluon)
    net.initialize(mxt.init.Xavier(), ctx="cpu")
    return DataParallelTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.1, "momentum": 0.9},
        mesh=make_mesh((k,), ("data",), ["cpu"] * k), zero=zero,
        dtype=dtype)


def _batches(n, batch=24, feat=16, classes=10, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(batch, feat).astype(np.float32),
             rng.randint(0, classes, batch).astype(np.int64))
            for _ in range(n)]


def _params_blob(tr):
    return b"".join(p.tensor().detach().contiguous().view(torch.uint8)
                    .numpy().tobytes()
                    for p in tr._params_by_name.values())


def _full_state(tr):
    total = tr._zero_plan.total
    return [v[:total].numpy().copy() for v in tr._zero_leaves()]


# -- monolithic snapshots --------------------------------------------------
def test_checkpoint_roundtrip_prune_and_latest(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3, 4):
        ckpt.save_checkpoint(
            d, {"w": ckpt.encode_array(np.full(3, step, np.float32))},
            step=step, keep=2)
    assert [s for s, _ in ckpt.list_checkpoints(d)] == [3, 4]
    path, rec = ckpt.latest_checkpoint(d)
    assert rec["step"] == 4 and rec["provenance"]["step"] == 4
    np.testing.assert_array_equal(ckpt.decode_array(rec["payload"]["w"]),
                                  np.full(3, 4, np.float32))
    # bf16 survives the byte round trip exactly, in the reference's form:
    # each package decodes the other's encoding
    x = torch.arange(5, dtype=torch.bfloat16) / 3
    enc = ckpt.encode_array(x)
    back = ckpt.decode_array(enc)
    assert enc[1] == "bfloat16" and back.dtype == torch.bfloat16
    assert back.view(torch.int16).numpy().tobytes() == \
        x.view(torch.int16).numpy().tobytes()
    theirs = jckpt.decode_array(enc)
    assert str(theirs.dtype) == "bfloat16" and theirs.tobytes() == enc[3]
    import jax.numpy as jnp
    jx = jnp.arange(5, dtype=jnp.bfloat16) / 3
    assert ckpt.decode_array(jckpt.encode_array(jx)).view(
        torch.int16).numpy().tobytes() == np.asarray(jx).tobytes()
    # the reference reads the port's file and the port the reference's
    assert jckpt.load_checkpoint(path)["step"] == 4
    jckpt.save_checkpoint(d, {"w": jckpt.encode_array(np.arange(3.0))},
                          step=5, keep=2)
    assert ckpt.latest_checkpoint(d)[1]["step"] == 5


def test_checkpoint_kill_during_save_keeps_previous(tmp_path):
    """SIGKILL mid-save (chaos site ``checkpoint.save``): the torn
    snapshot never appears; the previous one stays the loadable latest,
    and the next good save prunes the debris."""
    d = str(tmp_path)
    script = (
        "import sys, numpy as np\n"
        "from mxnet_tpu_torch.resilience import checkpoint as ck, chaos\n"
        "d = sys.argv[1]\n"
        "ck.save_checkpoint(d, {'w': ck.encode_array(np.arange(4.))},"
        " step=1)\n"
        "print('SAVED1', flush=True)\n"
        "chaos.install([chaos.Fault('checkpoint.save', 1, 'kill')])\n"
        "ck.save_checkpoint(d, {'w': ck.encode_array(np.zeros(4))},"
        " step=2)\n"
        "print('UNREACHABLE', flush=True)\n")
    out = subprocess.run([sys.executable, "-c", script, d], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == -signal.SIGKILL, (out.returncode, out.stderr)
    assert "SAVED1" in out.stdout and "UNREACHABLE" not in out.stdout
    path, rec = ckpt.latest_checkpoint(d)
    assert rec["step"] == 1
    np.testing.assert_array_equal(ckpt.decode_array(rec["payload"]["w"]),
                                  np.arange(4.0))
    ckpt.save_checkpoint(d, {"w": ckpt.encode_array(np.ones(2))}, step=3)
    assert not [n for n in os.listdir(d) if ".tmp." in n]


# -- sharded snapshots -----------------------------------------------------
def test_shard_integrity_named_error_and_fallback(tmp_path):
    d = str(tmp_path)
    payload = {"tag": "common"}
    for step in (1, 2):
        ckpt.save_sharded_checkpoint(d, payload, [{"r": 0}, {"r": 1}],
                                     step=step, keep=3)
    manifests = ckpt.list_manifests(d)
    assert [s for s, _ in manifests] == [1, 2]
    rec = ckpt.load_sharded_checkpoint(manifests[-1][1])
    assert rec["world"] == 2 and rec["shards"][1] == {"r": 1}
    victim = [f for f in os.listdir(d)
              if f.startswith("ckpt-000000000002.shard-00001")][0]
    with open(os.path.join(d, victim), "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad")
    with pytest.raises(ckpt.ShardIntegrityError, match=victim[:20]):
        ckpt.load_sharded_checkpoint(manifests[-1][1])
    assert ckpt.latest_sharded_checkpoint(d)[1]["step"] == 1
    os.remove(os.path.join(d, victim))
    with pytest.raises(ckpt.ShardIntegrityError, match="missing"):
        ckpt.load_sharded_checkpoint(manifests[-1][1])


def test_sharded_prune_keeps_referenced_shards(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3, 4):
        ckpt.save_sharded_checkpoint(d, {"s": step}, [{}, {}],
                                     step=step, keep=2)
    assert [s for s, _ in ckpt.list_manifests(d)] == [3, 4]
    assert len([f for f in os.listdir(d) if f.endswith(".mxshard")]) == 4
    for _, path in ckpt.list_manifests(d):
        ckpt.load_sharded_checkpoint(path)
        jckpt.load_sharded_checkpoint(path)


def test_kill_during_shard_write_keeps_previous_manifest(tmp_path):
    d = str(tmp_path)
    script = (
        "import sys\n"
        "from mxnet_tpu_torch.resilience import checkpoint as ck, chaos\n"
        "d = sys.argv[1]\n"
        "ck.save_sharded_checkpoint(d, {'s': 1}, [{}, {}, {}], step=1)\n"
        "chaos.install_from_env()\n"
        "ck.save_sharded_checkpoint(d, {'s': 2}, [{}, {}, {}], step=2)\n")
    out = subprocess.run([sys.executable, "-c", script, d],
                         env=_env(MXTPU_CHAOS="ckpt.shard_write:2:kill"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == -9, (out.returncode, out.stderr[-500:])
    path, rec = ckpt.latest_sharded_checkpoint(d)
    assert rec["step"] == 1 and rec["payload"] == {"s": 1}
    assert [s for s, _ in ckpt.list_manifests(d)] == [1]


# -- resize-on-resume --------------------------------------------------------
def test_resize_parity_matrix(tmp_path):
    """Save at K = 4; restore at every K in {1, 2, 4}: the full state
    (parameters + optimizer) bitwise, and a K -> 4 re-save round-trips
    bitwise too."""
    d = str(tmp_path / "save4")
    t4 = _zero_trainer(4)
    for x, y in _batches(3):
        t4.step(x, y)
    t4.save_checkpoint(d, epoch=0, nbatch=2)
    ref_state, ref_params = _full_state(t4), _params_blob(t4)
    for k in (1, 2, 4):
        tk = _zero_trainer(k, seed=99)   # wrong seed: restore must win
        cursor = tk.restore_checkpoint(d)
        assert cursor["step"] == 3 and cursor["nbatch"] == 2
        assert _params_blob(tk) == ref_params
        for a, b in zip(ref_state, _full_state(tk)):
            assert a.tobytes() == b.tobytes()
        assert all(tuple(v.shape) == (tk._zero_plan.shard,)
                   for i in range(k) for v in tk._zero_leaves(i))
        d2 = str(tmp_path / ("resave%d" % k))
        tk.save_checkpoint(d2, epoch=0, nbatch=2)
        back = _zero_trainer(4, seed=77)
        back.restore_checkpoint(d2)
        assert _params_blob(back) == ref_params
        for a, b in zip(ref_state, _full_state(back)):
            assert a.tobytes() == b.tobytes()


def test_post_resize_training_is_deterministic(tmp_path):
    d = str(tmp_path)
    t4 = _zero_trainer(4)
    data = _batches(4)
    for x, y in data[:2]:
        t4.step(x, y)
    t4.save_checkpoint(d, epoch=0, nbatch=1)
    outs = []
    for seed in (50, 60):
        t2 = _zero_trainer(2, seed=seed)
        t2.restore_checkpoint(d)
        for x, y in data[2:]:
            t2.step(x, y)
        t2.flush()
        outs.append(_params_blob(t2))
    assert outs[0] == outs[1]


def test_monolithic_checkpoint_refused_by_zero_trainer(tmp_path):
    t0 = _zero_trainer(2, zero=0)
    x, y = _batches(1)[0]
    t0.step(x, y)
    t0.save_checkpoint(str(tmp_path), epoch=0, nbatch=0)
    t1 = _zero_trainer(2, zero=1, seed=9)
    with pytest.raises(FileNotFoundError, match="sharded"):
        t1.restore_checkpoint(str(tmp_path))


# -- bitwise resume ----------------------------------------------------------
@pytest.mark.parametrize("zero", [0, 1])
def test_trainer_resume_bitwise_identical(tmp_path, zero):
    data = _batches(8, batch=8, feat=12, classes=4, seed=42)
    k = 2 if zero else 1

    def make(seed):
        t = _zero_trainer(k, zero=zero, seed=seed)
        return t

    ref = make(5)
    for x, y in data:
        ref.step(x, y)
    ref.flush()
    crash = make(5)
    for x, y in data[:4]:
        crash.step(x, y)
    crash.save_checkpoint(str(tmp_path), epoch=0, nbatch=3)
    cont = make(99)     # wrong seed on purpose: restore must win
    cursor = cont.restore_checkpoint(str(tmp_path))
    assert cursor["step"] == 4 and cursor["nbatch"] == 3
    for x, y in data[4:]:
        cont.step(x, y)
    cont.flush()
    assert _params_blob(cont) == _params_blob(ref)
    if zero:
        for a, b in zip(_full_state(ref), _full_state(cont)):
            assert a.tobytes() == b.tobytes()
    else:
        for a, b in zip(ref._states, cont._states):
            assert a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("zero", [0, 1])
def test_fit_auto_checkpoint_and_resume(tmp_path, zero):
    rng = np.random.RandomState(3)
    X = rng.rand(48, 16).astype(np.float32)
    Y = rng.randint(0, 10, 48).astype(np.int64)
    k = 2 if zero else 1

    def make_iter():
        return NDArrayIter(X, Y, batch_size=8)

    ref = _zero_trainer(k, zero=zero, seed=21)
    ref.fit(make_iter(), num_epoch=2, bulk_size=4,
            metrics_path=str(tmp_path / "metrics.json"))
    assert os.path.exists(tmp_path / "metrics.json")
    part = _zero_trainer(k, zero=zero, seed=21)
    part.fit(make_iter(), num_epoch=1, bulk_size=4,
             checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    lister = ckpt.list_manifests if zero else ckpt.list_checkpoints
    assert lister(str(tmp_path / "ck"))
    cont = _zero_trainer(k, zero=zero, seed=77)
    cont.fit(make_iter(), num_epoch=2, bulk_size=4,
             checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
             resume=True)
    assert cont._step_count == 12
    assert _params_blob(cont) == _params_blob(ref)
    # fit's prefetch feeds step()'s fast path: every batch reused
    assert cont.put_stats == {"reused": 12, "moved": 0}


_CRASH_SCRIPT = """
import sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.io import NDArrayIter
from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
from mxnet_tpu_torch.resilience import chaos
chaos.install_from_env()
ckdir, outpath, k = sys.argv[1], sys.argv[2], int(sys.argv[3])
mx.random.seed(5); np.random.seed(5)
rng = np.random.RandomState(42)
X = rng.rand(48, 16).astype(np.float32)
Y = rng.randint(0, 4, 48).astype(np.int64)
it = NDArrayIter(X, Y, batch_size=8)
net = gluon.nn.HybridSequential()
net.add(gluon.nn.Dense(32, activation='relu'))
net.add(gluon.nn.Dense(4))
net.initialize(mx.init.Xavier(), ctx='cpu')
tr = DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(), 'sgd',
                         {'learning_rate': 0.1, 'momentum': 0.9},
                         mesh=make_mesh((k,), ('data',), ['cpu'] * k),
                         zero=int(k > 1))
tr.fit(it, num_epoch=3, bulk_size=4, checkpoint_dir=ckdir,
       checkpoint_every=2, resume=True)
blob = b''.join(p.tensor().detach().numpy().tobytes()
                for _, p in sorted(tr._params_by_name.items()))
with open(outpath, 'wb') as f:
    f.write(blob)
print('DONE', tr._step_count, flush=True)
"""


@pytest.mark.parametrize("k", [1, 2])
def test_sigkill_mid_epoch_resume_end_to_end(tmp_path, k):
    """SIGKILL the training process mid-epoch (chaos ``trainer.step`` at
    step 8 of 18), resume from the auto-checkpoint in a fresh process:
    the final parameters are bitwise the fault-free run's (replicated at
    K = 1, ZeRO-1 at K = 2)."""
    ref_out, res_out = str(tmp_path / "ref.bin"), str(tmp_path / "res.bin")
    args = [sys.executable, "-c", _CRASH_SCRIPT]
    out = subprocess.run(args + [str(tmp_path / "ref_ck"), ref_out, str(k)],
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "DONE 18" in out.stdout
    out = subprocess.run(args + [str(tmp_path / "ck"), res_out, str(k)],
                         env=_env(MXTPU_CHAOS="trainer.step:8:kill"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == -signal.SIGKILL, (out.returncode,
                                               out.stderr[-2000:])
    assert not os.path.exists(res_out)
    out = subprocess.run(args + [str(tmp_path / "ck"), res_out, str(k)],
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "DONE 18" in out.stdout
    with open(ref_out, "rb") as f, open(res_out, "rb") as g:
        assert f.read() == g.read()


# -- across the packages -----------------------------------------------------
def _jax_zero_trainer(k, dtype=None, seed=3):
    mx.random.seed(seed)
    np.random.seed(seed)
    net = _mlp(jgluon)
    net.initialize(mx.init.Xavier())
    return JaxTrainer(net, jgluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9},
                      mesh=jmake_mesh((k,), ("data",), jax.devices()[:k]),
                      zero=1, dtype=dtype)


def _jax_params_blob(tr):
    return b"".join(np.asarray(p.data()._data).tobytes()
                    for p in tr._params_by_name.values())


def _jax_full_state(tr):
    total = tr._zero_plan.total
    out = [np.asarray(v)[:total].copy() for v in tr._zero_leaves()]
    if tr._zero_master is not None:
        out.append(np.asarray(tr._zero_master)[:total].copy())
    return out


def _port_full_state(tr):
    out = _full_state(tr)
    if tr._zero_master is not None:
        out.append(torch.cat(tr._zero_master)[:tr._zero_plan.total]
                   .numpy().copy())
    return out


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_reference_sharded_checkpoint_restores_in_the_port(tmp_path, dtype):
    """The reference saves at K = 4; the port restores at K = 2 (and
    1): parameters and the full flat state (masters under bf16)
    bitwise, the padding re-derived for the port's K."""
    jt = _jax_zero_trainer(4, dtype=dtype)
    for x, y in _batches(2):
        jt.step(mx.nd.array(x), mx.nd.array(y))
    jt.save_checkpoint(str(tmp_path), epoch=0, nbatch=1)
    want_params, want_state = _jax_params_blob(jt), _jax_full_state(jt)
    for k in (2, 1):
        tr = _zero_trainer(k, seed=11, dtype=dtype)
        cursor = tr.restore_checkpoint(str(tmp_path))
        assert cursor["step"] == 2 and tr._zero_plan.k == k
        assert _params_blob(tr) == want_params
        for a, b in zip(_port_full_state(tr), want_state):
            assert a.tobytes() == b.tobytes()
        assert not tr._zero_flat[tr._zero_plan.total:].any()


def test_port_sharded_checkpoint_restores_in_the_reference(tmp_path):
    tr = _zero_trainer(4)
    for x, y in _batches(2):
        tr.step(x, y)
    tr.save_checkpoint(str(tmp_path), epoch=0, nbatch=1)
    jt = _jax_zero_trainer(2, seed=11)
    cursor = jt.restore_checkpoint(str(tmp_path))
    assert cursor["step"] == 2
    assert _jax_params_blob(jt) == _params_blob(tr)
    for a, b in zip(_jax_full_state(jt), _full_state(tr)):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("zero", [0, 1])
def test_mesh_tier_resume_bitwise_identical(tmp_path, zero):
    """The mesh tier's monolithic snapshot (``_save_mesh``): a fresh
    trainer restores it and two more steps are bitwise the uninterrupted
    run's, at ``MeshPlan(data=2, sequence=2)`` with and without ZeRO-1;
    the reference's checks of program and leaf count hold."""
    from mxnet_tpu_torch.parallel import MeshPlan
    from mxnet_tpu_torch.transformer import TransformerLM, TransformerLMConfig
    cfg = dict(vocab_size=32, d_model=16, n_heads=4, n_layers=1, d_ff=32,
               seq_len=16)
    rng = np.random.RandomState(1)
    x = rng.randint(0, 32, size=(4, 16)).astype(np.int32)
    y = np.roll(x, -1, axis=1)

    def make():
        return DataParallelTrainer(
            TransformerLM(TransformerLMConfig(**cfg)), None, "sgd",
            {"learning_rate": 0.1, "momentum": 0.9},
            mesh_plan=MeshPlan(data=2, sequence=2), zero=zero, device="cpu")

    ref = make()
    for _ in range(4):
        ref.step(x, y)
    crash = make()
    for _ in range(2):
        crash.step(x, y)
    crash.save_checkpoint(str(tmp_path), epoch=0, nbatch=1)
    cont = make()
    assert cont.restore_checkpoint(str(tmp_path))["step"] == 2
    for _ in range(2):
        cont.step(x, y)
    for name, arr in ref.mesh_params().items():
        assert arr.tobytes() == cont.mesh_params()[name].tobytes()
    other = DataParallelTrainer(
        TransformerLM(TransformerLMConfig(**dict(cfg, d_ff=64))), None,
        "sgd", {"learning_rate": 0.1, "momentum": 0.9},
        mesh_plan=MeshPlan(data=2, sequence=2), zero=zero, device="cpu")
    with pytest.raises(RuntimeError, match="does not match"):
        other.restore_checkpoint(str(tmp_path))
