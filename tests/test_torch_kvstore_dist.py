"""The ``dist_*`` kvstores across real processes, through the port's
launcher (``python -m mxnet_tpu_torch.tools.launch``), held to the
reference.

One launch of two workers (through the ``ssh`` launcher, against a
faithful ``ssh`` stand-in that runs the remote command here) runs the
worker scripts of ``tests/test_dist.py:13-110`` transliterated (exact
sum, replace, barrier, the compressed wire, the async ordering), then
trains over gloo with ``DataParallelTrainer(kvstore="dist_sync")``,
``Module.fit(kvstore="dist_sync")`` and ``gluon.Trainer(kvstore=
"dist_sync")``.  The test holds them to:

- the reference's single-process ``DataParallelTrainer`` at the full
  batch (losses 2e-5, parameters 5e-6), and the port's in-process K = 2
  tier (1e-6: the same sums in other groupings); the two workers'
  parameters bitwise equal;
- the reference's and the port's single-process ``Module`` at the full
  batch with twice the learning rate (a dist_sync push sums two
  per-worker-rescaled gradients) and ``gluon.Trainer(kvstore=None)`` at
  the full batch (1e-6; the reference starts from the port's seeded
  draw).

Then the launcher alone: ``echo``, the rendezvous-address helpers (no
packet leaves the host: the probe socket is a stand-in), ``--ps-port``,
``-s 1`` with ``--ps-state-dir``; a standalone server flushing a final
snapshot on SIGTERM; and the headline of ``tests/test_ps_recovery.py``:
``launch -n 1 -s 1 --restart-failed 1`` with the server SIGKILLed by
``MXTPU_CHAOS=kvstore.server_apply:13:kill`` resumes to parameters
byte-identical to an uncrashed run.

Wall at ``-n 6``: ~45 s (five launches of the port and the bandwidth tool's).
"""
import os
import signal
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SGD = {"learning_rate": 0.1, "momentum": 0.9}

_FAKE_SSH = '''#!/usr/bin/env python3
"""ssh stand-in: takes the argv real ssh would and runs the remote
command here through sh -c."""
import subprocess, sys
args = sys.argv[1:]
while args and args[0].startswith("-"):
    flag = args.pop(0)
    if flag in ("-o", "-p", "-i", "-l", "-F"):
        args.pop(0)
host = args.pop(0)
with open(__file__ + ".log", "a") as f:
    f.write(host + "\\n")
sys.exit(subprocess.call(["/bin/sh", "-c", " ".join(args)]))
'''

_WORKER = textwrap.dedent("""
    import sys, time
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd, autograd
    from mxnet_tpu_torch.parallel import DataParallelTrainer
    outdir = sys.argv[1]
    res = {}
    with mx.cpu():
        kv = mx.kv.create("dist_sync")
        assert kv.num_workers == 2, kv.num_workers
        r = kv.rank
        # dense exact sum, then replace (no updater)
        kv.init("dense", nd.zeros((8, 3)))
        kv.push("dense", nd.ones((8, 3)) * (r + 1))
        out = nd.zeros((8, 3))
        kv.pull("dense", out=out)
        np.testing.assert_allclose(out.asnumpy(), 3.0)
        kv.push("dense", nd.ones((8, 3)))
        kv.pull("dense", out=out)
        np.testing.assert_allclose(out.asnumpy(), 2.0)
        kv.barrier()
        # the compressed wire: opposite signs cancel exactly
        kv.init("g", nd.zeros((8,)))
        kvc = mx.kv.create("dist_sync")
        kvc.init("g", nd.zeros((8,)))
        kvc.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        sign = 1.0 if r == 0 else -1.0
        kvc.push("g", nd.array(np.array(
            [2.0, -2.0, 0.1, 2.0, 0.0, -2.0, 2.0, 0.1], np.float32) * sign))
        o8 = nd.zeros((8,))
        kvc.pull("g", out=o8)
        np.testing.assert_allclose(o8.asnumpy(), 0.0, atol=1e-6)
        print("SYNC WORKER %d OK" % r, flush=True)

        # async: each push applies on arrival, no rendezvous
        kva = mx.kv.create("dist_async")
        assert kva.num_workers == 2
        kva.init("w", nd.zeros((4,)))
        kva.set_optimizer(mx.optimizer.SGD(learning_rate=1.0))
        kva.barrier()

        def poll(pred):
            o = nd.zeros((4,))
            for _ in range(1200):
                kva.pull("w", out=o)
                if pred(o.asnumpy()[0]):
                    return o.asnumpy()[0]
                time.sleep(0.05)
            raise AssertionError("store never reached expected state")
        if r == 0:
            for _ in range(3):
                kva.push("w", nd.ones((4,)))
        else:
            poll(lambda x: x <= -3.0 + 1e-5)
            for _ in range(2):
                kva.push("w", nd.ones((4,)))
        final = poll(lambda x: x <= -5.0 + 1e-5)
        np.testing.assert_allclose(final, -5.0, atol=1e-5)
        assert kva.get_num_dead_node() == 0
        kva.barrier()
        kva.close()
        print("ASYNC WORKER %d OK" % r, flush=True)

        rng = np.random.RandomState(42)
        X = rng.randn(64, 16).astype(np.float32)
        y = (X @ rng.randn(16, 4).astype(np.float32)).argmax(1)
        B, half = 32, 16
        rows = lambda s: slice((s * B) % 64 + r * half,
                               (s * B) % 64 + (r + 1) * half)

        # DataParallelTrainer over the store
        mx.random.seed(7)
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(32, activation="relu"))
        net.add(gluon.nn.Dense(4))
        net.initialize(mx.init.Xavier())
        tr = DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9},
                                 kvstore="dist_sync", device="cpu")
        res["dpt_loss"] = np.array([float(tr.step(X[rows(s)],
                                                  y[rows(s)].astype(np.int64)))
                                    for s in range(4)])
        for i, p in enumerate(net.collect_params().values()):
            res["dpt_p%d" % i] = p.tensor().detach().numpy()

        # Module.fit over the store
        data = mx.sym.Variable("data")
        fc = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
        act = mx.sym.Activation(fc, act_type="relu")
        fc2 = mx.sym.FullyConnected(act, num_hidden=4, name="fc2")
        sym = mx.sym.SoftmaxOutput(fc2, name="softmax")
        it = mx.io.NDArrayIter(X[r * 32:(r + 1) * 32],
                               y[r * 32:(r + 1) * 32].astype(np.float32), 8)
        mod = mx.mod.Module(sym, context=mx.cpu())
        np.random.seed(11)
        mod.fit(it, num_epoch=1, kvstore="dist_sync", optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mx.init.Xavier())
        for k, v in mod.get_params()[0].items():
            res["mod_" + k] = v.asnumpy()

        # gluon.Trainer over the store
        mx.random.seed(5)
        gnet = gluon.nn.Dense(4, in_units=16)
        gnet.initialize(mx.init.Xavier())
        gtr = gluon.Trainer(gnet.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9},
                            kvstore="dist_sync")
        lossf = gluon.loss.SoftmaxCrossEntropyLoss()
        for s in range(3):
            xb = nd.array(X[rows(s)])
            yb = nd.array(y[rows(s)].astype(np.float32))
            with autograd.record():
                l = lossf(gnet(xb), yb)
            l.backward()
            gtr.step(B)
        for k, p in gnet.collect_params().items():
            res["gl_" + k.split("_", 1)[1]] = p.data().asnumpy()
    np.savez("%s/rank%d.npz" % (outdir, r), **res)
    kv.barrier()
    print("TRAIN WORKER %d OK" % r, flush=True)
""")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("MXTPU_CHAOS", None)
    env["MXTPU_HEARTBEAT_INTERVAL_S"] = "0.5"
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _launch(args, env=None, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch"] + args,
        env=env or _env(), capture_output=True, text=True, timeout=timeout,
        cwd=_ROOT)


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    bindir = tmp / "bin"
    bindir.mkdir()
    shim = bindir / "ssh"
    shim.write_text(_FAKE_SSH)
    shim.chmod(0o755)
    env = _env(PATH="%s%s%s" % (bindir, os.pathsep,
                                os.environ.get("PATH", "")))
    proc = _launch(["-n", "2", "--launcher", "ssh", sys.executable,
                    str(script), str(tmp)], env=env)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    return tmp, out, [dict(np.load(tmp / ("rank%d.npz" % r)))
                      for r in (0, 1)]


def _data():
    rng = np.random.RandomState(42)
    X = rng.randn(64, 16).astype(np.float32)
    y = (X @ rng.randn(16, 4).astype(np.float32)).argmax(1)
    return X, y


def test_dist_sync_and_async_semantics_over_ssh(workers):
    tmp, out, _ = workers
    for r in (0, 1):
        for tag in ("SYNC", "ASYNC", "TRAIN"):
            assert "%s WORKER %d OK" % (tag, r) in out, out[-3000:]
    assert "over gloo (no CUDA device" in out
    log = (tmp / "bin" / "ssh.log").read_text().splitlines()
    assert log.count("localhost") == 2


def test_dist_trainer_matches_reference_and_in_process_tier(workers):
    import mxnet_tpu as ref
    import mxnet_tpu_torch as mx
    from mxnet_tpu import gluon as rgluon
    from mxnet_tpu.parallel import DataParallelTrainer as RefTrainer
    from mxnet_tpu.parallel import make_mesh as ref_mesh
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
    import jax
    _, _, res = workers
    X, y = _data()
    B = 32
    names = sorted(k for k in res[0] if k.startswith("dpt_p"))
    for k in names + ["dpt_loss"]:
        assert res[0][k].tobytes() == res[1][k].tobytes(), k
    # the reference, one process, the full batch
    ref.random.seed(7)
    rnet = rgluon.nn.HybridSequential()
    rnet.add(rgluon.nn.Dense(32, activation="relu"))
    rnet.add(rgluon.nn.Dense(4))
    rnet.initialize(ref.init.Xavier())
    rtr = RefTrainer(rnet, rgluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     SGD, mesh=ref_mesh((1,), ("data",),
                                        jax.local_devices()[:1]))
    rl = []
    for s in range(4):
        sl = slice((s * B) % 64, (s * B) % 64 + B)
        rl.append(float(rtr.step(ref.nd.array(X[sl]),
                                 ref.nd.array(y[sl])).asscalar()))
    # the port, in-process K = 2 over the full batch (the deferred
    # shapes draw at the first step, so each net steps after its seed)
    mx.random.seed(7)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(32, activation="relu"))
    net.add(gluon.nn.Dense(4))
    net.initialize(mx.init.Xavier(), ctx="cpu")
    tr = DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                             "sgd", SGD, mesh=make_mesh((2,), ("data",),
                                                        ["cpu", "cpu"]))
    kl = []
    for s in range(4):
        sl = slice((s * B) % 64, (s * B) % 64 + B)
        kl.append(float(tr.step(X[sl], y[sl].astype(np.int64))))
    np.testing.assert_allclose(res[0]["dpt_loss"], rl, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(res[0]["dpt_loss"], kl, rtol=1e-6, atol=1e-6)
    rparams = [p.data().asnumpy() for p in rnet.collect_params().values()]
    kparams = [p.tensor().detach().numpy()
               for p in net.collect_params().values()]
    for i, k in enumerate(names):
        np.testing.assert_allclose(res[0][k], rparams[i], rtol=5e-6,
                                   atol=5e-6, err_msg=k)
        np.testing.assert_allclose(res[0][k], kparams[i], rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def _module_fit(pkg, X, y, arg_params=None):
    """The workers' MLP through ``pkg``'s one-process ``Module.fit`` over
    the two workers' batches joined into full batches of 16, at twice the
    workers' learning rate (a dist_sync push sums two per-worker-rescaled
    gradients).  Initial weights: Xavier after ``np.random.seed(11)``, as
    in the workers, or ``arg_params``.  Returns (initial, final) args."""
    data = pkg.sym.Variable("data")
    fc = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    act = pkg.sym.Activation(fc, act_type="relu")
    fc2 = pkg.sym.FullyConnected(act, num_hidden=4, name="fc2")
    sym = pkg.sym.SoftmaxOutput(fc2, name="softmax")
    # worker r's batch b is rows r*32 + 8b: one full batch of 16
    order = np.concatenate([np.r_[8 * b:8 * b + 8, 32 + 8 * b:
                                  32 + 8 * b + 8] for b in range(4)])
    it = pkg.io.NDArrayIter(X[order], y[order].astype(np.float32), 16)
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    mod.bind(it.provide_data, it.provide_label)
    np.random.seed(11)
    mod.init_params(initializer=pkg.init.Xavier(), arg_params=arg_params)
    init = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.2, "momentum": 0.9})
    return init, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _gluon_steps(pkg, X, y, weights=None):
    """The workers' Dense(4) through ``pkg``'s ``gluon.Trainer(kvstore=
    None)`` over three full batches of 32 (Xavier after
    ``mx.random.seed(5)``, as in the workers, or ``weights`` in
    ``collect_params`` order).  Returns (initial, final) in that order."""
    pkg.random.seed(5)
    net = pkg.gluon.nn.Dense(4, in_units=16)
    net.initialize(pkg.init.Xavier())
    params = list(net.collect_params().values())
    for p, w in zip(params, weights or ()):
        p.set_data(pkg.nd.array(w))
    init = [p.data().asnumpy() for p in params]
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd", SGD, kvstore=None)
    lossf = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for s in range(3):
        sl = slice((s * 32) % 64, (s * 32) % 64 + 32)
        with pkg.autograd.record():
            loss = lossf(net(pkg.nd.array(X[sl])),
                         pkg.nd.array(y[sl].astype(np.float32)))
        loss.backward()
        tr.step(32)
    return init, [p.data().asnumpy() for p in params]


def test_dist_module_and_gluon_trainer_match_one_process(workers):
    """The two workers' Module and Gluon runs against one process of the
    reference (its weights carried from the port's seeded draw) and of
    the port, at the full batch.  (The reference's own dist route for
    ``gluon.Trainer`` is C18; its one-process trainer is not.)"""
    import mxnet_tpu as ref
    import mxnet_tpu_torch as mx
    _, _, res = workers
    X, y = _data()
    for k in res[0]:
        if k.startswith(("mod_", "gl_")):
            assert res[0][k].tobytes() == res[1][k].tobytes(), k
    with mx.cpu():
        init, port = _module_fit(mx, X, y)
        gl_init, gl_port = _gluon_steps(mx, X, y)
    _, want = _module_fit(ref, X, y, arg_params={
        k: ref.nd.array(v) for k, v in init.items()})
    _, gl_want = _gluon_steps(ref, X, y, weights=gl_init)
    assert set(want) == set(port) == {k[4:] for k in res[0]
                                      if k.startswith("mod_")}
    for k in want:
        for other in (want, port):
            np.testing.assert_allclose(res[0]["mod_" + k], other[k],
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    names = ("weight", "bias")
    for i, k in enumerate(names):
        for other in (gl_want, gl_port):
            np.testing.assert_allclose(res[0]["gl_" + k], other[i],
                                       rtol=1e-6, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _launch_mod():
    from mxnet_tpu_torch.tools import launch
    return launch


def test_launcher_imports_neither_torch_nor_the_reference():
    code = ("import sys; import mxnet_tpu_torch.tools.launch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'mxnet_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], env=_env(), check=True,
                   timeout=60)


def test_echo_spawns_recovery_armed_server_rank(tmp_path):
    out = _launch(["-n", "2", "-s", "1", "--launcher", "echo",
                   "--ps-state-dir", str(tmp_path), "--env", "A=1",
                   "--env-server", "B=2", "python", "train.py"])
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 3
    assert "DMLC_ROLE=server" in lines[0] and " B=2 " in lines[0]
    assert "MXTPU_PS_STATE_DIR=%s" % tmp_path in lines[0]
    assert all("DMLC_NUM_SERVER=1" in line and "A=1" in line
               for line in lines)
    for r, line in enumerate(lines[1:]):
        assert "DMLC_ROLE=worker" in line and "B=2" not in line
        for kv in ("RANK=%d" % r, "WORLD_SIZE=2", "LOCAL_RANK=%d" % r,
                   "DMLC_WORKER_ID=%d" % r, "MASTER_ADDR=127.0.0.1"):
            assert " %s " % kv in " %s " % line, (kv, line)


def test_ps_port_override_reaches_workers():
    out = _launch(["-n", "2", "--launcher", "echo", "--ps-port", "23456",
                   "echo", "hi"])
    assert out.returncode == 0, out.stderr
    lines = [l for l in out.stdout.splitlines() if l.strip()]
    assert len(lines) == 2
    assert all("MXTPU_PS_PORT=23456" in line for line in lines)


def test_telemetry_dir_names_its_item():
    out = _launch(["-n", "1", "--telemetry-dir", "/nonexistent", "echo"])
    assert out.returncode != 0 and "A12" in out.stderr


class _FakeUDP:
    """The probe socket of ``routable_ip``: no packet, no lookup."""

    def __init__(self, *a, **k):
        pass

    def connect(self, addr):
        self.peer = addr

    def getsockname(self):
        return ("10.1.2.3", 40000)

    def close(self):
        pass


def test_coordinator_address_helpers(monkeypatch):
    m = _launch_mod()
    assert m.coordinator_address(["localhost", "localhost"]).startswith(
        "127.0.0.1:")
    host, port = m.coordinator_address(["worker-a", "localhost"]).rsplit(
        ":", 1)
    assert host == "worker-a" and 20000 <= int(port) <= 59999
    monkeypatch.setattr(m.socket, "socket", _FakeUDP)
    monkeypatch.setattr(m, "free_port", lambda: 12345)
    assert m.coordinator_address(["localhost", "remote-host-1"]) == \
        "10.1.2.3:12345"
    assert m.local_ranks(["a", "b"], 5) == [(0, 3), (0, 2), (1, 3), (1, 2),
                                            (2, 3)]


def test_read_hostfile_and_worker_env(tmp_path):
    m = _launch_mod()
    f = tmp_path / "hosts"
    f.write_text("# fleet\nnode1 slots=8\n\nnode2\n")
    assert m.read_hostfile(str(f)) == ["node1", "node2"]
    env = m.worker_env("10.0.0.1:2000", 4, 3, 7000, 1, (1, 2))
    assert env["MASTER_ADDR"] == "10.0.0.1" and env["MASTER_PORT"] == "2000"
    assert (env["RANK"], env["WORLD_SIZE"], env["LOCAL_RANK"],
            env["LOCAL_WORLD_SIZE"]) == ("3", "4", "1", "2")
    assert env["MXTPU_PS_PORT"] == "7000" and env["DMLC_NUM_SERVER"] == "1"
    senv = m.server_env(4, 7000, "/s")
    assert senv["DMLC_ROLE"] == "server" and \
        senv["MXTPU_PS_STATE_DIR"] == "/s"


# ---------------------------------------------------------------------------
# the standalone server: SIGTERM, and SIGKILL mid-training
# ---------------------------------------------------------------------------
_SERVER_SRC = (
    "from mxnet_tpu_torch.kvstore_server import _init_kvstore_server_module\n"
    "_init_kvstore_server_module()\n")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_standalone_server_sigterm_flushes_final_snapshot(tmp_path):
    from mxnet_tpu_torch import kvstore_ps
    from mxnet_tpu_torch.resilience import checkpoint as ckpt
    d = str(tmp_path / "state")
    port = _free_port()
    env = _env(DMLC_ROLE="server", MXTPU_PS_PORT=port, MXTPU_PS_STATE_DIR=d,
               MXTPU_PS_SNAPSHOT_EVERY=100000, MXTPU_HEARTBEAT_INTERVAL_S=0)
    proc = subprocess.Popen([sys.executable, "-c", _SERVER_SRC], env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        cli = kvstore_ps.PSClient("127.0.0.1", port, rank=0,
                                  connect_retry_s=120)
        cli.init_array("k", np.zeros(4, np.float32))
        cli.push_array("k", np.full(4, 3.0, np.float32), step=1)
        cli.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert ckpt.list_checkpoints(d)
        srv = kvstore_ps.PSServer(port=0, state_dir=d)
        assert srv.generation == 2
        assert srv.recovered_wal_records == 0
        np.testing.assert_array_equal(srv._store["k"],
                                      np.full(4, 3.0, np.float32))
        srv.stop()
    finally:
        proc.kill()


_FLEET_SRC = textwrap.dedent("""
    import pickle, sys, os
    import numpy as np
    from mxnet_tpu_torch.kvstore_server import _init_kvstore_server_module
    _init_kvstore_server_module()          # the server rank stops here
    from mxnet_tpu_torch import kvstore_ps, optimizer as opt
    outpath, steps = sys.argv[1], int(sys.argv[2])
    cli = kvstore_ps.PSClient("127.0.0.1", int(os.environ["MXTPU_PS_PORT"]),
                              rank=0, connect_retry_s=120)
    cli.request("set_optimizer", pickle.dumps(
        opt.create("sgd", learning_rate=0.1, momentum=0.9)))
    keys = ["w0", "w1"]
    rng = np.random.RandomState(11)
    for k in keys:
        cli.init_array(k, rng.rand(32).astype(np.float32))
    step = 0
    for s in range(steps):
        for k in keys:
            step += 1
            cli.push_array(k, rng.rand(32).astype(np.float32) - 0.5,
                           step=step)
    with open(outpath, "wb") as f:
        f.write(b"".join(cli.pull_array(k).tobytes() for k in keys))
    print("DONE", step, "failovers", cli.failovers, flush=True)
    cli.close()
""")


def _fleet(tmp_path, tag, chaos=None):
    script = tmp_path / "fleet.py"
    script.write_text(_FLEET_SRC)
    out = str(tmp_path / (tag + ".bin"))
    args = ["-n", "1", "-s", "1", "--restart-failed", "1",
            "--ps-state-dir", str(tmp_path / ("state_" + tag)),
            "--env", "MXTPU_PS_RETRIES=12",
            "--env-server", "MXTPU_PS_SNAPSHOT_EVERY=5"]
    if chaos:
        args += ["--env-server", "MXTPU_CHAOS=" + chaos]
    proc = _launch(args + [sys.executable, str(script), out, "10"])
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    assert "DONE 20" in proc.stdout
    with open(out, "rb") as f:
        return f.read(), proc.stdout + proc.stderr


def test_sigkill_server_mid_training_resumes_bitwise(tmp_path):
    """The server SIGKILLed at applied push 13 of 20 (snapshot cadence 5,
    the WAL behind the last snapshot, push 13 re-sent) and
    respawned by the launcher over its state dir: the worker survives the
    failover and pulls bytes equal to an uncrashed run's."""
    import re
    ref, _ = _fleet(tmp_path, "ref")
    got, out = _fleet(tmp_path, "crash", "kvstore.server_apply:13:kill")
    # the WAL tail replayed depends on whether the background write of
    # the snapshot at push 10 finished before the kill: 2 records, or 7
    # behind the snapshot at push 5
    m = re.search(r"generation=2, recovered_wal=(\d+)", out)
    assert "restarting" in out and m and int(m.group(1)) >= 1, out[-2000:]
    assert "failovers 1" in out
    assert got == ref


@pytest.mark.parametrize("on_kvstore", [False, True])
def test_reference_gluon_dist_route_faults_the_port_does_not_keep(
        monkeypatch, on_kvstore):
    """ROADMAP C18.  With a multi-worker store the reference's Gluon
    ``Trainer`` (a) off the kvstore route pushes gradients into a store
    that aliases the parameters, so the parameter becomes the gradient
    sum before the update, and (b) on it pushes twice a step, so its
    store applies the update twice.  The port's takes one SGD step from
    the parameter either way.  (Two workers stand in as a store whose
    ``num_workers`` is 2 and whose cross-process sum is the identity.)"""
    import mxnet_tpu as ref
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kvstore as kvmod
    monkeypatch.setattr(kvmod, "_all_reduce_sum", lambda t: t)
    x = np.array([[1.0, 2.0, -1.0]], np.float32)
    w0 = np.array([[0.5, -0.25, 1.0], [0.1, 0.2, 0.3]], np.float32)
    out = {}
    for name, pkg, ctx in (("port", mx, mx.cpu()), ("ref", ref, ref.cpu())):
        with ctx:
            net = pkg.gluon.nn.Dense(2, in_units=3, use_bias=False)
            net.initialize()
            net.weight.set_data(pkg.nd.array(w0))
            kv = pkg.kv.create("dist_sync")
            kv._num_workers = 2
            tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.5}, kvstore=kv,
                                   update_on_kvstore=on_kvstore)
            with pkg.autograd.record():
                loss = net(pkg.nd.array(x)).sum()
            loss.backward()
            tr.step(1)
            out[name] = net.weight.data().asnumpy()
    g = np.repeat(x, 2, axis=0)                   # d(sum(W x)) / dW
    np.testing.assert_allclose(out["port"], w0 - 0.5 * g, atol=1e-6)
    want_ref = w0 - 2 * 0.5 * g if on_kvstore else g - 0.5 * g
    np.testing.assert_allclose(out["ref"], want_ref, atol=1e-6)


def test_cluster_that_never_forms_raises(monkeypatch):
    """The launcher's env names a world of 2 but no rank 0 answers: the
    store raises, as the reference's ``_check_dist_env``, instead of
    training alone."""
    from mxnet_tpu_torch import kvstore
    from mxnet_tpu_torch.base import MXNetError
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(MXNetError, match="MASTER_PORT"):
        kvstore.create("dist_sync")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("MXTPU_DIST_TIMEOUT_S", "2")
    with pytest.raises(MXNetError, match="did not form"):
        kvstore.create("dist_sync")
    assert kvstore.backend_rule(2)[0] in ("gloo", "nccl")


def test_legacy_server_probe_exits_zero():
    env = _env(DMLC_ROLE="server", DMLC_PS_ROOT_URI="127.0.0.1")
    env.pop("MXTPU_PS_PORT", None)
    out = subprocess.run([sys.executable, "-c", _SERVER_SRC], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "has no work" in out.stderr


def test_bandwidth_tool_on_the_host():
    """tools/bandwidth at a tiny size: every primitive in process at K = 2
    and 4, gloo at world size 1 and at 2 processes through the launcher,
    and kvstore push + pull through dist_sync and dist_async."""
    from mxnet_tpu_torch.tools import bandwidth
    recs = bandwidth.main(["--size-mb", "0.05", "--iters", "1", "--device",
                           "cpu"])
    got = {(r["primitive"], r["route"], r["ranks"]) for r in recs}
    for p in ("all_reduce_mean", "all_gather", "reduce_scatter_mean"):
        for route, k in (("in_process", 2), ("in_process", 4),
                         ("gloo", 1), ("gloo", 2)):
            assert (p, route, k) in got
    assert {("push_pull", "dist_sync", 2),
            ("push_pull", "dist_async", 2)} <= got
    assert all(r["ms"] > 0 for r in recs)
