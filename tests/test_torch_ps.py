"""The parameter server of the port (``kvstore_ps``, ``resilience/
heartbeat.py``, ``resilience/server_state.py``) in one process, held to
the reference.

- The port's versions of the reference's elasticity and recovery tests
  (``tests/test_resilience.py:420-684``, ``tests/test_ps_recovery.py:
  73-306``): heartbeat death and rejoin, key reassignment, the staleness
  gate (2-bit pushes too), reconnect with backoff, the chunked-push
  restart, the orphaned chunk tail, barrier not retried, chaos drops,
  snapshot + WAL recovery bitwise, idempotent replay and dedup, pruning,
  generation and failover, residuals surviving a failover.
- Across the packages, bitwise: a port ``PSClient`` against a reference
  ``PSServer`` and the reverse, with dense, chunked (``BIGARRAY_BOUND``
  4), ``rsp`` and ``2bit`` payloads; a state dir with no optimizer
  written by one package's server and recovered by the other's.
- With an optimizer: SGD + momentum servers of both packages fed the
  same pushes hold weights and updater states within 1e-6.
- The launcher leaves ``MXTPU_CHAOS`` out of a respawned rank's env
  (its one subprocess test: a rank that fails while armed).

Wall at ``-n 6``: ~15 s (the heartbeat timeouts and the launcher's
restart backoff are most of it).
"""
import os
import pickle
import socket
import sys
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu import kvstore_ps as ref_ps
from mxnet_tpu import optimizer as ref_opt
from mxnet_tpu_torch import kvstore_ps
from mxnet_tpu_torch import optimizer as opt
from mxnet_tpu_torch.resilience import (ChaosSchedule, Fault,
                                        HeartbeatMonitor, chaos)
from mxnet_tpu_torch.resilience import checkpoint as ckpt

PKGS = {"port": kvstore_ps, "ref": ref_ps}
TOL = 1e-6


@pytest.fixture(autouse=True)
def _no_chaos_leak():
    yield
    chaos.uninstall()


def _ctx(rank=0):
    return {"staging": {}, "snapshots": {}, "claimed_inits": set(),
            "rank": rank}


def _sgd_blob(momentum=0.9):
    return pickle.dumps(opt.create("sgd", learning_rate=0.1,
                                   momentum=momentum))


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not pred():
        time.sleep(0.05)
    return pred()


# ---------------------------------------------------------------------------
# heartbeats, ownership, staleness (tests/test_resilience.py:420-684)
# ---------------------------------------------------------------------------
def test_heartbeat_monitor_detects_silence_and_rejoin():
    dead = []
    mon = HeartbeatMonitor(timeout_s=0.2, on_dead=dead.append)
    mon.beat(0, step=5)
    mon.beat(1, step=9)
    assert mon.max_step() == 9
    t_end = time.monotonic() + 1.0
    while time.monotonic() < t_end and not mon.dead():
        mon.beat(0)
        mon.check()
        time.sleep(0.05)
    assert mon.dead() == {1} and dead == [1]
    mon.beat(1)
    assert mon.dead() == set()


def test_watchdog_survives_on_dead_callback_error():
    deaths = []

    def bad_cb(rank):
        deaths.append(rank)
        raise RuntimeError("callback boom")
    mon = HeartbeatMonitor(timeout_s=0.2, poll_s=0.05, on_dead=bad_cb)
    mon.start()
    try:
        mon.beat(0)
        assert _wait(lambda: deaths, 5)
        mon.beat(0)
        assert _wait(lambda: len(deaths) >= 2, 5)
        assert deaths == [0, 0]
    finally:
        mon.stop()


def test_ps_watchdog_reassigns_dead_worker_keys():
    server = kvstore_ps.PSServer(port=0, num_workers=2,
                                 heartbeat_timeout_s=0.6,
                                 watchdog_poll_s=0.1)
    a = kvstore_ps.PSClient("127.0.0.1", server.port, rank=0)
    b = kvstore_ps.PSClient("127.0.0.1", server.port, rank=1)
    try:
        a.start_heartbeat(0.1)
        b.start_heartbeat(0.1)
        a.init_array("wa", np.ones(4, np.float32))
        b.init_array("wb", np.full(4, 2.0, np.float32))
        assert server.key_owner("wa") == 0
        assert server.key_owner("wb") == 1
        assert a.request("key_owner", "wb")[1] == 1
        b._hb.stop()
        b._hb = None
        assert _wait(lambda: a.request("num_dead")[1] >= 1)
        assert server.key_owner("wb") == 0
        assert server._reassignments == [("wb", 1, 0)]
        np.testing.assert_array_equal(a.pull_array("wb"),
                                      np.full(4, 2.0, np.float32))
        b2 = kvstore_ps.PSClient("127.0.0.1", server.port, rank=1)
        b2.request("heartbeat", 1, 0)
        assert _wait(lambda: a.request("num_dead")[1] == 0, 5)
        assert server.key_owner("wb") == 0
        b2.close()
    finally:
        a.close()
        b.close()
        server.stop()


def test_ps_bounded_staleness_gate_bites():
    server = kvstore_ps.PSServer(port=0, num_workers=2, max_staleness=2)
    a = kvstore_ps.PSClient("127.0.0.1", server.port, rank=0)
    b = kvstore_ps.PSClient("127.0.0.1", server.port, rank=1)
    try:
        a.init_array("w", np.zeros(4, np.float32))
        a.push_array("w", np.ones(4, np.float32), step=10)
        with pytest.raises(kvstore_ps.StaleWorkerError) as err:
            b.push_array("w", np.full(4, 9.0, np.float32), step=3)
        assert err.value.max_step == 10
        np.testing.assert_array_equal(a.pull_array("w"),
                                      np.ones(4, np.float32))
        b.push_array("w", np.full(4, 5.0, np.float32), step=9)
        np.testing.assert_array_equal(a.pull_array("w"),
                                      np.full(4, 5.0, np.float32))
    finally:
        a.close()
        b.close()
        server.stop()
    server2 = kvstore_ps.PSServer(port=0, num_workers=2)
    c = kvstore_ps.PSClient("127.0.0.1", server2.port, rank=0)
    try:
        c.init_array("w", np.zeros(4, np.float32))
        c.push_array("w", np.ones(4, np.float32), step=10)
        c.push_array("w", np.full(4, 9.0, np.float32), step=3)
        np.testing.assert_array_equal(c.pull_array("w"),
                                      np.full(4, 9.0, np.float32))
    finally:
        c.close()
        server2.stop()


def _ps_store(client, threshold=None):
    """A port KVStore riding ``client`` (as a dist_async store does)."""
    kv = mx.kv.KVStore("local")
    kv._ps_client = client
    kv._push_step = 0
    if threshold is not None:
        kv.set_gradient_compression({"threshold": threshold})
    return kv


def test_ps_2bit_push_carries_step_through_staleness_gate():
    server = kvstore_ps.PSServer(port=0, num_workers=2, max_staleness=2)
    fleet = kvstore_ps.PSClient("127.0.0.1", server.port, rank=0)
    lag = kvstore_ps.PSClient("127.0.0.1", server.port, rank=1)
    try:
        with mx.cpu():
            kv = _ps_store(lag, 0.5)
            kv.init("w", mx.nd.zeros((4,)))
            fleet.push_array("w", np.ones(4, np.float32), step=10)
            kv.push("w", mx.nd.array(np.full(4, 2.0, np.float32)))
        assert kv._push_step == 10
        assert server.monitor.step_of(1) == 10
        np.testing.assert_array_equal(lag.pull_array("w"),
                                      np.full(4, 0.5, np.float32))
    finally:
        fleet.close()
        lag.close()
        server.stop()


# ---------------------------------------------------------------------------
# reconnects, chunks, barrier, chaos
# ---------------------------------------------------------------------------
def test_ps_client_reconnects_with_backoff():
    server = kvstore_ps.PSServer(port=0, num_workers=1)
    cli = kvstore_ps.PSClient("127.0.0.1", server.port, rank=0)
    try:
        cli.init_array("k", np.arange(4, dtype=np.float32))
        cli._sock.close()
        np.testing.assert_array_equal(cli.pull_array("k"),
                                      np.arange(4, dtype=np.float32))
        assert cli.reconnects >= 1
    finally:
        cli.close()
        server.stop()


def test_ps_chunked_push_restarts_after_reconnect(monkeypatch):
    monkeypatch.setattr(kvstore_ps, "BIGARRAY_BOUND", 4)
    server = kvstore_ps.PSServer(port=0, num_workers=1)
    cli = kvstore_ps.PSClient("127.0.0.1", server.port, rank=0)
    try:
        value = np.arange(1, 11, dtype=np.float32)
        cli.init_array("k", np.zeros(10, np.float32))
        orig, calls = cli.request, {"push_chunk": 0}

        def flaky(*msg):
            if msg[0] == "push_chunk":
                calls["push_chunk"] += 1
                if calls["push_chunk"] == 2:
                    cli._sock.close()
            return orig(*msg)
        cli.request = flaky
        cli.push_array("k", value)
        assert cli.reconnects == 1
        assert calls["push_chunk"] > 3
        np.testing.assert_array_equal(cli.pull_array("k"), value)
    finally:
        cli.close()
        server.stop()


def test_ps_server_refuses_orphaned_push_chunk_tail():
    server = kvstore_ps.PSServer(port=0, num_workers=1)
    try:
        server._handle(("init", "k", np.zeros(8, np.float32)))
        reply = server._handle(
            ("push_chunk", "k", (8,), 4, 8, np.ones(4, np.float32), True,
             None), _ctx(0))
        assert reply[0] == "err" and "staged prefix" in reply[1]
        np.testing.assert_array_equal(server._store["k"],
                                      np.zeros(8, np.float32))
    finally:
        server.stop()


def test_ps_barrier_is_not_retried_across_reconnect():
    server = kvstore_ps.PSServer(port=0, num_workers=2)
    cli = kvstore_ps.PSClient("127.0.0.1", server.port, rank=0)
    try:
        cli._sock.close()
        with pytest.raises((OSError, ConnectionError)):
            cli.request("barrier")
        assert cli.reconnects == 0
        assert server._barrier_count == 0
        assert cli.request("num_dead")[0] == "ok"
        assert cli.reconnects == 1
    finally:
        cli.close()
        server.stop()


def test_chaos_drops_kvstore_rpc():
    server = kvstore_ps.PSServer(port=0, num_workers=1)
    cli = kvstore_ps.PSClient("127.0.0.1", server.port, rank=0)
    try:
        cli.init_array("k", np.zeros(2, np.float32))
        chaos.install([Fault("kvstore.request", 2, "raise")])
        cli.push_array("k", np.ones(2, np.float32))
        with pytest.raises(chaos.ChaosError):
            cli.push_array("k", np.full(2, 7.0, np.float32))
        np.testing.assert_array_equal(cli.pull_array("k"),
                                      np.ones(2, np.float32))
    finally:
        chaos.uninstall()
        cli.close()
        server.stop()


def test_chaos_server_sites_deterministic_and_bite():
    from mxnet_tpu.resilience import ChaosSchedule as RefSchedule
    sites = ["kvstore.server_apply", "kvstore.snapshot"]
    s1 = ChaosSchedule.seeded(17, sites, n_faults=4, max_at=20)
    assert s1.specs() == ChaosSchedule.seeded(17, sites, n_faults=4,
                                              max_at=20).specs()
    # the reference's draw, fault for fault
    assert s1.specs() == RefSchedule.seeded(17, sites, n_faults=4,
                                            max_at=20).specs()
    srv = kvstore_ps.PSServer(port=0)
    ctx = _ctx(rank=0)
    try:
        srv._handle(("init", "w", np.zeros(2, np.float32)), ctx)
        chaos.install([Fault("kvstore.server_apply", 2, "raise")])
        srv._handle(("push", "w", "dense", np.ones(2, np.float32), 1), ctx)
        before = srv._store["w"].tobytes()
        with pytest.raises(chaos.ChaosError):
            srv._handle(("push", "w", "dense",
                         np.full(2, 9.0, np.float32), 2), ctx)
        assert srv._store["w"].tobytes() == before
        assert srv._applied[0]["w"] == 1
    finally:
        chaos.uninstall()
        srv.stop()


def test_chaos_snapshot_site_fails_clean(tmp_path):
    d = str(tmp_path)
    srv = kvstore_ps.PSServer(port=0, state_dir=d)
    ctx = _ctx(rank=0)
    srv._handle(("init", "w", np.zeros(2, np.float32)), ctx)
    srv._handle(("push", "w", "dense", np.ones(2, np.float32), 1), ctx)
    chaos.install([Fault("kvstore.snapshot", 1, "raise")])
    with pytest.raises(chaos.ChaosError):
        srv.save_snapshot()
    chaos.uninstall()
    assert not ckpt.list_checkpoints(d)
    srv.stop()
    srv2 = kvstore_ps.PSServer(port=0, state_dir=d)
    np.testing.assert_array_equal(srv2._store["w"], np.ones(2, np.float32))
    srv2.stop()


def test_chaos_env_schedule_arms_only_in_the_first_incarnation(
        monkeypatch, tmp_path):
    # install_from_env arms whatever the env holds (the reference's)...
    monkeypatch.setenv("MXTPU_CHAOS", "kvstore.server_apply:13:kill")
    sched = chaos.install_from_env()
    chaos.uninstall()
    assert sched.specs() == [("kvstore.server_apply", 13, "kill", None)]
    # ...and the launcher leaves MXTPU_CHAOS out of a respawned rank's env
    # (given through --env or inherited alike): the rank below fails while
    # it holds a schedule, and its one respawn sees none
    from mxnet_tpu_torch.tools import launch
    seen = tmp_path / "seen"
    code = ("import os, sys; c = os.environ.get('MXTPU_CHAOS', '-'); "
            "open(%r, 'a').write(c + '\\n'); sys.exit(c != '-')"
            % str(seen))
    for given in (["--env", "MXTPU_CHAOS=trainer.step:1:kill"], []):
        seen.write_text("")
        with pytest.raises(SystemExit) as done:
            launch.main(["-n", "1", "--launcher", "local",
                         "--restart-failed", "1"] + given
                        + [sys.executable, "-c", code])
        assert done.value.code == 0
        first = "trainer.step:1:kill" if given \
            else "kvstore.server_apply:13:kill"
        assert seen.read_text().split() == [first, "-"]


# ---------------------------------------------------------------------------
# snapshot + WAL recovery (tests/test_ps_recovery.py:73-306)
# ---------------------------------------------------------------------------
def test_server_recovers_snapshot_plus_wal_bitwise(tmp_path):
    d = str(tmp_path)
    srv = kvstore_ps.PSServer(port=0, state_dir=d, snapshot_every=3)
    ctx = _ctx(rank=0)
    srv._handle(("set_optimizer", _sgd_blob()), ctx)
    srv._handle(("init", "w", np.zeros(4, np.float32)), ctx)
    srv._handle(("init", "v", np.ones(2, np.float32)), ctx)
    for step in range(1, 6):
        srv._handle(("push", "w", "dense",
                     np.full(4, 0.1 * step, np.float32), step), ctx)
    srv.monitor.note_step(0, 5)
    srv._join_snapshot_thread()
    blob_w = srv._store["w"].tobytes()
    blob_v = srv._store["v"].tobytes()
    mom = srv._updater.states["w"].numpy().copy()
    srv.stop()
    srv2 = kvstore_ps.PSServer(port=0, state_dir=d)
    try:
        assert srv2.generation == srv.generation + 1
        assert srv2.recovered_wal_records >= 1
        assert srv2._store["w"].tobytes() == blob_w
        assert srv2._store["v"].tobytes() == blob_v
        np.testing.assert_array_equal(
            np.asarray(srv2._updater.states["w"]), mom)
        assert srv2.key_owner("w") == 0
        assert srv2.monitor.step_of(0) == 5
        assert srv2._applied[0]["w"] == 5
        srv2._handle(("push", "w", "dense", np.ones(4, np.float32), 6),
                     _ctx(0))
        np.testing.assert_allclose(
            srv2._store["w"],
            np.frombuffer(blob_w, np.float32) + 0.9 * mom - 0.1, atol=TOL)
    finally:
        srv2.stop()


def test_wal_replay_idempotent_and_dedups_retries(tmp_path):
    d = str(tmp_path)
    srv = kvstore_ps.PSServer(port=0, state_dir=d)
    ctx = _ctx(rank=0)
    srv._handle(("set_optimizer", _sgd_blob()), ctx)
    srv._handle(("init", "w", np.zeros(4, np.float32)), ctx)
    g = np.ones(4, np.float32)
    srv._handle(("push", "w", "dense", g, 1), ctx)
    srv._handle(("push", "w", "dense", g, 2), ctx)
    blob = srv._store["w"].tobytes()
    srv.stop()
    srv2 = kvstore_ps.PSServer(port=0, state_dir=d)
    try:
        assert srv2.recovered_wal_records == 4
        assert srv2._store["w"].tobytes() == blob
        srv2._replay_record(("push", 0, 2, "w", g))
        assert srv2._store["w"].tobytes() == blob
        assert srv2._handle(("push", "w", "dense", g, 2),
                            _ctx(0)) == ("ok",)
        assert srv2._store["w"].tobytes() == blob
        srv2._note_incarnation(0, "respawned-worker")
        srv2._handle(("push", "w", "dense", g, 1), _ctx(0))
        assert srv2._store["w"].tobytes() != blob
    finally:
        srv2.stop()


def test_snapshot_pruning_honors_keep(tmp_path):
    from mxnet_tpu_torch.resilience.server_state import _WAL_RE
    d = str(tmp_path)
    srv = kvstore_ps.PSServer(port=0, state_dir=d, snapshot_keep=2)
    ctx = _ctx(rank=0)
    srv._handle(("init", "w", np.zeros(4, np.float32)), ctx)
    for step in range(1, 6):
        srv._handle(("push", "w", "dense",
                     np.full(4, float(step), np.float32), step), ctx)
        srv.save_snapshot()
    snaps = ckpt.list_checkpoints(d)
    assert len(snaps) == 2
    assert not [n for n in os.listdir(d) if ".tmp." in n]
    wal_bases = sorted(int(_WAL_RE.match(n).group(1))
                       for n in os.listdir(d) if _WAL_RE.match(n))
    assert wal_bases and wal_bases[0] >= snaps[0][0]
    srv.stop()
    srv2 = kvstore_ps.PSServer(port=0, state_dir=d)
    np.testing.assert_array_equal(srv2._store["w"],
                                  np.full(4, 5.0, np.float32))
    srv2.stop()


def test_generation_bumps_and_client_detects_failover(tmp_path):
    d = str(tmp_path)
    srv = kvstore_ps.PSServer(port=0, state_dir=d)
    assert srv.generation == 1
    port = srv.port
    cli = kvstore_ps.PSClient("127.0.0.1", port, rank=0)
    try:
        assert cli.server_generation == 1
        cli.init_array("k", np.arange(4, dtype=np.float32))
        srv.stop(final_snapshot=True)
        assert ckpt.list_checkpoints(d)
        srv2 = kvstore_ps.PSServer(port=port, state_dir=d)
        try:
            assert srv2.generation == 2
            np.testing.assert_array_equal(
                cli.pull_array("k"), np.arange(4, dtype=np.float32))
            assert cli.reconnects >= 1
            assert cli.failovers == 1
            assert cli.server_generation == 2
        finally:
            srv2.stop()
    finally:
        cli.close()


def test_server_failover_mid_chunked_push_generation_restart(tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(kvstore_ps, "BIGARRAY_BOUND", 4)
    d = str(tmp_path)
    srv_box = [kvstore_ps.PSServer(port=0, state_dir=d)]
    port = srv_box[0].port
    cli = kvstore_ps.PSClient("127.0.0.1", port, rank=0)
    try:
        cli.init_array("k", np.zeros(10, np.float32))
        value = np.arange(1, 11, dtype=np.float32)
        orig, calls = cli.request, {"n": 0}

        def flaky(*msg):
            if msg[0] == "push_chunk":
                calls["n"] += 1
                if calls["n"] == 2:
                    srv_box[0].stop()
                    srv_box[0] = kvstore_ps.PSServer(port=port, state_dir=d)
                    sock = socket.create_connection(("127.0.0.1", port),
                                                    timeout=10)
                    kvstore_ps._send(sock, ("hello", 0, cli._incarnation))
                    assert kvstore_ps._recv(sock)[0] == "ok"
                    old, cli._sock = cli._sock, sock
                    old.close()
            return orig(*msg)
        cli.request = flaky
        cli.push_array("k", value)
        assert cli.reconnects == 0
        assert cli.failovers == 1
        assert calls["n"] > 3
        np.testing.assert_array_equal(cli.pull_array("k"), value)
    finally:
        cli.close()
        srv_box[0].stop()


def test_compression_residuals_survive_server_failover(tmp_path):
    d = str(tmp_path)
    srv = kvstore_ps.PSServer(port=0, state_dir=d, snapshot_every=1)
    port = srv.port
    kv = _ps_store(kvstore_ps.PSClient("127.0.0.1", port, rank=0), 0.5)
    try:
        with mx.cpu():
            kv.init("w", mx.nd.zeros((4,)))
            kv.push("w", mx.nd.array(np.array([0.3, 0.6, -0.7, 0.1],
                                              np.float32)))
            np.testing.assert_allclose(kv._residuals["w"].numpy(),
                                       [0.3, 0.1, -0.2, 0.1], atol=TOL)
            srv._join_snapshot_thread()
            srv.stop()
            srv2 = kvstore_ps.PSServer(port=port, state_dir=d)
            try:
                kv.push("w", mx.nd.array(np.array([0.3, 0.0, 0.0, 0.5],
                                                  np.float32)))
                assert kv._ps_client.reconnects >= 1
                assert kv._ps_client.failovers == 1
                np.testing.assert_allclose(kv._residuals["w"].numpy(),
                                           [0.1, 0.1, -0.2, 0.1], atol=TOL)
                np.testing.assert_array_equal(
                    kv._ps_client.pull_array("w"),
                    np.array([0.5, 0.0, 0.0, 0.5], np.float32))
            finally:
                srv2.stop()
    finally:
        kv._ps_client.close()


def test_bigarray_chunked_push_pull_and_abandoned_init(monkeypatch):
    monkeypatch.setattr(kvstore_ps, "BIGARRAY_BOUND", 1000)
    server = kvstore_ps.PSServer(port=0, num_workers=1)
    client = kvstore_ps.PSClient("127.0.0.1", server.port, rank=0)
    try:
        big = np.arange(5003, dtype=np.float32)
        client.request("init", "big", np.zeros_like(big))
        client.push_array("big", big)
        np.testing.assert_array_equal(client.pull_array("big"), big)
        # a claim of a dying client is released with its connection
        dying = kvstore_ps.PSClient("127.0.0.1", server.port, rank=1)
        assert dying.request("init_meta", "k2", (5003,))[1] is True
        dying.close()
        assert _wait(lambda: "k2" not in server._pending_init, 5)
        client.init_array("k2", big)
        np.testing.assert_array_equal(client.pull_array("k2"), big)
    finally:
        client.close()
        server.stop()


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------
def test_pack_2bit_matches_reference():
    rng = np.random.RandomState(0)
    vals = rng.choice([0.5, -0.5, 0.0], size=37).astype(np.float32)
    packed, shape = kvstore_ps.pack_2bit(vals, 0.5)
    rpacked, rshape = ref_ps.pack_2bit(vals, 0.5)
    assert packed.dtype == np.uint8 and packed.size == 10
    assert packed.tobytes() == rpacked.tobytes() and shape == rshape
    np.testing.assert_array_equal(kvstore_ps.unpack_2bit(packed, shape, 0.5),
                                  vals)


def _pushes(rng, n=16):
    """The push sequence of the cross-package cases: (form, payload)."""
    out = []
    for i in range(6):
        form = ("dense", "rsp", "2bit")[i % 3]
        if form == "dense":
            out.append((form, rng.randn(n).astype(np.float32)))
        elif form == "rsp":
            idx = np.sort(rng.choice(n, 5, replace=False)).astype(np.int64)
            out.append((form, (idx, rng.randn(5).astype(np.float32), (n,))))
        else:
            q = rng.choice([0.5, -0.5, 0.0], size=n).astype(np.float32)
            packed, shape = kvstore_ps.pack_2bit(q, 0.5)
            out.append((form, (packed, shape, 0.5)))
    return out


def _drive(cli, n=16, seed=0):
    """Init ``w`` densely and ``c`` chunked, then the push sequence with
    steps; returns both keys' pulled bytes after each push."""
    rng = np.random.RandomState(seed)
    cli.init_array("w", rng.randn(n).astype(np.float32))
    cli.init_array("c", rng.randn(10).astype(np.float32))
    seen = []
    for step, (form, payload) in enumerate(_pushes(rng, n), start=1):
        cli.request("push", "w", form, payload, step)
        cli.push_array("c", rng.randn(10).astype(np.float32), step=step)
        seen.append(cli.pull_array("w").tobytes()
                    + cli.pull_array("c").tobytes())
    return seen


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "ref"), ("ref", "port")])
def test_clients_and_servers_interoperate_bitwise(client_pkg, server_pkg,
                                                  monkeypatch):
    """Dense, chunked (BIGARRAY_BOUND 4), rsp and 2bit payloads, one
    package's client against the other's server, land the bytes a
    reference client and server land."""
    for mod in PKGS.values():
        monkeypatch.setattr(mod, "BIGARRAY_BOUND", 4)
    want = None
    for c, s in (("ref", "ref"), (client_pkg, server_pkg)):
        srv = PKGS[s].PSServer(port=0)
        cli = PKGS[c].PSClient("127.0.0.1", srv.port, rank=0)
        try:
            got = _drive(cli)
        finally:
            cli.close()
            srv.stop()
        if want is None:
            want = got
    assert got == want


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
@pytest.mark.parametrize("snapshot", [True, False])
def test_state_dir_crosses_packages_bitwise(tmp_path, writer, reader,
                                            snapshot):
    """A state dir with no optimizer, written by one package's server
    (snapshot + WAL tail, or WAL alone), is recovered by the other's to
    the same store bytes, ownership, dedup marks and step clocks."""
    d = str(tmp_path)
    srv = PKGS[writer].PSServer(port=0, state_dir=d,
                                snapshot_every=4 if snapshot else None)
    rng = np.random.RandomState(1)
    ctx = _ctx(rank=0)
    srv._handle(("init", "w", rng.randn(16).astype(np.float32)), ctx)
    srv._handle(("init", "v", rng.randn(3).astype(np.float32)), _ctx(1))
    for step, (form, payload) in enumerate(_pushes(rng), start=1):
        srv._handle(("push", "w", form, payload, step), ctx)
    srv._join_snapshot_thread()
    assert bool(ckpt.list_checkpoints(d)) == snapshot
    store = {k: v.tobytes() for k, v in srv._store.items()}
    applied, gen = dict(srv._applied), srv.generation
    srv.stop()
    srv2 = PKGS[reader].PSServer(port=0, state_dir=d)
    try:
        assert srv2.generation == gen + 1
        assert {k: v.tobytes() for k, v in srv2._store.items()} == store
        assert srv2._applied == applied
        assert srv2.key_owner("w") == 0 and srv2.key_owner("v") == 1
        assert srv2.monitor.step_of(0) == 6
    finally:
        srv2.stop()


def test_optimizer_servers_of_both_packages_agree():
    """SGD + momentum on both packages' servers, fed the same pushes:
    stored weights and momentum within 1e-6."""
    rng = np.random.RandomState(2)
    w0 = rng.randn(32).astype(np.float32)
    grads = [rng.randn(32).astype(np.float32) for _ in range(8)]
    out = {}
    for name, pkg, optmod in (("port", kvstore_ps, opt),
                              ("ref", ref_ps, ref_opt)):
        srv = pkg.PSServer(port=0)
        try:
            blob = pickle.dumps(optmod.create("sgd", learning_rate=0.1,
                                              momentum=0.9, wd=1e-3))
            srv._handle(("set_optimizer", blob), _ctx(0))
            srv._handle(("init", "w", w0), _ctx(0))
            for step, g in enumerate(grads, start=1):
                srv._handle(("push", "w", "dense", g, step), _ctx(0))
            state = srv._updater.states["w"]
            out[name] = (srv._store["w"].copy(),
                         np.asarray(getattr(state, "_data", state)))
        finally:
            srv.stop()
    np.testing.assert_allclose(out["port"][0], out["ref"][0], atol=TOL)
    np.testing.assert_allclose(out["port"][1], out["ref"][1], atol=TOL)


def test_ps_metrics_gauges_on_the_registry():
    from mxnet_tpu_torch import telemetry
    srv = kvstore_ps.PSServer(port=0)
    try:
        srv._handle(("init", "w", np.zeros(2, np.float32)), _ctx(0))
        srv._handle(("push", "w", "dense", np.ones(2, np.float32), 3),
                    _ctx(0))
        text = telemetry.registry().prometheus_text()
        assert "mxtpu_ps_generation" in text
        assert "mxtpu_ps_fleet_max_step 3" in text
    finally:
        srv.stop()


def test_trace_context_rides_the_wire_between_packages():
    """A reference client's ("tctx", ...) envelope is installed by the
    port's server while it handles the message, and the port's client
    inside a span sends one the reference server reads."""
    from mxnet_tpu.telemetry import trace as ref_trace
    from mxnet_tpu_torch.telemetry import trace
    srv = kvstore_ps.PSServer(port=0)
    seen = []
    orig = srv._handle

    def spy(msg, ctx=None):
        cur = trace.current()
        seen.append(None if cur is None else cur.trace_id)
        return orig(msg, ctx)
    srv._handle = spy
    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    try:
        wire = ref_trace.to_wire(ref_trace.SpanContext(rank=0))
        ref_ps._send(sock, ("tctx", wire, ("init", "w",
                                           np.zeros(2, np.float32))))
        assert ref_ps._recv(sock) == ("ok",)
        assert seen == [wire[1]]
    finally:
        sock.close()
        srv.stop()
    rsrv = ref_ps.PSServer(port=0)
    cli = kvstore_ps.PSClient("127.0.0.1", rsrv.port, rank=0)
    try:
        with trace.span("step", rank=0) as ctx:
            cli.init_array("w", np.ones(2, np.float32))
        assert trace.from_wire(trace.to_wire(ctx)).trace_id == ctx.trace_id
        np.testing.assert_array_equal(cli.pull_array("w"),
                                      np.ones(2, np.float32))
    finally:
        cli.close()
        rsrv.stop()
