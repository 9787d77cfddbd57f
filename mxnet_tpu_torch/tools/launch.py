"""Distributed job launcher: the port of ``tools/launch.py`` (reference:
MXNet's tools/launch.py over the dmlc tracker).

``python -m mxnet_tpu_torch.tools.launch -n N [-s 1] --launcher
local|ssh|echo COMMAND ...`` spawns N worker processes (and, with ``-s
1``, one ``DMLC_ROLE=server`` process hosting the parameter server), each
with the env a ``dist_*`` kvstore reads: ``torch.distributed``'s
``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``, the reference's ``DMLC_*`` names
and the PS port ``MXTPU_PS_PORT``.

- ``--launcher local`` runs every rank here; ``ssh`` runs rank r on line
  ``r % len(hosts)`` of ``-H``'s hostfile, the env exported on the
  remote command line and the cwd kept; ``echo`` prints each rank's env.
- ``--restart-failed N``: a rank that exits non-zero is relaunched (same
  rank, same env) up to N times, after delays from the port's
  ``resilience/backoff.py`` policy.  A respawn's env lacks
  ``MXTPU_CHAOS``, so an injected fault fires once in the fleet's run,
  not again in every respawn.
- ``-s 1`` with ``--ps-state-dir`` (``MXTPU_PS_STATE_DIR``): the server
  rank recovers from snapshot + WAL when ``--restart-failed`` respawns
  it; once every worker has exited it is drained with SIGTERM, which
  flushes a final snapshot.
- ``--env K=V`` reaches every rank, ``--env-server K=V`` the server
  rank only.  With every rank on this host, ``GLOO_SOCKET_IFNAME`` and
  ``NCCL_SOCKET_IFNAME`` default to the loopback interface.
- ``--metrics-json`` writes per-rank restarts and exit codes and the
  wall time in the metrics registry's JSON schema.
- ``--telemetry-dir`` (fleet flight rings) is ROADMAP.md queue A, item
  A12, and raises.

The launcher imports neither torch nor the JAX package: it loads the
port's stdlib-only ``backoff.py`` and ``metrics.py`` by path.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import shlex
import socket
import subprocess
import sys
import time


def _load_by_path(name, *rel):
    """Load a module of the port by file path, so the launcher never
    imports torch (it forks workers)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), *rel)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_backoff():
    """The shared BackoffPolicy (resilience/backoff.py, stdlib-only)."""
    return _load_by_path("_mxtt_backoff", "resilience", "backoff.py")


def _load_metrics():
    """The metrics registry (telemetry/metrics.py, stdlib-only): the
    launcher dumps its numbers in the JSON schema the trainer does."""
    return _load_by_path("_mxtt_metrics", "telemetry", "metrics.py")


def free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_LOCAL_HOSTS = {"localhost", "127.0.0.1", "::1"}


def read_hostfile(path):
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                hosts.append(line.split()[0])  # "host [slots]" — host only
    if not hosts:
        raise SystemExit("hostfile %r lists no hosts" % path)
    return hosts


def routable_ip(remote_hosts=()):
    """An IP of this machine that other hosts can dial, found with the
    UDP-connect trick: ``connect()`` on a datagram socket sends nothing,
    but ``getsockname()`` reveals the source address the kernel routes
    through toward the peer (the dmlc ssh tracker advertises the
    tracker's routable IP the same way).  Returns None when no
    non-loopback route exists (air-gapped/misconfigured host)."""
    probes = [h for h in remote_hosts if h not in _LOCAL_HOSTS]
    probes.append("8.8.8.8")  # any public IP routes; no packet is sent
    for host in probes:
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                s.connect((host, 53))
                ip = s.getsockname()[0]
            finally:
                s.close()
        except OSError:
            continue
        if not ip.startswith("127."):
            return ip
    return None


def coordinator_address(hosts):
    """host:port for the process group's rendezvous (and the rank-0 PS).

    Rank 0 — the process that BINDS the coordinator — runs on hosts[0],
    so that is the address every rank must dial, not the launcher's.
    Three cases:

    - all hosts local: 127.0.0.1 with a locally probed free port;
    - hosts[0] local but the hostfile mixes in remote hosts: 127.0.0.1
      would make every remote rank dial ITSELF, so a routable address of
      this machine is advertised (UDP-connect trick); if none can be
      determined the launch errors out rather than silently wedging —
      pass --coordinator explicitly then;
    - hosts[0] remote: no local probe is possible, so a high random port
      on hosts[0] is used (collisions are rare; pin with --coordinator)."""
    remote = [h for h in hosts if h not in _LOCAL_HOSTS]
    if hosts[0] in _LOCAL_HOSTS:
        if not remote:
            return "127.0.0.1:%d" % free_port()
        ip = routable_ip(remote)
        if ip is None:
            raise SystemExit(
                "hostfile mixes localhost with remote hosts but no "
                "routable address for this machine could be determined; "
                "pass --coordinator HOST:PORT explicitly")
        return "%s:%d" % (ip, free_port())
    import random
    return "%s:%d" % (hosts[0], random.randint(20000, 59999))


def local_ranks(hosts, n):
    """``(local_rank, local_world_size)`` of each of ``n`` ranks placed
    round-robin over ``hosts``."""
    placed = [hosts[r % len(hosts)] for r in range(n)]
    return [(placed[:r].count(h), placed.count(h))
            for r, h in enumerate(placed)]


def worker_env(coordinator, n, rank, ps_port, num_servers=0,
               local=None):
    """The per-rank env handshake (shared by every launcher)."""
    addr, port = coordinator.rsplit(":", 1)
    local_rank, local_world = local if local is not None else (rank, n)
    return {
        # torch.distributed's env rendezvous names
        "MASTER_ADDR": addr,
        "MASTER_PORT": port,
        "RANK": str(rank),
        "WORLD_SIZE": str(n),
        "LOCAL_RANK": str(local_rank),
        "LOCAL_WORLD_SIZE": str(local_world),
        # reference-compatible names (kvstore scripts read these)
        "DMLC_ROLE": "worker",
        "DMLC_NUM_WORKER": str(n),
        "DMLC_WORKER_ID": str(rank),
        # DMLC_NUM_SERVER > 0 tells workers a dedicated PS rank exists,
        # so rank 0 must NOT also bind the port with an embedded server
        "DMLC_NUM_SERVER": str(num_servers),
        # async parameter server address (kvstore dist_async)
        "DMLC_PS_ROOT_URI": addr,
        "MXTPU_PS_PORT": str(ps_port),
    }


def server_env(n, ps_port, state_dir):
    """The dedicated PS rank's env: the same command is spawned with
    DMLC_ROLE=server (the reference tracker's convention) and the
    program's `_init_kvstore_server_module()` hosts the elastic PS.
    The state dir arms snapshot+WAL crash recovery, which is what makes
    `--restart-failed` respawns of this rank a *recovery*, not a wipe."""
    env = {
        "DMLC_ROLE": "server",
        "DMLC_NUM_WORKER": str(n),
        "DMLC_NUM_SERVER": "1",
        "MXTPU_PS_PORT": str(ps_port),
    }
    if state_dir:
        env["MXTPU_PS_STATE_DIR"] = state_dir
    return env


def ssh_command(host, env, command, cwd):
    """One rank's ssh invocation: env exported on the remote command line
    (a remote shell inherits nothing), cwd preserved, command exec'd —
    the dmlc ssh tracker's contract (dmlc_tracker/ssh.py)."""
    exports = "".join("export %s=%s; " % (k, shlex.quote(str(v)))
                      for k, v in sorted(env.items()))
    # `cd || exit`: a missing remote cwd must kill the rank, not silently
    # run the worker from $HOME with wrong relative paths
    remote = "cd %s || exit 1; %sexec %s" % (
        shlex.quote(cwd), exports,
        " ".join(shlex.quote(c) for c in command))
    return ["ssh", "-o", "StrictHostKeyChecking=no",
            "-o", "PasswordAuthentication=no", host, remote]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Launch a distributed training job")
    parser.add_argument("-n", "--num-workers", type=int, required=True)
    parser.add_argument("-s", "--num-servers", type=int, default=0,
                        choices=[0, 1],
                        help="spawn a dedicated DMLC_ROLE=server rank "
                             "hosting the elastic PS (one host server; "
                             "the reference CLI's -s).  0 = rank 0 "
                             "embeds the PS (default)")
    parser.add_argument("--ps-state-dir", default=None,
                        help="server snapshot+WAL directory "
                             "(MXTPU_PS_STATE_DIR); with --num-servers "
                             "and --restart-failed a respawned server "
                             "RECOVERS from it.  Default: a fresh "
                             "mxtpu_ps_state tmpdir when a server rank "
                             "is spawned")
    parser.add_argument("--launcher", default="local",
                        choices=["local", "ssh", "echo"])
    parser.add_argument("-H", "--hostfile", default=None,
                        help="one host per line (ssh launcher); every "
                             "rank runs on localhost when omitted")
    parser.add_argument("--coordinator", default=None,
                        help="override the rendezvous host:port all "
                             "ranks connect to")
    parser.add_argument("--ps-port", type=int, default=None,
                        help="pin the rank-0 parameter-server port "
                             "(dist_async); by default a free port is "
                             "probed locally, or a high random port is "
                             "picked when rank 0 runs on a remote host "
                             "(where no probe is possible)")
    parser.add_argument("--restart-failed", type=int, default=0,
                        help="elastic restarts: relaunch a rank that "
                             "exits non-zero up to N times (same rank "
                             "id/env, exponential backoff with jitter); "
                             "0 = fail fast (default)")
    parser.add_argument("--env", action="append", default=[],
                        help="extra K=V forwarded to every worker "
                             "(reference launch.py --env)")
    parser.add_argument("--metrics-json", default=None,
                        help="write the launcher's fleet-supervision "
                             "metrics (per-rank restarts/exit codes, "
                             "wall time) as versioned telemetry JSON "
                             "on exit — the schema tools/parse_log.py "
                             "reads")
    parser.add_argument("--telemetry-dir", default=None,
                        help="fleet flight rings and metrics dumps: "
                             "ROADMAP.md queue A, item A12 (raises)")
    parser.add_argument("--env-server", action="append", default=[],
                        help="extra K=V forwarded to the server rank only")
    parser.add_argument("command", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if not args.command:
        parser.error("no command given")
    if args.telemetry_dir:
        raise NotImplementedError(
            "--telemetry-dir arms the fleet flight recorder: ROADMAP.md "
            "queue A, item A12")

    hosts = (read_hostfile(args.hostfile) if args.hostfile
             else ["localhost"] * args.num_workers)
    if args.coordinator:
        coordinator = args.coordinator
    elif args.launcher == "ssh":
        coordinator = coordinator_address(hosts)
    else:
        coordinator = "127.0.0.1:%d" % free_port()
    # the PS binds on rank 0's host (the rendezvous host, kvstore.py):
    # a port probed free HERE proves nothing about a remote rank 0, so
    # mirror coordinator_address — probe locally, random remotely,
    # --ps-port to pin
    if args.ps_port is not None:
        ps_port = args.ps_port
    elif hosts[0] in _LOCAL_HOSTS:
        ps_port = free_port()
    else:
        import random
        ps_port = random.randint(20000, 59999)
    for kv in args.env:
        if "=" not in kv:
            parser.error("--env expects K=V, got %r" % kv)
    for kv in args.env_server:
        if "=" not in kv:
            parser.error("--env-server expects K=V, got %r" % kv)
    extra = dict(kv.split("=", 1) for kv in args.env)
    extra_server = dict(kv.split("=", 1) for kv in args.env_server)
    if all(h in _LOCAL_HOSTS for h in hosts):
        # every rank on this host: gloo's and NCCL's sockets stay on the
        # loopback interface (unless the caller names one)
        for k in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
            if k not in os.environ:
                extra.setdefault(k, "lo")
    locals_ = local_ranks(hosts, args.num_workers)
    if args.num_servers and not args.ps_state_dir:
        # recovery must be armed by default: a respawned server with no
        # state dir would come back EMPTY and wedge every worker
        import tempfile
        args.ps_state_dir = tempfile.mkdtemp(prefix="mxtpu_ps_state_")
        print("launch: server state dir %s (pass --ps-state-dir to pin)"
              % args.ps_state_dir, file=sys.stderr)

    def rank_env(rank):
        """rank is an int worker id or the string 'server'."""
        if rank == "server":
            renv = server_env(args.num_workers, ps_port, args.ps_state_dir)
        else:
            renv = worker_env(coordinator, args.num_workers, rank, ps_port,
                              args.num_servers, locals_[rank])
        renv.update(extra)
        if rank == "server":
            renv.update(extra_server)
        return renv

    all_ranks = (["server"] if args.num_servers else []) \
        + list(range(args.num_workers))

    if args.launcher == "echo":
        for rank in all_ranks:
            env = rank_env(rank)
            print("%s %s" % (" ".join("%s=%s" % kv
                                      for kv in sorted(env.items())),
                             " ".join(args.command)))
        return

    def spawn(rank):
        renv = rank_env(rank)
        # a respawn runs without the first incarnation's fault schedule
        respawn = attempts.get(rank, 0) > 0
        if respawn:
            renv.pop("MXTPU_CHAOS", None)
        if args.launcher == "ssh":
            # remote shells inherit nothing: forward the runtime-relevant
            # locals alongside the handshake (the dmlc tracker forwards
            # its env lists the same way).  The server rank runs on the
            # PS host — hosts[0], where the port was probed.
            for k in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES"):
                if k in os.environ and k not in renv:
                    renv[k] = os.environ[k]
            host = hosts[0] if rank == "server" else hosts[rank % len(hosts)]
            cmd = ssh_command(host, renv, args.command, os.getcwd())
            return subprocess.Popen(cmd)
        env = dict(os.environ)
        env.update(renv)
        if respawn:
            env.pop("MXTPU_CHAOS", None)
        return subprocess.Popen(args.command, env=env)

    t_launch = time.monotonic()
    attempts = {rank: 0 for rank in all_ranks}
    running = {rank: spawn(rank) for rank in all_ranks}
    budgets = {rank: args.restart_failed for rank in all_ranks}
    exit_codes = {}                    # rank -> last observed exit code
    policy = _load_backoff().BackoffPolicy(
        base_s=1.0, factor=2.0, max_delay_s=30.0,
        max_retries=max(args.restart_failed, 1), jitter=0.25)
    rc = 0
    # bounded poll loop (not a bare wait): crashed ranks are noticed and
    # — with --restart-failed — relaunched while the rest keep running,
    # which is what lets the elastic PS tier exercise worker rejoin.
    # Backoff is a per-rank respawn DEADLINE, not an inline sleep: a
    # correlated multi-rank crash must not serialize restarts or stall
    # polling of the ranks still running.
    respawn_at = {}                    # rank -> monotonic deadline
    server_draining = False
    while running or respawn_at:
        time.sleep(0.2)
        now = time.monotonic()
        for rank in [r for r, t in respawn_at.items() if now >= t]:
            del respawn_at[rank]
            running[rank] = spawn(rank)
        # all workers done -> drain the server rank (SIGTERM flushes its
        # final snapshot); a post-drain exit is a shutdown, not a crash
        workers_left = any(r != "server"
                           for r in list(running) + list(respawn_at))
        if not workers_left and "server" in running and not server_draining:
            server_draining = True
            budgets["server"] = 0
            running["server"].terminate()
        for rank, p in list(running.items()):
            r = p.poll()
            if r is None:
                continue
            del running[rank]
            exit_codes[rank] = r
            if r != 0 and budgets[rank] > 0:
                budgets[rank] -= 1
                delay = policy.delay(attempts[rank])
                attempts[rank] += 1
                print("launch: rank %s exited rc=%d; restarting in %.1fs "
                      "(%d restarts left)" % (rank, r, delay,
                                              budgets[rank]),
                      file=sys.stderr)
                respawn_at[rank] = now + delay
            else:
                rc = rc or r
    if args.metrics_json:
        _dump_launch_metrics(args, attempts, exit_codes,
                             time.monotonic() - t_launch, rc)
    sys.exit(rc)


def _dump_launch_metrics(args, attempts, exit_codes, wall_s, rc):
    """Per-rank restart counts and exit codes plus the fleet's wall
    time, in the metrics JSON schema ``DataParallelTrainer.fit`` dumps."""
    metrics = _load_metrics()
    reg = metrics.MetricsRegistry()
    g = reg.gauge("mxtpu_launch_rank_restarts_total",
                  "elastic restarts consumed per rank")
    for rank, n in attempts.items():
        g.set(n, rank=rank)
    g = reg.gauge("mxtpu_launch_rank_exit_code",
                  "last observed exit code per rank")
    for rank, code in exit_codes.items():
        g.set(code, rank=rank)
    reg.gauge("mxtpu_launch_wall_seconds", "fleet wall time").set(wall_s)
    reg.gauge("mxtpu_launch_num_workers", "").set(args.num_workers)
    reg.gauge("mxtpu_launch_num_servers", "").set(args.num_servers)
    reg.gauge("mxtpu_launch_exit_code", "the launcher's own rc").set(rc)
    try:
        reg.dump_json(args.metrics_json,
                      source="mxnet_tpu_torch.tools.launch")
    except OSError as e:
        print("launch: metrics dump failed: %s" % e, file=sys.stderr)


if __name__ == "__main__":
    main()
