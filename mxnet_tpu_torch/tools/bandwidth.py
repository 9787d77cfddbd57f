"""Collective and kvstore bandwidth: the port of ``tools/bandwidth.py``
(reference: MXNet's tools/bandwidth, kvstore push/pull throughput).

Times all-reduce (mean), all-gather and reduce-scatter (mean) of a
``--size-mb`` f32 buffer per rank over ``parallel/comm.py``:

- in process, K = 2 and 4 ranks in turn on one device
  (``InProcessComm``);
- over a process group of world size 1 on the device (NCCL on a card,
  gloo on the host);
- over gloo at 2 processes (``--pg 2``: spawned through
  ``tools/launch.py``), where a CUDA buffer is reduced both ways gloo
  can take it: through an explicit host copy, and handed over directly;
- and, in those 2 processes, a push + pull of one ``--size-mb`` key
  through a ``dist_sync`` and a ``dist_async`` kvstore.

One JSON line per measurement: ``{"primitive", "route", "ranks",
"bytes", "ms", "gbps"}``; ``gbps`` is the algorithm bandwidth, the
bytes a ring moves per rank over the time (all-reduce 2(K-1)/K of the
buffer, all-gather and reduce-scatter (K-1)/K; push + pull the key's
bytes twice).  A route that fails prints ``"ok": false`` and its error.

``python -m mxnet_tpu_torch.tools.bandwidth [--size-mb 64] [--iters
10] [--device cpu] [--pg 2]``; without ``--device`` it runs on the card
and raises without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device, iters):
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


# only rank 0 of the --pg processes prints
_PRINT = [True]


def _emit(primitive, route, ranks, nbytes, seconds, algo):
    rec = {"primitive": primitive, "route": route, "ranks": ranks,
           "bytes": nbytes, "ms": seconds * 1e3,
           "gbps": algo * nbytes / seconds / 1e9}
    if _PRINT[0]:
        print(json.dumps(rec), flush=True)
    return rec


def _fail(primitive, route, ranks, err):
    rec = {"primitive": primitive, "route": route, "ranks": ranks,
           "ok": False, "error": "%s: %s" % (type(err).__name__, err)}
    if _PRINT[0]:
        print(json.dumps(rec), flush=True)
    return rec


def _comm_records(comm, route, elems, device, iters):
    """The three primitives over ``comm`` (every local rank's buffer)."""
    k = comm.k
    ranks = [torch.ones(elems, device=device) for _ in comm.local_ranks]
    nbytes = elems * 4
    out = torch.empty(elems, device=device)
    shards = [torch.ones(elems // k, device=device) for _ in comm.local_ranks]
    return [
        _emit("all_reduce_mean", route, k, nbytes,
              _time(lambda: comm.mean(ranks), device, iters),
              2 * (k - 1) / k),
        _emit("all_gather", route, k, nbytes,
              _time(lambda: comm.all_gather(shards, out), device, iters),
              (k - 1) / k),
        _emit("reduce_scatter_mean", route, k, nbytes,
              _time(lambda: comm.reduce_scatter_mean(ranks), device, iters),
              (k - 1) / k),
    ]


def _elems(size_mb, k=4):
    elems = int(size_mb * 1e6 / 4)
    return max(k * 128, (elems // (k * 128)) * k * 128)


def _world_one(device, elems, iters):
    """A process group of one rank on ``device`` (NCCL on a card)."""
    import tempfile
    import torch.distributed as dist
    from ..parallel.comm import ProcessGroupComm
    backend = "nccl" if device.type == "cuda" else "gloo"
    fd, store = tempfile.mkstemp(prefix="mxtt_bw_")
    os.close(fd)
    os.remove(store)
    dist.init_process_group(backend, init_method="file://" + store, rank=0,
                            world_size=1)
    try:
        return _comm_records(ProcessGroupComm(1, device), backend, elems,
                             device, iters)
    finally:
        dist.destroy_process_group()


def _pg_worker(args, device):
    """One of the ``--pg`` processes (launched with the kvstore env)."""
    import torch.distributed as dist
    from .. import kvstore as kvs
    from ..ndarray import NDArray
    from ..parallel.comm import ProcessGroupComm
    elems = _elems(args.size_mb)
    store = kvs.create("dist_sync")     # forms the gloo group
    world, rank = store.num_workers, store.rank
    _PRINT[0] = rank == 0
    recs = []
    comm = ProcessGroupComm(world, device)
    if device.type == "cuda":
        # gloo and a CUDA buffer: through an explicit host copy, and
        # handed to gloo as it is (the store's route)
        h = torch.ones(elems, device=device)

        def host_copy():
            c = h.cpu()
            dist.all_reduce(c)
            h.copy_(c)
        recs.append(_emit("all_reduce_sum", "gloo_host_copy", world,
                          elems * 4, _time(host_copy, device, args.iters),
                          2 * (world - 1) / world))
        try:
            recs.append(_emit("all_reduce_sum", "gloo_cuda_direct", world,
                              elems * 4, _time(lambda: dist.all_reduce(h),
                                               device, args.iters),
                              2 * (world - 1) / world))
        except Exception as e:      # the finding is whether gloo takes it
            recs.append(_fail("all_reduce_sum", "gloo_cuda_direct", world,
                              e))
        cpu = torch.device("cpu")
        recs += _comm_records(ProcessGroupComm(world, cpu), "gloo", elems,
                              cpu, args.iters)
    else:
        recs += _comm_records(comm, "gloo", elems, device, args.iters)
    for kind in ("dist_sync", "dist_async"):
        kv = store if kind == "dist_sync" else kvs.create(kind)
        val = NDArray(torch.ones(elems, device=device))
        out = NDArray(torch.zeros(elems, device=device), fixed=True)
        kv.init("bw", NDArray(torch.zeros(elems, device=device)))
        kv.barrier()

        def push_pull():
            kv.push("bw", val)
            kv.pull("bw", out=out)
        recs.append(_emit("push_pull", kind, world, elems * 4,
                          _time(push_pull, device, args.iters), 2.0))
        kv.barrier()
        if kind == "dist_async":
            kv.close()
    return recs if rank == 0 else []


def _spawn_pg(args):
    """Run ``--pg`` processes through the launcher; rank 0's records."""
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
           str(args.pg), "--launcher", "local", sys.executable, "-m",
           "mxnet_tpu_torch.tools.bandwidth", "--pg-worker",
           "--size-mb", str(args.size_mb), "--iters", str(args.iters)]
    if args.device:
        cmd += ["--device", args.device]
    env = dict(os.environ, MXTPU_HEARTBEAT_INTERVAL_S="0")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=600)
    if proc.returncode:
        raise RuntimeError("bandwidth --pg %d failed (rc %d): %s"
                           % (args.pg, proc.returncode, proc.stderr[-3000:]))
    recs = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return recs


def main(argv=None):
    from ..base import resolve_device
    from ..parallel.comm import InProcessComm
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--size-mb", type=float, default=64)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--device", default=None,
                        help="cpu, or the card when omitted")
    parser.add_argument("--pg", type=int, default=2,
                        help="gloo processes for the multi-process "
                             "routes (0: skip them)")
    parser.add_argument("--pg-worker", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.pg_worker:
        return _pg_worker(args, device)
    recs = []
    elems = _elems(args.size_mb)
    for k in (2, 4):
        recs += _comm_records(InProcessComm(k, device), "in_process", elems,
                              device, args.iters)
    recs += _world_one(device, elems, args.iters)
    if args.pg:
        recs += _spawn_pg(args)
    return recs


if __name__ == "__main__":
    main()
