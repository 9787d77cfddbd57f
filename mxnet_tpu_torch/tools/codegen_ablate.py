"""What holds the row plan of the mxgen kernels back (B10, first of all
B10.1 ``_gen_tp_transformer_top1``), and what size the flat plan runs at:
one chain emitted in several variants into one build and timed on the
card.

    python -m mxnet_tpu_torch.tools.codegen_ablate [--chain NAME] [--iters 200]

A chain on the flat plan (``_gen_zero1_top2``) gets ``groups`` (below)
and ``flat_t<T>_e<E>``, the flat plan at each size of
``codegen._FLAT_SIZES`` (T threads a block, E consecutive elements a
thread), each held to the twin first.  A chain on the row plan gets
these variants, each a whole kernel emitted by ``analysis/codegen.py``
``lower_chain``:

- ``groups``: the group plan (one block, a ``__syncthreads()`` between
  groups of one iteration shape): the design the row plan replaced;
- ``rows_c<C>``: the row plan at each cluster size ``C`` it takes;
- at the chain's pinned cluster size (``codegen.ROW_CLUSTER``), the row
  plan with one part cut (``cuts=`` of ``lower_chain``):
  ``no_exchange`` (no cluster barrier, no reads of the other CTAs'
  partials), ``no_shuffles`` (no ``__shfl_xor_sync`` trees),
  ``no_loads`` (the full inputs' loads replaced by each element's row
  and column), and ``no_all`` (the three together: what is left is the
  launch, the arithmetic, the stores and the CTA's own barriers).

A cut variant's outputs are wrong by design, so only device times are
printed: each variant's call captured ``--iters`` times in a CUDA graph,
replayed between CUDA events, every variant timed once to warm the card
and then twice, in turn and in reverse order, keeping the lesser time;
beside them the launch floor of one tiny kernel, timed the same way.
One JSON line per variant; :func:`main` also returns the records.  A
time that drops when a part is cut says that part holds the kernel back.
The card is required.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..analysis import codegen as cg
from ..base import MXNetError, resolve_device
from ..ops import build
from ..ops import generated_kernels as gen

__all__ = ["CUTS", "variants", "graph_ms", "main"]

# cut variant -> the parts of the row plan's kernel left out
CUTS = {"no_exchange": ("exchange",), "no_shuffles": ("shuffles",),
        "no_loads": ("loads",), "no_all": ("exchange", "shuffles", "loads")}


def variants(chain):
    """``{variant: LoweredKernel}`` of ``chain`` (a :class:`codegen.Chain`),
    each under its own kernel name so that all build side by side."""
    base = cg.lower_chain(chain)
    if base.plan not in ("rows", "flat"):
        raise MXNetError("%s runs on the %s plan: nothing to ablate"
                         % (chain.name, base.plan))
    out = {"groups": cg.lower_chain(chain, chain.name + "_groups",
                                    plan="groups")}
    if base.plan == "flat":
        for t, e in cg._FLAT_SIZES:
            out["flat_t%d_e%d" % (t, e)] = cg.lower_chain(
                chain, "%s_t%d_e%d" % (chain.name, t, e), flat=(t, e))
        return out
    for c in cg._ROW_CLUSTERS:
        if base.layout.fits(c) is None:
            out["rows_c%d" % c] = cg.lower_chain(
                chain, "%s_c%d" % (chain.name, c), plan="rows", cluster=c)
    for x, cuts in CUTS.items():
        out[x] = cg.lower_chain(chain, "%s_%s" % (chain.name, x),
                                plan="rows", cluster=base.cluster, cuts=cuts)
    return out


def graph_ms(fn, iters, replays=10):
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA
    graph, replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--chain", default="_gen_tp_transformer_top1")
    p.add_argument("--iters", type=int, default=200)
    args = p.parse_args(argv)
    dev = resolve_device(None)
    chains = {c.name: c for c in cg.load_ir()}
    if args.chain not in chains:
        raise MXNetError("no shipped chain %r (%s)" % (args.chain,
                                                       sorted(chains)))
    lowered = variants(chains[args.chain])
    build.build_all((), {lk.symbol: lk.src for lk in lowered.values()})
    xs = [torch.as_tensor(x).to(dev) for x in
          cg.seeded_inputs(lowered["groups"].in_avals, cg.EQUIV_SEED)]
    kernels = {v: gen.GeneratedKernel(lk) for v, lk in lowered.items()}
    want = cg.reference_outputs(lowered["groups"], xs)
    for v, gk in kernels.items():
        if v not in CUTS:       # a cut variant is wrong by design
            ok, err = cg.compare_outputs(gen.generated_call(gk, *xs), want)
            if not ok:
                raise MXNetError("%s differs from the twin: max |diff| %g"
                                 % (v, err))
    calls = {v: (lambda gk=gk: gen.generated_call(gk, *xs))
             for v, gk in kernels.items()}
    tiny = torch.zeros(1, device=dev)
    calls["launch_floor"] = tiny.zero_
    names = list(calls)
    runs = {v: [] for v in names}
    for i, v in enumerate(names * 2 + names[::-1]):
        ms = graph_ms(calls[v], args.iters)
        if i >= len(names):           # the first round warms up
            runs[v].append(ms)
    name = torch.cuda.get_device_name(dev)
    records = []
    for v in names:
        lk = lowered.get(v)
        rec = {"variant": v, "chain": args.chain,
               "plan": lk.plan if lk else None,
               "cluster": lk.cluster if lk else None,
               "threads": lk.threads if lk else None,
               "per_thread": getattr(lk.layout, "per_thread", None)
               if lk else None,
               "cuts": list(CUTS.get(v, ())), "ms": min(runs[v]),
               "device": name}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
