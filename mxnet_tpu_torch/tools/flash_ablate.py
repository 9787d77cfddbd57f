"""What holds the wgmma designs of the flash kernels back — the forward
(B5) and ``flash_dq`` (B6) and ``flash_dkv`` (B7), in split TF32 and on
bfloat16: each kernel rebuilt with one part switched off at a time and
timed at the ring path's pairings of one TransformerLM layer.

    python -m mxnet_tpu_torch.tools.flash_ablate [--iters 20]

Each variant is ``csrc/flash_fwd_wgmma.cu`` (:data:`FWD_CUTS`),
``csrc/flash_bwd_wgmma.cu`` (:data:`CUTS`) or ``csrc/flash_bf16_wgmma.cu``
(:data:`BF16_CUTS`, on bfloat16 inputs) with textual edits, built through
``ops.build.load_source`` as ``tools/qmm_ablate.py`` builds B8's:

- ``full``: the source as it is;
- ``no_loads``: no bulk copies (TMA boxes on bfloat16) of the streamed
  tiles, the ring's barriers still run;
- ``no_split``: no split / transposed tile writes by the producer (split
  TF32 only: the bf16 design has none);
- ``no_mma``: no ``wgmma``;
- ``no_lo``: the ``lo`` terms cut (one TF32 pass per product, or one bf16
  part of p and ds: what the contract costs);
- ``no_softmax`` (forward): no online softmax (the scale, masks, running
  max, ``expf``, row sums; p is the raw score);
- ``no_recompute`` (backward): no softmax recompute (``expf``, the masks,
  ``ds``);
- ``no_stores``: no output stores.

A cut of one kernel's part leaves the other kernels of its source as
they are (the bf16 source's ``no_softmax`` times dq and dk/dv unchanged,
``no_recompute`` the forward).  :func:`dq_tile_source` gives the bf16
source with dq's key tile set to another of :data:`DQ_TILES`, the widths
``chip_smoke.py``'s phase 17 times against each other.

A variant's outputs are wrong by design (``no_lo`` only misses the
contract), so only its device time is printed: CUDA events around
``--iters`` calls of each C entry point on seeded inputs, every variant
timed once to warm the card and then twice, in turn and in reverse order,
keeping the lesser time.  One JSON line per (variant, kernel) with the
time of each hop and their sum per layer; :func:`main` also returns the
records.  A time that drops when a part is cut says that part holds the
kernel back.  The card is required.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re

import numpy as np
import torch

from ..base import resolve_device
from ..ops import build
from ..ops.pallas_kernels import (_ARGTYPES, flash_delta,
                                  flash_forward_with_lse_reference)
from .conv_ablate import device_ms, edited_source

__all__ = ["CUTS", "FWD_CUTS", "BF16_CUTS", "DQ_TILES", "variant_source",
           "dq_tile_source", "path_pairings", "main"]

_COPIES = ("      mbar_expect_tx(bar, 2 * bytes);\n"
           "      bulk_load(smem_u32(dst), sa + off, bytes, bar);\n"
           "      bulk_load(smem_u32(dst + Z::TILE), sb + off, bytes, bar);\n")
_SPLIT = ("      split_rows<DP, BT>(ra, valid, D, st, st + Z::TILE, tid);\n"
          "      split_rows<DP, BT>(rb, valid, D, st + 2 * Z::TILE, "
          "st + 3 * Z::TILE,\n                         tid);\n"
          "      split_cols<DP, BT>(ra, valid, D, st + 4 * Z::TILE, "
          "st + 5 * Z::TILE,\n                         tid);\n")
_SPLIT_T = ("        split_cols<DP, BT>(rb, valid, D, st + 6 * Z::TILE, "
            "st + 7 * Z::TILE,\n                           tid);\n")
_XY = ("      Rs<BT>::run(x, ps == 2 ? ax.lo[kk] : ax.hi[kk], "
       "tile_desc(b, BT, kk),\n                  acc);\n"
       "      Rs<BT>::run(y, ps == 2 ? ay.lo[kk] : ay.hi[kk],\n"
       "                  tile_desc(b + 2 * Z::TILE / 16, BT, kk), acc);\n")
_RS = ("      mma_rs<PASSES, DP, BT, NA>(acc0, sh, sl, st + 4 * Z::TILE / 16,\n"
       "                                 st + 5 * Z::TILE / 16);\n"
       "      if (DKV)\n"
       "        mma_rs<PASSES, DP, BT, NA>(acc1, ph, pl, st + 6 * Z::TILE / 16,"
       "\n                                   st + 7 * Z::TILE / 16);\n")
_PASSES = "constexpr int PASSES = 3;"
_RECOMPUTE = ("  p = valid ? expf(s * scale - lse) : 0.f;\n"
              "  ds = valid ? p * (dp - delta) : 0.f;\n")
_STORE = "    if (row >= rows) continue;\n"

# the backward's cuts, in csrc/flash_bwd_wgmma.cu: variant -> [(text in
# the source, its replacement)]
CUTS = {
    "full": [],
    "no_loads": [(_COPIES, "      mbar_arrive(bar);\n")],
    "no_split": [(_SPLIT, ""), (_SPLIT_T, "")],
    "no_mma": [(_XY, ""), (_RS, "")],
    "no_lo": [(_PASSES, "constexpr int PASSES = 1;")],
    "no_recompute": [(_RECOMPUTE, "  p = s;\n  ds = dp;\n")],
    "no_stores": [(_STORE, "    if (row >= rows || rows > 0) continue;\n")],
}

# the forward's cuts, in csrc/flash_fwd_wgmma.cu
_FWD_COPIES = ("      mbar_expect_tx(bar, 2 * bytes);\n"
               "      bulk_load(smem_u32(dst), k + off, bytes, bar);\n"
               "      bulk_load(smem_u32(dst + Z::TILE), v + off, bytes, "
               "bar);\n")
_FWD_SPLIT = ("      split_rows<DP, BT>(rk, valid, D, st, st + Z::TILE, tid);\n"
              "      split_cols<DP, BT>(rv, valid, D, st + 2 * Z::TILE, "
              "st + 3 * Z::TILE,\n                         tid);\n")
_FWD_S = ("      Rs<BT>::run(s, ps == 2 ? aq.lo[kk] : aq.hi[kk], "
          "tile_desc(b, BT, kk),\n                  ps + kk > 0);\n")
_FWD_PV = ("      mma_rs<PASSES, DP, BT, NA>(o, ph, pl, st + 2 * Z::TILE / 16,\n"
           "                                 st + 3 * Z::TILE / 16);\n")
_FWD_SOFTMAX = ("      if (c0 + BT > Tk || (causal && c0 + BT - 1 > row_lo))\n"
                "        softmax_tile<BT, true>(s, m, l, corr, scale, row_lo, "
                "r, t, c0,\n                               Tk, causal);\n"
                "      else\n"
                "        softmax_tile<BT, false>(s, m, l, corr, scale, row_lo, "
                "r, t, c0,\n                                Tk, causal);\n")
_FWD_STORE = "    if (row >= Tq) continue;\n"

FWD_CUTS = {
    "full": [],
    "no_loads": [(_FWD_COPIES, "      mbar_arrive(bar);\n")],
    "no_split": [(_FWD_SPLIT, "")],
    "no_mma": [(_FWD_S, ""), (_FWD_PV, "")],
    "no_lo": [(_PASSES, "constexpr int PASSES = 1;")],
    "no_softmax": [(_FWD_SOFTMAX, "      corr[0] = corr[1] = 1.f;\n")],
    "no_stores": [(_FWD_STORE, "    if (row >= Tq || Tq > 0) continue;\n")],
}

# the bf16 design's cuts, in csrc/flash_bf16_wgmma.cu (forward, dq and
# dk/dv; the loads, the split into parts, the mixed products and the
# stores are shared)
_BF16_LOADS = ("  mbar_expect_tx(bar, 2 * (D / 8) * R * 16);\n"
               "  for (int c = 0; c < D / 8; ++c) {\n"
               "    tma_load_3d(smem_u32(dst + c * R * 16), a, bar, 8 * c, "
               "row0, bh);\n"
               "    tma_load_3d(smem_u32(dst + tile + c * R * 16), b, bar, "
               "8 * c, row0, bh);\n  }\n")
_BF16_PV = ("      Bf16<DP, 1>::run(acc[kk % NA], a, mnmajor(tile, R, kk), "
            "1);\n")
_BF16_S = "    Bf16<FWD_BT, 0>::run(s, a, kmajor(tile, FWD_BT, kk), kk > 0);\n"
_BF16_XY = ("    Bf16<DKV_BT, 0>::run(x, a, kmajor(st, DKV_BT, kk), kk > 0);\n"
            "    Bf16<DKV_BT, 0>::run(y, b, kmajor(st + TILE, DKV_BT, kk), "
            "kk > 0);\n")
_BF16_SOFTMAX = ("      if (c0 + BT > Tk || (causal && c0 + BT - 1 > row_lo))\n"
                 "        softmax_tile<BT, true>(s, m, l, corr, scale, row_lo, "
                 "r, t, c0, Tk,\n                               causal);\n"
                 "      else\n"
                 "        softmax_tile<BT, false>(s, m, l, corr, scale, row_lo, "
                 "r, t, c0, Tk,\n                                causal);\n")
_BF16_RECOMPUTE = ("        p[e] = valid ? expf(x[e] * scale - lr) : 0.f;\n"
                   "        ds[e] = valid ? p[e] * (y[e] - dr) : 0.f;\n")
_BF16_SDP = ("      Bf16<64, 0>::run(sh, a, kmajor(k64, BT, kk), kk > 0);\n"
             "      Bf16<64, 0>::run(dh, b, kmajor(k64 + TILE, BT, kk), "
             "kk > 0);\n")
_BF16_DQ_RECOMPUTE = (
    "        const float p = valid ? expf(s[e] * scale - lr[h]) : 0.f;\n"
    "        s[e] = valid ? p * (dp[e] - dr[h]) : 0.f;\n")

BF16_CUTS = {
    "full": [],
    "no_loads": [(_BF16_LOADS, "  mbar_arrive(bar);\n")],
    "no_mma": [(_BF16_PV, ""), (_BF16_S, ""), (_BF16_XY, ""),
               (_BF16_SDP, "")],
    "no_lo": [("constexpr int PARTS = 2;", "constexpr int PARTS = 1;")],
    "no_softmax": [(_BF16_SOFTMAX, "      corr[0] = corr[1] = 1.f;\n")],
    "no_recompute": [(_BF16_RECOMPUTE, "        p[e] = x[e];\n"
                                       "        ds[e] = y[e];\n"),
                     (_BF16_DQ_RECOMPUTE, "        s[e] = dp[e];\n")],
    "no_stores": [(_STORE, "    if (row >= rows || rows > 0) continue;\n"),
                  (_FWD_STORE, "    if (row >= Tq || Tq > 0) continue;\n")],
}

# source -> (its cuts, {wrapper: C entry point}, operand dtype)
_KERNELS = {
    "flash_fwd_wgmma": (FWD_CUTS,
                        {"flash_forward_with_lse": "mxtt_flash_fwd_wgmma"},
                        torch.float32),
    "flash_bwd_wgmma": (CUTS, {"flash_dq": "mxtt_flash_dq_wgmma",
                               "flash_dkv": "mxtt_flash_dkv_wgmma"},
                        torch.float32),
    "flash_bf16_wgmma": (BF16_CUTS,
                         {"flash_forward_with_lse":
                          "mxtt_flash_fwd_wgmma_bf16",
                          "flash_dq": "mxtt_flash_dq_wgmma_bf16",
                          "flash_dkv": "mxtt_flash_dkv_wgmma_bf16"},
                         torch.bfloat16),
}


def variant_source(name, source="flash_bwd_wgmma"):
    """``csrc/<source>.cu`` with the edits of its variant ``name``; raises
    if an edit's text is not in the source exactly once."""
    return edited_source(source, _KERNELS[source][0][name], name)


# dq's key tile in csrc/flash_bf16_wgmma.cu (DQ_BT): the widths timed
DQ_TILES = (64, 128)
_DQ_BT = re.compile(r"constexpr int DQ_BT = (\d+);")


def dq_tile_source(bt):
    """``(text, shipped)``: ``csrc/flash_bf16_wgmma.cu`` with dq's key
    tile set to ``bt`` rows (one of :data:`DQ_TILES`), and the width the
    source ships."""
    with open(build.source_path("flash_bf16_wgmma"), encoding="utf-8") as f:
        text = f.read()
    found = _DQ_BT.findall(text)
    if len(found) != 1 or bt not in DQ_TILES:
        raise ValueError("dq key tile %r: the source sets DQ_BT %d times"
                         % (bt, len(found)))
    return _DQ_BT.sub("constexpr int DQ_BT = %d;" % bt, text), int(found[0])


def path_pairings(batch=32, heads=8, seq_len=1024, ranks=2, head_dim=16):
    """``(BH, Tq, Tk, D, causal)`` of the flash pairings of one layer of the
    ring path at ``MeshPlan(sequence=ranks)``: hop 0 is the diagonal for
    every rank (causal), each later hop the full pairing of the ranks that
    see an earlier chunk."""
    t = seq_len // ranks
    return [(ranks * batch * heads, t, t, head_dim, True)] + [
        ((ranks - h) * batch * heads, t, t, head_dim, False)
        for h in range(1, ranks)]


def _sources():
    """``{library name: source text}`` of every variant of both kernels."""
    return {"%s_ablate_%s" % (source, x): variant_source(x, source)
            for source, (cuts, _, _) in _KERNELS.items() for x in cuts}


def _fns(source, name, text):
    """``{wrapper: C entry point}`` of variant ``name`` of ``source``."""
    lib = build.load_source(name, text)
    out = {}
    for wrapper, entry in _KERNELS[source][1].items():
        fn = getattr(lib, entry)
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
        out[wrapper] = fn
    return out


def _inputs(case, rng, dev, dtype=torch.float32):
    bh, tq, tk, d, causal = case
    q, do = (torch.as_tensor(rng.randn(bh, tq, d), device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.as_tensor(rng.randn(bh, tk, d), device=dev).to(dtype)
            for _ in range(2))
    o, lse = flash_forward_with_lse_reference(q, k, v, causal, d ** -0.5)
    return q, k, v, do, lse, flash_delta(o, do)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    dev = resolve_device(None)
    sources = list(_KERNELS)
    texts = _sources()
    build.build_all((), texts)
    fns = {}              # (source, variant, wrapper) -> C entry point
    for source in sources:
        for x in _KERNELS[source][0]:
            lib = "%s_ablate_%s" % (source, x)
            for wrapper, fn in _fns(source, lib, texts[lib]).items():
                fns[(source, x, wrapper)] = fn
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = torch.cuda.get_device_name(dev)
    rng = np.random.RandomState(0)
    cases = path_pairings()
    per_hop = {key: [] for key in fns}
    for case in cases:
        bh, tq, tk, d, causal = case
        for source in sources:
            cuts, entries, dtype = _KERNELS[source]
            q, k, v, do, lse, delta = _inputs(case, rng, dev, dtype)
            ins = {"flash_forward_with_lse": (q, k, v, torch.empty_like(q),
                                              torch.empty_like(lse)),
                   "flash_dq": (q, k, v, do, lse, delta,
                                torch.empty_like(q)),
                   "flash_dkv": (q, k, v, do, lse, delta,
                                 torch.empty_like(k), torch.empty_like(v))}
            for wrapper in entries:
                call = tuple(t.data_ptr() for t in ins[wrapper]) + (
                    bh, tq, tk, d, d ** -0.5, int(causal), stream)
                runs = {x: [] for x in cuts}
                order = list(cuts) * 2 + list(cuts)[::-1]
                for i, x in enumerate(order):
                    ms = device_ms(fns[(source, x, wrapper)], call,
                                   args.iters, dev, "flash_ablate %s %s %s"
                                   % (source, x, wrapper))
                    if i >= len(cuts):        # the first round warms up
                        runs[x].append(ms)
                for x in cuts:
                    per_hop[(source, x, wrapper)].append(min(runs[x]))
            del q, k, v, do, lse, delta, ins
    records = []
    for (source, x, wrapper), times in per_hop.items():
        rec = {"source": source, "variant": x, "kernel": wrapper,
               "pairings": cases, "hop_ms": times, "layer_ms": sum(times),
               "device": name}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
