"""What holds the LayerNorm forward kernel (B4, ``csrc/fused_ln.cu``)
back at the decode and prefill shapes: the kernel with each part of its
design reverted in turn, timed on the card.

    python -m mxnet_tpu_torch.tools.ln_ablate [--every] [--iters 200]

The variants, each the same source with another set of its parts
(``ops.fused_optimizer.LN_PARTS``: ``early_params``, scale and bias
loaded with x; ``vec4``, float4 accesses; ``merge``, one (count, mean,
M2) shuffle tree in place of two; ``row_warps``, warps per block from the
row count):

- ``shipped``: the set the main path runs;
- ``no_<part>`` / ``with_<part>``: the shipped set with one part taken
  out or put in;
- ``previous``: no part, the design the kernel replaced (one warp a
  row, lanes strided over single columns, eight warps a block, the
  parameters loaded after the two trees);
- ``launch_floor``: one tiny kernel (``tiny.zero_()``), what any launch
  costs.

``--every`` times every set of the parts instead (``set:<parts>``), the
search the shipped set was chosen from.

Every variant is first held to the plain version
(``layer_norm_reference``) within 1e-5 on the shape's inputs.  Then, per
shape (the decode step's slot batch (8, 1, 128), a prefill bucket of 8
(1, 8, 128), one position (1, 1, 128), the prefill (1024, 128), and the
TransformerLM training step's (2, 32, 512, 128)),
each variant's call is captured ``--iters`` times in a CUDA graph and
replayed between CUDA events, every variant timed once to warm the card
and then twice, in turn and in reverse order, keeping the lesser time.
One JSON line per shape and variant, with its time and its ratio to the
launch floor; :func:`main` also returns the records.  The card is
required.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..base import resolve_device
from ..ops import fused_optimizer as fo
from .codegen_ablate import graph_ms

__all__ = ["SHAPES", "variants", "main"]

# the decode step's (slot batch, prefill bucket of 8, one position), the
# prefill's, and the TransformerLM training step's (sequence ranks,
# batch, tokens a rank, d)
SHAPES = [(8, 1, 128), (1, 8, 128), (1, 1, 128), (1024, 128),
          (2, 32, 512, 128)]
TOL = 1e-5


def variants(shipped, every=False):
    """``{variant: parts}`` around the ``shipped`` set of part names, or
    (``every``) every set of the parts."""
    if every:
        names = sorted(fo.LN_PARTS)
        sets = [sorted(p for k, p in enumerate(names) if m >> k & 1)
                for m in range(2 ** len(names))]
        return {"set:" + "+".join(ps): ps for ps in sets}
    shipped = set(shipped)
    out = {"shipped": sorted(shipped)}
    for p in sorted(fo.LN_PARTS):
        name = ("no_" if p in shipped else "with_") + p
        out[name] = sorted(shipped ^ {p})
    out["previous"] = []
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--every", action="store_true",
                   help="time every set of the parts")
    p.add_argument("--iters", type=int, default=200)
    args = p.parse_args(argv)
    dev = resolve_device(None)
    parts = variants(fo.ln_shipped_parts(), args.every)
    gen = torch.Generator(device=dev).manual_seed(0)
    tiny = torch.zeros(1, device=dev)
    name = torch.cuda.get_device_name(dev)
    records = []
    for shape in SHAPES:
        x = torch.randn(shape, device=dev, generator=gen) * 3 + 1
        s = torch.randn(shape[-1], device=dev, generator=gen)
        b = torch.randn(shape[-1], device=dev, generator=gen)
        want = fo.layer_norm_reference(x, s, b)
        calls = {}
        for v, ps in parts.items():
            torch.testing.assert_close(
                fo._fused_layer_norm_parts(x, s, b, ps), want, rtol=TOL,
                atol=TOL, msg=lambda m, v=v: "%s %s: %s" % (v, shape, m))
            calls[v] = (lambda ps=ps: fo._fused_layer_norm_parts(x, s, b,
                                                                 ps))
        calls["launch_floor"] = tiny.zero_
        names = list(calls)
        runs = {v: [] for v in names}
        for i, v in enumerate(names * 2 + names[::-1]):
            ms = graph_ms(calls[v], args.iters)
            if i >= len(names):           # the first round warms up
                runs[v].append(ms)
        floor = min(runs["launch_floor"])
        for v in names:
            ms = min(runs[v])
            rec = {"shape": list(shape), "variant": v,
                   "parts": parts.get(v), "ms": ms,
                   "x_floor": ms / floor, "device": name}
            print(json.dumps(rec), flush=True)
            records.append(rec)
    return records


if __name__ == "__main__":
    main()
