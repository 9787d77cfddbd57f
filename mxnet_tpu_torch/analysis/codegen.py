"""mxgen on the H100 — lower fusion chains to CUDA C++ kernels.

The port of ``mxnet_tpu/analysis/codegen.py``.  The reference lowers
the top fusion chains of two shipped tapes (the tensor-parallel
TransformerLM train step and the ZeRO-1 step) into Pallas kernel source;
here :func:`lower_chain` lowers the same chains into **CUDA C++ for
sm_90a**, which ``ops/build.py`` compiles with ``nvcc`` at first use and
``ops/generated_kernels.py`` launches.

The chains come from ``shipped_chains.json`` beside this module: the
reference's ``shipped_lowered()`` exported into a small IR (ops in tape
order, external buffers in the reference's sorted order, the shape and
dtype of every value, literals stored exactly, the byte and cost
contract).  The card has no JAX and the port has no tape of its own yet
(ROADMAP.md A13 retires the file); ``python tests/test_torch_codegen.py
--export <path>`` regenerates it and the tests hold it equal to a fresh
export.

As in the reference, each primitive has TWO independent
implementations:

- the emitter (``_emit_*``) — prim → CUDA C++ text (what the card runs);
- ``_prim_eval`` — prim → plain PyTorch over tensors (the twin: what the
  chain meant, and what a CPU call runs).

:func:`equivalence_check` runs both on the same seeded inputs and
compares at 1e-5.  The ``MXGEN_LOWER_EXACT`` seam flips ``sub`` to
``add`` in the EMITTED text only, so a mislowering shows as a failed
check on the card.

The emitted whole-array kernel is one launch (the reference's one grid
step), on one of three plans chosen from the chain's shapes when it is
lowered:

- the **row plan** (:class:`_RowPlan`), where the chain is rows of its
  widest value: a thread-block cluster of up to 8 CTAs owns the rows in
  blocks, each warp whole rows, each lane columns; row values stay in
  registers, reductions along a row are fixed ``__shfl_xor_sync`` trees,
  and each reduction across rows is summed per warp, per CTA through
  shared memory and over the cluster through distributed shared memory
  in rank order — a barrier only where an op reads such a sum.  The
  cluster size of each shipped chain is pinned by measurement
  (:data:`ROW_CLUSTER`);
- the **flat plan** (:class:`_FlatPlan`) for a chain off the row plan
  whose eqns are one group of pointwise eqns (a 1-D elementwise chain):
  a grid over the card, each thread a few consecutive elements, 16-byte
  accesses where the operands are aligned, the tail masked; no barrier
  and no workspace.  Its size is pinned by measurement
  (:data:`FLAT_THREADS`, :data:`FLAT_PER_THREAD`), and it evaluates the
  group plan's per-element body, so its outputs are bitwise the group
  plan's;
- the **group plan** (:class:`_Plan`) for the rest (shapes neither rule
  takes): one thread block, the eqns cut into
  groups of one iteration shape, each a block-strided loop over its flat
  output index, a ``__syncthreads()`` between groups, and a value read
  by a later group in an external output or a workspace (shared memory
  when it fits, else a global scratch buffer the wrapper allocates).

Reductions run in a fixed order with no atomics, so reruns are bitwise
equal.  Flat-tileable chains also get a row-tiled kernel, one thread
block per ``(block_rows, 128)`` tile.
"""
from __future__ import annotations

import collections
import json
import os
import time

import numpy as np
import torch

from .findings import Finding, filter_findings

__all__ = [
    "LOWERABLE", "MXGEN_LOWER_EXACT", "AUTOTUNE_LADDER", "AUTOTUNE_SEED",
    "EQUIV_TOL", "EQUIV_SEED", "SHIPPED_IR", "Aval", "Chain",
    "LoweredKernel", "load_ir", "lower_chain", "seeded_inputs",
    "reference_outputs", "equivalence_check", "flat_tileable",
    "autotune_block_rows", "shipped_lowered", "shipped_chain_rows",
    "codegen_plans", "render_codegen", "lint_generated_kernels",
]

# ---------------------------------------------------------------------------
# mutation seam (tests only): False makes the EMITTER lower every `sub`
# eqn as `add` — the twin is untouched, so the equivalence check fails
# ---------------------------------------------------------------------------
MXGEN_LOWER_EXACT = True

# the provable-lowering set (the reference's, mxnet_tpu/analysis/
# codegen.py:61-87): a chain with anything else is GEN001
_ELEMENTWISE_BINOPS = frozenset({
    "add", "add_any", "sub", "mul", "div", "max", "min", "pow", "rem",
    "gt", "ge", "lt", "le", "eq", "ne", "and", "or", "xor"})
_ELEMENTWISE_UNOPS = frozenset({
    "neg", "abs", "sign", "floor", "ceil", "exp", "exp2", "log", "log1p",
    "tanh", "sqrt", "rsqrt", "logistic", "sin", "cos", "erf", "is_finite",
    "not"})
_REDUCES = frozenset({"reduce_sum", "reduce_max", "reduce_min",
                      "reduce_prod", "reduce_and", "reduce_or"})
_IDENTITY = frozenset({"copy", "stop_gradient"})
_STRUCTURAL = frozenset({"broadcast_in_dim", "convert_element_type",
                         "select_n", "integer_pow", "squeeze",
                         "expand_dims"})

LOWERABLE = _ELEMENTWISE_BINOPS | _ELEMENTWISE_UNOPS | _REDUCES \
    | _IDENTITY | _STRUCTURAL

# eqns computed per output element from the same flat index of their
# operands (or index 0 of a scalar, or a size-1-broadcast read)
_POINTWISE = _ELEMENTWISE_BINOPS | _ELEMENTWISE_UNOPS | _IDENTITY | {
    "convert_element_type", "select_n", "integer_pow"}
_COMPARES = frozenset({"gt", "ge", "lt", "le", "eq", "ne"})

# the pinned autotune ladder: block rows x 128 columns per tile
AUTOTUNE_LADDER = (8, 32, 128, 256)
AUTOTUNE_SEED = 20260807
AUTOTUNE_CACHE_SCHEMA = 1
AUTOTUNE_REPS = 3
TILE_COLS = 128

EQUIV_TOL = 1e-5        # the reference's fused-vs-unfused tolerance
EQUIV_SEED = 0

SHIPPED_IR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "shipped_chains.json")

# the dtypes the emitter writes: numpy name -> (torch dtype, C++ type)
_DTYPES = {"float32": (torch.float32, "float"), "int32": (torch.int32, "int"),
           "int64": (torch.int64, "long long"), "bool": (torch.bool, "bool")}
_MAX_THREADS = 1024
_TILED_THREADS = 256
_SMEM_BYTES = 49152     # a block's shared memory without the opt-in

# the row plan's cluster sizes (the portable ones), and the size each
# shipped chain runs at: the fastest in chip_smoke.py's phase 15, which
# times every size and fails when another is more than 10 % faster
_ROW_CLUSTERS = (1, 2, 4, 8)
ROW_CLUSTER = {
    "_gen_tp_transformer_top1": 8,
    "_gen_tp_transformer_top2": 4,
    "_gen_tp_transformer_top3": 4,
    "_gen_zero1_top1": 8,
    "_gen_zero1_top3": 4,
}

# the flat plan's launch: threads a block and consecutive elements a
# thread, the fastest of the sizes chip_smoke.py's phase 15 and
# tools/codegen_ablate.py time at _gen_zero1_top2's 9,458 elements
_FLAT_SIZES = tuple((t, e) for t in (64, 128, 256, 512) for e in (4, 8))
FLAT_THREADS = 256
FLAT_PER_THREAD = 4


def _torch_dtype(name):
    return _DTYPES[str(name)][0]


def _ctype(name):
    return _DTYPES[str(name)][1]


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _strides(shape):
    out, s = [], 1
    for d in reversed(shape):
        out.append(s)
        s *= int(d)
    return tuple(reversed(out))


# ---------------------------------------------------------------------------
# the chain IR
# ---------------------------------------------------------------------------
Aval = collections.namedtuple("Aval", "shape dtype")
Op = collections.namedtuple("Op", "prim ins outs params")

_COST_KEYS = ("scale", "unfused_bytes", "fused_bytes", "bytes_saved",
              "bytes_read", "bytes_written", "flops", "transcendentals")


def _literal_array(lit):
    """A literal of the IR as a numpy array (f32 values are stored as
    their bit patterns, so they round-trip exactly)."""
    dt = np.dtype(lit["dtype"])
    if dt == np.float32:
        arr = np.array([int(b, 16) for b in lit["values"]],
                       np.uint32).view(np.float32)
    else:
        arr = np.array(lit["values"], dt)
    return arr.reshape(tuple(lit["shape"]))


class Chain:
    """One fusion chain of the IR: values by id (``avals``), literal
    values (``literals``), ops in tape order, the external inputs and
    outputs in the reference's sorted-id order, and the byte/cost
    contract of the reference's lowering."""

    __slots__ = ("name", "tag", "rank", "kind", "n_ops", "ext_in",
                 "ext_out", "avals", "literals", "ops") + _COST_KEYS

    @classmethod
    def from_json(cls, raw):
        if isinstance(raw, Chain):
            return raw
        c = cls()
        c.name = raw["name"]
        c.tag = raw.get("tag", "chain")
        c.rank = int(raw.get("rank", 0))
        c.kind = raw["kind"]
        c.ext_in = [int(i) for i in raw["ext_in"]]
        c.ext_out = [int(i) for i in raw["ext_out"]]
        c.avals = {int(k): Aval(tuple(int(d) for d in v[0]), np.dtype(v[1]))
                   for k, v in raw["avals"].items()}
        c.literals = {int(k): _literal_array(v)
                      for k, v in raw.get("literals", {}).items()}
        c.ops = [Op(o["prim"], [int(i) for i in o["in"]],
                    [int(i) for i in o["out"]], dict(o.get("params", {})))
                 for o in raw["ops"]]
        c.n_ops = int(raw.get("n_ops", len(c.ops)))
        for k in _COST_KEYS:
            setattr(c, k, int(raw.get(k, 1 if k == "scale" else 0)))
        return c

    @property
    def prims(self):
        return [op.prim for op in self.ops]


def load_ir(path=None):
    """The chains of an IR file (default: the shipped six)."""
    with open(path or SHIPPED_IR, "r", encoding="utf-8") as f:
        doc = json.load(f)
    return [Chain.from_json(c) for c in doc["chains"]]


# ---------------------------------------------------------------------------
# path 2: the twin — prim → plain PyTorch.  Deliberately written apart
# from the emitter: an emitter bug diverges here instead of reproducing
# ---------------------------------------------------------------------------
def _div(a, b):
    if a.is_floating_point():
        return torch.div(a, b)
    return torch.div(a, b, rounding_mode="trunc")


_TORCH_BINOPS = {
    "add": torch.add, "add_any": torch.add, "sub": torch.sub,
    "mul": torch.mul, "div": _div, "max": torch.maximum,
    "min": torch.minimum, "pow": torch.pow, "rem": torch.fmod,
    "gt": torch.gt, "ge": torch.ge, "lt": torch.lt, "le": torch.le,
    "eq": torch.eq, "ne": torch.ne, "and": torch.bitwise_and,
    "or": torch.bitwise_or, "xor": torch.bitwise_xor,
}
_TORCH_UNOPS = {
    "neg": torch.neg, "abs": torch.abs, "sign": torch.sign,
    "floor": torch.floor, "ceil": torch.ceil, "exp": torch.exp,
    "exp2": torch.exp2, "log": torch.log, "log1p": torch.log1p,
    "tanh": torch.tanh, "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
    "logistic": torch.sigmoid, "sin": torch.sin, "cos": torch.cos,
    "erf": torch.erf, "is_finite": torch.isfinite, "not": torch.bitwise_not,
}


def _dims(params, key):
    return tuple(int(d) for d in (params.get(key) or ()))


def _check_broadcastable(prim, shapes):
    """lax's rule for n-ary elementwise operands: scalars, or one rank
    with each dimension equal or 1 (torch would also pad ranks)."""
    ranks = {len(s) for s in shapes if len(s)}
    if len(ranks) > 1:
        raise TypeError("%s: operands of ranks %s" % (prim, sorted(ranks)))


def _reduce(prim, x, axes):
    if not axes:
        return x
    if prim == "reduce_sum":
        return torch.sum(x, dim=axes).to(x.dtype)
    if prim == "reduce_max":
        return torch.amax(x, dim=axes)
    if prim == "reduce_min":
        return torch.amin(x, dim=axes)
    fn = {"reduce_prod": torch.prod, "reduce_and": torch.all,
          "reduce_or": torch.any}[prim]
    out = x
    for a in sorted(axes, reverse=True):
        out = fn(out, dim=a)
    return out.to(x.dtype)


def _integer_pow(x, y):
    """lax.integer_pow's own multiplication order (binary powers)."""
    if y == 0:
        return torch.ones_like(x)
    recip, y, acc = y < 0, abs(y), None
    while y > 0:
        if y & 1:
            acc = x if acc is None else torch.mul(acc, x)
        y >>= 1
        if y > 0:
            x = torch.mul(x, x)
    return torch.div(torch.ones_like(acc), acc) if recip else acc


def _broadcast_in_dim(x, shape, bdims):
    if len(bdims) != x.dim() or list(bdims) != sorted(set(bdims)):
        raise TypeError("broadcast_in_dim: dims %r for rank %d"
                        % (bdims, x.dim()))
    view = [1] * len(shape)
    for i, d in enumerate(bdims):
        if x.shape[i] not in (1, shape[d]):
            raise TypeError("broadcast_in_dim: %r into %r"
                            % (tuple(x.shape), shape))
        view[d] = x.shape[i]
    return x.reshape(view).expand(shape)


def _select_n(pred, cases):
    _check_broadcastable("select_n", [tuple(c.shape) for c in cases]
                         + [tuple(pred.shape)])
    if pred.dtype == torch.bool:
        if len(cases) != 2:
            raise TypeError("select_n: a bool predicate takes 2 cases")
        return torch.where(pred, cases[1], cases[0])
    out = cases[-1]
    for k in range(len(cases) - 2, -1, -1):
        out = torch.where(pred == k, cases[k], out)
    return out


def _prim_eval(prim, invals, params):
    if prim in _ELEMENTWISE_BINOPS:
        a, b = invals
        _check_broadcastable(prim, [tuple(a.shape), tuple(b.shape)])
        if a.dtype != b.dtype:
            raise TypeError("%s: %s with %s" % (prim, a.dtype, b.dtype))
        return _TORCH_BINOPS[prim](a, b)
    if prim in _ELEMENTWISE_UNOPS:
        return _TORCH_UNOPS[prim](invals[0])
    if prim in _REDUCES:
        return _reduce(prim, invals[0], _dims(params, "axes"))
    if prim in _IDENTITY:
        return invals[0]
    if prim == "integer_pow":
        return _integer_pow(invals[0], int(params["y"]))
    if prim == "convert_element_type":
        return invals[0].to(_torch_dtype(np.dtype(params["new_dtype"])))
    if prim == "broadcast_in_dim":
        return _broadcast_in_dim(invals[0], _dims(params, "shape"),
                                 _dims(params, "broadcast_dimensions"))
    if prim == "select_n":
        return _select_n(invals[0], list(invals[1:]))
    if prim == "squeeze":
        dims = _dims(params, "dimensions")
        x = invals[0]
        if any(x.shape[d] != 1 for d in dims):
            raise TypeError("squeeze: dims %r of %r" % (dims, x.shape))
        return x.reshape([s for i, s in enumerate(x.shape) if i not in dims])
    if prim == "expand_dims":
        shape = list(invals[0].shape)
        for d in sorted(_dims(params, "dimensions")):
            shape.insert(d, 1)
        return invals[0].reshape(shape)
    raise KeyError(prim)


def _coerce_literals(chain, op, vals):
    """A scalar literal of a binary op takes the other operand's dtype
    (JAX's weak typing: an int literal beside int32 is int32)."""
    if op.prim not in _ELEMENTWISE_BINOPS:
        return vals
    lit = [i in chain.literals for i in op.ins]
    if lit[0] != lit[1]:
        k = 0 if lit[0] else 1
        vals = list(vals)
        vals[k] = vals[k].to(vals[1 - k].dtype)
    return vals


def _operands(chain, op, env, device):
    vals = [env[i] if i in env else
            torch.as_tensor(chain.literals[i]).to(device)
            for i in op.ins]
    return _coerce_literals(chain, op, vals)


def _eqn_avals_consistent(chain, op):
    """True when the twin, run on ``meta`` tensors of the recorded
    operand avals, reproduces the recorded output aval — the guard
    against dataflow the lowering cannot prove (and against dtypes the
    emitter does not write)."""
    try:
        ins = [torch.empty(chain.avals[i].shape,
                           dtype=_torch_dtype(chain.avals[i].dtype),
                           device="meta") for i in op.ins]
        out = _prim_eval(op.prim, _coerce_literals(chain, op, ins),
                         op.params)
        want = chain.avals[op.outs[0]]
        return (tuple(out.shape) == want.shape
                and out.dtype == _torch_dtype(want.dtype))
    except Exception:  # noqa: BLE001 — any failure to re-infer is a "no"
        return False


# ---------------------------------------------------------------------------
# path 1: the emitter — the chain → CUDA C++ text
# ---------------------------------------------------------------------------
_PRELUDE = r"""#include <cuda_runtime.h>
#include <math.h>

// lax.max / lax.min propagate NaN (fmaxf would drop it)
__device__ __forceinline__ float mx_maxf(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float mx_minf(float a, float b) {
  return (a < b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T mx_max(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T mx_min(T a, T b) { return a < b ? a : b; }
__device__ __forceinline__ float mx_signf(float a) {
  return a > 0.f ? 1.f : (a < 0.f ? -1.f : a);
}
__device__ __forceinline__ float mx_logistic(float a) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-a)));
}
"""


class _Unsupported(Exception):
    """The emitter has no CUDA form for this eqn (a GEN001)."""


def _c_literal(value, dtype):
    """An exact C++ constant: f32 by its bit pattern (an unsuffixed
    literal would be a double and promote the arithmetic)."""
    dtype = np.dtype(dtype)
    v = np.asarray(value).astype(dtype)
    if v.ndim:
        raise _Unsupported("non-scalar literal")
    if dtype == np.float32:
        return "__uint_as_float(0x%08xu)" % int(v.reshape(1).view(np.uint32)[0])
    if dtype == np.bool_:
        return "true" if bool(v) else "false"
    if dtype == np.int32:
        return "(%d)" % int(v) if int(v) != -2 ** 31 else "(-2147483647 - 1)"
    if dtype == np.int64:
        return "(%dLL)" % int(v)
    raise _Unsupported("literal of dtype %s" % dtype)


def _mul_expr(a, b, dtype):
    return ("__fmul_rn(%s, %s)" if dtype == np.float32 else "(%s * %s)") \
        % (a, b)


def _emit_binop(prim, a, b, dtype):
    """RHS for one binary eqn; ``dtype`` is the operands' dtype."""
    f32 = dtype == np.float32
    if prim in _COMPARES:
        op = {"gt": ">", "ge": ">=", "lt": "<", "le": "<=", "eq": "==",
              "ne": "!="}[prim]
        return "(%s %s %s)" % (a, op, b)
    if prim == "sub" and not MXGEN_LOWER_EXACT:
        prim = "add"            # the mislowering seam (tests only)
    if prim in ("add", "add_any", "sub", "mul", "div"):
        key = "add" if prim == "add_any" else prim
        if f32:
            return "__f%s_rn(%s, %s)" % (key, a, b)
        if dtype == np.bool_:
            raise _Unsupported("%s on bool" % prim)
        if prim == "div":
            return "(%s / %s)" % (a, b)     # C truncates, as lax does
        return "(%s %s %s)" % (a, {"add": "+", "sub": "-",
                                   "mul": "*"}[key], b)
    if prim in ("max", "min"):
        if f32:
            return "mx_%sf(%s, %s)" % (prim, a, b)
        return "mx_%s(%s, %s)" % (prim, a, b)
    if prim == "pow" and f32:
        return "powf(%s, %s)" % (a, b)
    if prim == "rem":
        return ("fmodf(%s, %s)" if f32 else "(%s %% %s)") % (a, b)
    if prim in ("and", "or", "xor") and not f32:
        if dtype == np.bool_:
            op = {"and": "&&", "or": "||", "xor": "!="}[prim]
        else:
            op = {"and": "&", "or": "|", "xor": "^"}[prim]
        return "(%s %s %s)" % (a, op, b)
    raise _Unsupported("%s on %s" % (prim, dtype))


_F32_UNOPS = {
    "neg": "(-%s)", "abs": "fabsf(%s)", "sign": "mx_signf(%s)",
    "floor": "floorf(%s)", "ceil": "ceilf(%s)", "exp": "expf(%s)",
    "exp2": "exp2f(%s)", "log": "logf(%s)", "log1p": "log1pf(%s)",
    "tanh": "tanhf(%s)", "sqrt": "sqrtf(%s)", "rsqrt": "rsqrtf(%s)",
    "logistic": "mx_logistic(%s)", "sin": "sinf(%s)", "cos": "cosf(%s)",
    "erf": "erff(%s)", "is_finite": "isfinite(%s)",
}
_INT_UNOPS = {"neg": "(-%s)", "abs": "(%s < 0 ? -%s : %s)",
              "sign": "((%s > 0) - (%s < 0))", "not": "(~%s)"}


def _emit_unop(prim, a, dtype):
    if dtype == np.float32 and prim in _F32_UNOPS:
        return _F32_UNOPS[prim] % a
    if dtype == np.bool_ and prim == "not":
        return "(!%s)" % a
    if dtype in (np.int32, np.int64) and prim in _INT_UNOPS:
        t = _INT_UNOPS[prim]
        return t % ((a,) * t.count("%s"))
    raise _Unsupported("%s on %s" % (prim, dtype))


def _emit_integer_pow(a, y, dtype):
    one = _c_literal(1, dtype)
    if y == 0:
        return one
    recip, y, acc, x = y < 0, abs(y), None, a
    while y > 0:
        if y & 1:
            acc = x if acc is None else _mul_expr(acc, x, dtype)
        y >>= 1
        if y > 0:
            x = _mul_expr(x, x, dtype)
    if recip:
        if dtype != np.float32:
            raise _Unsupported("negative integer_pow on %s" % dtype)
        return "__fdiv_rn(%s, %s)" % (one, acc)
    return acc


def _emit_convert(a, src, dst):
    if src == dst:
        return a
    if dst == np.bool_:
        return "(%s != 0)" % a
    if src == np.bool_:
        return "(%s ? %s : %s)" % (a, _c_literal(1, dst), _c_literal(0, dst))
    return "((%s)(%s))" % (_ctype(dst), a)


def _decode(o, shape, target):
    """C expression of ``sum_d idx_d * target[d]``, where ``idx`` is the
    multi-index of flat index ``o`` over ``shape``."""
    so = _strides(shape)
    terms = []
    for d, t in enumerate(target):
        if t == 0 or shape[d] == 1:
            continue
        idx = o if so[d] == 1 else "(%s / %d)" % (o, so[d])
        if d > 0:
            idx = "(%s %% %d)" % (idx, shape[d])
        terms.append(idx if t == 1 else "%s * %d" % (idx, t))
    return " + ".join(terms) or "0"


def _index_map(out_shape, op_shape, bdims, o="o"):
    """C expression of the operand's flat index for output index ``o``:
    operand dim ``i`` sits at output dim ``bdims[i]``; a size-1 operand
    dim broadcasts."""
    si = _strides(op_shape)
    target = [0] * len(out_shape)
    for i, d in enumerate(bdims):
        if op_shape[i] != 1:
            target[d] = si[i]
    return _decode(o, out_shape, target)


_REDUCE_INIT = {
    "reduce_sum": lambda dt: _c_literal(0, dt),
    "reduce_prod": lambda dt: _c_literal(1, dt),
    "reduce_max": lambda dt: ("__uint_as_float(0xff800000u)"
                              if dt == np.float32 else
                              _c_literal(np.iinfo(dt).min, dt)),
    "reduce_min": lambda dt: ("__uint_as_float(0x7f800000u)"
                              if dt == np.float32 else
                              _c_literal(np.iinfo(dt).max, dt)),
    "reduce_and": lambda dt: "true",
    "reduce_or": lambda dt: "false",
}


def _reduce_step(prim, acc, x, dtype):
    if prim == "reduce_sum":
        return _emit_binop("add", acc, x, dtype)
    if prim == "reduce_prod":
        return _emit_binop("mul", acc, x, dtype)
    if prim in ("reduce_max", "reduce_min"):
        return _emit_binop(prim[7:], acc, x, dtype)
    if dtype != np.bool_:
        raise _Unsupported("%s on %s" % (prim, dtype))
    return "(%s %s %s)" % (acc, "&&" if prim == "reduce_and" else "||", x)


class _Plan:
    """How a chain runs in one thread block: its eqns cut into groups of
    one iteration shape, which values need memory, and where."""

    name = "groups"

    def __init__(self, chain):
        self.chain = chain
        av = chain.avals
        self.groups = []            # [(shape, [op, ...])]
        group_of = {}
        for op in chain.ops:
            shape = av[op.outs[0]].shape
            last = len(self.groups) - 1
            dep = any(group_of.get(i) == last for i in op.ins)
            if last < 0 or self.groups[last][0] != shape \
                    or (dep and op.prim not in _POINTWISE):
                self.groups.append((shape, []))
                last += 1
            self.groups[last][1].append(op)
            group_of[op.outs[0]] = last
        last_use, crossing = {}, set()
        for g, (_, ops) in enumerate(self.groups):
            for op in ops:
                for i in op.ins:
                    if i in group_of:
                        last_use[i] = max(last_use.get(i, -1), g)
                        if group_of[i] != g:
                            crossing.add(i)
        # workspace slots: a slot freed by a value's last reading group
        # is reused only by values produced after that group
        self.offset = {}
        slots, top = [], 0
        outs = set(chain.ext_out)
        for g, (_, ops) in enumerate(self.groups):
            for op in ops:
                v = op.outs[0]
                if v not in crossing or v in outs:
                    continue
                a = av[v]
                nbytes = -(-_numel(a.shape) * a.dtype.itemsize // 16) * 16
                slot = next((s for s in slots
                             if s[1] == nbytes and s[2] <= g), None)
                if slot is None:
                    slot = [top, nbytes, 0]
                    slots.append(slot)
                    top += nbytes
                slot[2] = last_use[v] + 1
                self.offset[v] = slot[0]
        self.ws_bytes = top
        self.ws_shared = top <= _SMEM_BYTES
        widest = max([_numel(s) for s, _ in self.groups] or [1])
        self.threads = min(_MAX_THREADS, max(32, -(-widest // 32) * 32))
        self.cluster = 1
        self.smem_bytes = self.ws_bytes if self.ws_shared else 0


class _NoFit(Exception):
    """The chain does not fit the row or the flat plan; it keeps the
    group plan."""


class _FlatPlan:
    """How a one-group pointwise chain runs as a grid over the card: no
    block-wide state, so no barrier and no workspace; each thread takes
    ``per_thread`` consecutive elements of the flat output index, with
    16-byte accesses where the operands allow, and the tail masked.

    It takes the chains whose group plan (``groups``) is one group of
    pointwise eqns with no workspace, every operand of the group's shape
    or a single element.  Raises :class:`_NoFit` for the rest."""

    name = "flat"

    def __init__(self, chain, groups, threads=None, per_thread=None):
        self.chain, self.groups = chain, groups.groups
        if len(self.groups) != 1:
            raise _NoFit("%d groups" % len(self.groups))
        shape, ops = self.groups[0]
        av = chain.avals
        for op in ops:
            if op.prim not in _POINTWISE:
                raise _NoFit("%s is not pointwise" % op.prim)
            for i in op.ins:
                if i not in chain.literals and av[i].shape != shape \
                        and _numel(av[i].shape) != 1:
                    raise _NoFit("operand %r of %s broadcasts"
                                 % (av[i].shape, op.prim))
        self.n = _numel(shape)
        self.threads = threads or FLAT_THREADS
        self.per_thread = per_thread or FLAT_PER_THREAD
        if self.threads % 32 or not 32 <= self.threads <= _MAX_THREADS \
                or self.per_thread % 4 or self.per_thread <= 0:
            raise ValueError("flat plan at %d threads x %d elements: "
                             "threads a multiple of 32 up to %d, "
                             "elements a multiple of 4"
                             % (self.threads, self.per_thread, _MAX_THREADS))
        if self.n >= 2 ** 30:
            raise _NoFit("%d elements past the kernel's int index" % self.n)
        span = self.threads * self.per_thread
        self.grid = max(1, -(-self.n // span))
        # externals of the group's shape (the rest are single elements)
        self.full = [i for i in chain.ext_in + chain.ext_out
                     if av[i].shape == shape]
        # float4 / int4 runs where every such external is 4 bytes wide
        self.vector = all(av[i].dtype.itemsize == 4 for i in self.full)
        self.offset = {}
        self.ws_bytes, self.ws_shared, self.smem_bytes = 0, True, 0
        self.cluster = 1


def _step(prim, dtype):
    return lambda acc, x: _reduce_step(prim, acc, x, dtype)


class _RowPlan:
    """How a chain runs on the row plan: rows owned by warps, spread over
    a thread-block cluster.

    The row axes are all axes but the last of the chain's widest value
    (the first by id among the widest), the columns its last axis.  A
    value is *full* (row axes, then the columns), *row* (row axes, then
    nothing or 1: one value per row) or *cross* (anything else: column
    vectors, scalars, ...).  A cluster of ``cluster`` CTAs owns the rows
    in contiguous blocks; each warp of a CTA owns whole rows (rows
    ``lo + warp + k * warps``); lanes stride over the columns.  Full and
    row values live in registers; a reduction over the last axis is a
    shuffle tree inside the warp; a cross value that is not a reduction
    over rows is read element by element where it is used (inputs,
    literals and what every thread can compute from them); a reduction
    over rows is summed per warp in registers, per CTA over the warps
    through shared memory, and over the cluster in rank order through
    distributed shared memory (an *exchange*).

    ``phase`` of each row-local op and reduction input is the number of
    exchanges before it: an op waits only for the reductions over rows
    it reads.  ``levels`` counts the dataflow's row crossings (a
    reduction over rows, or a row-local op reading a cross value an op
    made): the chain's shape, which the phases refine.

    Raises :class:`_NoFit` for a chain outside these rules."""

    name = "rows"

    def __init__(self, chain, cluster=None):
        av, lits = chain.avals, chain.literals
        self.chain = chain
        made = {op.outs[0]: op for op in chain.ops}
        ids = sorted(set(chain.ext_in) | set(made))
        widest = max(ids, key=lambda i: (_numel(av[i].shape), -i))
        shape = av[widest].shape
        if len(shape) < 2:
            raise _NoFit("a 1-D chain has no row axes")
        self.row_shape, self.cols = tuple(shape[:-1]), int(shape[-1])
        self.n_rows = _numel(self.row_shape)
        nr = len(self.row_shape)
        self.cls = {}
        for i in ids:
            s = av[i].shape
            if s[:nr] != self.row_shape:
                self.cls[i] = "cross"
            elif len(s) == nr or (len(s) == nr + 1 and s[-1] == 1):
                self.cls[i] = "row"
            elif len(s) == nr + 1 and s[-1] == self.cols:
                self.cls[i] = "full"
            else:
                raise _NoFit("value %d of shape %r is neither a row value "
                             "nor a cross-row one" % (i, s))
        self.made = made
        self.reduced = {}       # value -> (op, kept-row extent K, columns C')
        self.ex = {}            # value -> exchanges before it exists
        self.phase = {}         # row-local op / reduction -> its phase
        for op in chain.ops:
            out = op.outs[0]
            ins = [i for i in op.ins if i not in lits]
            ex = max([self.ex.get(i, 0) for i in ins] or [0])
            kinds = [self.cls[i] for i in ins]
            if op.prim in _REDUCES and self._reduces_rows(op):
                x = op.ins[0]
                if x in lits or self.cls[x] == "cross":
                    raise _NoFit("eqn %r reduces a cross-row value" % out)
                axes = sorted(_dims(op.params, "axes"))
                row_axes = [a for a in axes if a < nr]
                if row_axes != list(range(len(row_axes))):
                    raise _NoFit("eqn %r keeps a leading row axis" % out)
                kept = _numel(self.row_shape[len(row_axes):])
                cp = self.cols if (self.cls[x] == "full"
                                   and nr not in axes) else 1
                self.reduced[out] = (op, kept, cp)
                self.phase[out] = ex
                self.ex[out] = ex + 1
                continue
            self.ex[out] = ex
            if self.cls[out] == "cross":
                if "full" in kinds or "row" in kinds:
                    raise _NoFit("eqn %r makes a cross-row value from a "
                                 "row value" % out)
                if op.prim in _REDUCES and _dims(op.params, "axes"):
                    raise _NoFit("eqn %r reduces a cross-row value" % out)
                continue
            self._check_row_op(op)
            self.phase[out] = ex
        self.n_phases = max(self.phase.values(), default=0) + 1
        self.exchanges = len({self.phase[v] for v in self.reduced})
        self.read_later = {v for v in self.reduced
                           if any(v in o.ins for o in chain.ops)}
        # row-local values read in a later phase than their own
        self.carried = set()
        for op in chain.ops:
            p = self.phase.get(op.outs[0])
            if p is None or op.outs[0] in self.reduced:
                continue
            for i in op.ins:
                if self.cls.get(i) in ("full", "row") and i in self.phase \
                        and self.phase[i] < p:
                    self.carried.add(i)
        self.levels = self._levels()
        self._place(cluster)

    def _reduces_rows(self, op):
        return any(a < len(self.row_shape)
                   for a in _dims(op.params, "axes"))

    def _check_row_op(self, op):
        """A row-local op reads row values of its own row only."""
        av, nr = self.chain.avals, len(self.row_shape)
        p, out = op.prim, op.outs[0]
        rowed = [i for i in op.ins if self.cls.get(i) in ("full", "row")]
        if p in _REDUCES:
            axes = _dims(op.params, "axes")
            if axes and (tuple(axes) != (nr,) or self.cls[out] != "row"):
                raise _NoFit("eqn %r reduces a row otherwise than over "
                             "its last axis" % out)
        elif p == "broadcast_in_dim":
            bd = _dims(op.params, "broadcast_dimensions")
            if rowed and tuple(bd[:nr]) != tuple(range(nr)):
                raise _NoFit("eqn %r broadcasts a row value across rows"
                             % out)
        elif p in ("squeeze", "expand_dims"):
            if not rowed or tuple(_dims(op.params, "dimensions")) != (nr,):
                raise _NoFit("eqn %r reshapes a value into rows" % out)
        elif p not in _POINTWISE:
            raise _NoFit("eqn %r: %s on row values" % (out, p))
        for i in rowed:
            if self.cls[out] == "row" and self.cls[i] == "full" \
                    and p not in _REDUCES:
                raise _NoFit("eqn %r reads a full row into a row value"
                             % out)
            if p in _POINTWISE and len(av[i].shape) != len(av[out].shape):
                raise _NoFit("eqn %r mixes ranks" % out)

    def _levels(self):
        lits, lvl = self.chain.literals, {}
        for op in self.chain.ops:
            out, level = op.outs[0], 0
            for i in op.ins:
                if i in lits:
                    continue
                crosses = (self.cls[i] != "cross"
                           and self.cls[out] == "cross") or (
                    self.cls[i] == "cross" and i in self.made
                    and self.cls[out] != "cross")
                level = max(level, lvl.get(i, 0) + crosses)
            lvl[out] = level
        return max(lvl.values()) + 1 if lvl else 1

    def _split(self, cluster):
        """(rows per CTA, warps per CTA, rows per warp) at ``cluster``."""
        per_cta = -(-self.n_rows // cluster)
        warps = min(32, per_cta)
        return per_cta, warps, -(-per_cta // warps)

    def fits(self, cluster):
        """Why ``cluster`` CTAs cannot own these rows, or None."""
        if cluster not in _ROW_CLUSTERS or cluster > self.n_rows:
            return "cluster %r is not one of %s at %d rows" % (
                cluster, _ROW_CLUSTERS, self.n_rows)
        _, warps, per_warp = self._split(cluster)
        for v, (_, kept, _) in self.reduced.items():
            if kept > 1 and per_warp > 1 and warps % kept:
                return ("reduction %d keeps %d row slots, which %d warps "
                        "of %d rows do not own whole" % (v, kept, warps,
                                                         per_warp))
        return None

    def _place(self, cluster):
        if cluster is None:
            fitting = [c for c in _ROW_CLUSTERS if self.fits(c) is None]
            if not fitting:
                raise _NoFit("no cluster size owns whole row slots")
            cluster = next((c for c in fitting
                            if -(-self.n_rows // c) <= 32), fitting[-1])
        why = self.fits(cluster)
        if why:
            raise _NoFit(why)
        self.cluster = cluster
        self.rows_per_cta, self.warps, self.rows_per_warp = \
            self._split(cluster)
        self.threads = 32 * self.warps
        self.cpl = -(-self.cols // 32)
        av = self.chain.avals
        self.offset, top = {}, 0
        for v, (op, kept, cp) in self.reduced.items():
            size = av[v].dtype.itemsize
            regions = [("pw", self.warps * cp * size),
                       ("pc", kept * cp * size)]
            if v in self.read_later:
                regions.append(("rf", kept * cp * size))
            for tag, nbytes in regions:
                self.offset[(tag, v)] = top
                top += -(-nbytes // 16) * 16
        self.smem_bytes = top
        self.ws_bytes, self.ws_shared = 0, True


def _tileable_ir(chain):
    """The reference's flat_tileable rule (a pure elementwise chain whose
    externals share one 1-D shape), plus: every value the chain makes
    has that shape, so one flat index drives the whole body."""
    if chain.kind != "elementwise":
        return False
    shapes = {chain.avals[i].shape for i in chain.ext_in + chain.ext_out}
    if len(shapes) != 1:
        return False
    (shape,) = shapes
    if len(shape) != 1:
        return False
    allowed = _ELEMENTWISE_BINOPS | _ELEMENTWISE_UNOPS | _IDENTITY \
        | {"convert_element_type"}
    return all(op.prim in allowed and chain.avals[op.outs[0]].shape == shape
               for op in chain.ops)


def _pow2_reciprocal(chain, i):
    """``1 / c`` when value ``i`` is a float32 literal ``c = ±2^k`` whose
    reciprocal is a normal float32: dividing by ``c`` and multiplying by
    ``1 / c`` then round the same real number, so they agree bitwise
    (zeros, infinities and NaNs included)."""
    if i not in chain.literals:
        return None
    c = np.float32(np.asarray(chain.literals[i]).reshape(()))
    if not np.isfinite(c) or c == 0 or abs(np.frexp(c)[0]) != 0.5:
        return None
    r = np.float32(1) / c
    return r if abs(r) >= np.finfo(np.float32).tiny else None


def _pointwise_rhs(chain, op, operand):
    """RHS of a pointwise eqn; ``operand(i, as_dtype)`` is the expression
    of operand ``i`` (``as_dtype``: the dtype a literal beside it takes)."""
    av = chain.avals
    p, dtype = op.prim, av[op.outs[0]].dtype
    if p in _ELEMENTWISE_BINOPS:
        dt = [av[i].dtype for i in op.ins if i not in chain.literals]
        dt = dt[0] if dt else av[op.ins[0]].dtype
        a, b = (operand(i, dt) for i in op.ins)
        recip = _pow2_reciprocal(chain, op.ins[1]) \
            if p == "div" and dt == np.float32 else None
        if recip is not None:   # x / 2^k == x * 2^-k, bitwise
            return _emit_binop("mul", a, _c_literal(recip, dt), dt)
        return _emit_binop(p, a, b, dt)
    if p in _ELEMENTWISE_UNOPS:
        return _emit_unop(p, operand(op.ins[0]), av[op.ins[0]].dtype)
    if p in _IDENTITY:
        return operand(op.ins[0])
    if p == "integer_pow":
        return _emit_integer_pow(operand(op.ins[0]), int(op.params["y"]),
                                 dtype)
    if p == "convert_element_type":
        return _emit_convert(operand(op.ins[0]), av[op.ins[0]].dtype, dtype)
    if p == "select_n":
        args = [operand(i) for i in op.ins]
        pred, cases = args[0], args[1:]
        if av[op.ins[0]].dtype == np.bool_:
            return "(%s ? %s : %s)" % (pred, cases[1], cases[0])
        rhs = cases[-1]
        for k in range(len(cases) - 2, -1, -1):
            rhs = "(%s == %d ? %s : %s)" % (pred, k, cases[k], rhs)
        return rhs
    raise _Unsupported(p)


class _Body:
    """Emits the statements of one group's loop body."""

    def __init__(self, chain, plan, lines, indent, o="o"):
        self.chain, self.plan, self.lines = chain, plan, lines
        self.pad, self.o = " " * indent, o
        self.local = set()

    def memory(self, i):
        c = self.chain
        if i in c.ext_in:
            return "in%d" % c.ext_in.index(i)
        if i in c.ext_out:
            return "out%d" % c.ext_out.index(i)
        if i in self.plan.offset:
            return "((%s*)(ws + %d))" % (_ctype(c.avals[i].dtype),
                                         self.plan.offset[i])
        raise _Unsupported("value %d has no storage" % i)

    def operand(self, i, out_shape, as_dtype=None):
        """Expression of operand ``i`` at the output index, loading it
        into a register the first time the group needs it."""
        c = self.chain
        if i in c.literals:
            return _c_literal(c.literals[i],
                              as_dtype if as_dtype is not None
                              else c.avals[i].dtype)
        if i in self.local:
            return "v%d" % i
        shape = c.avals[i].shape
        if shape == out_shape or _numel(shape) == 1:
            idx = self.o if shape == out_shape else "0"
            self.lines.append("%sconst %s v%d = %s[%s];"
                              % (self.pad, _ctype(c.avals[i].dtype), i,
                                 self.memory(i), idx))
            self.local.add(i)
            return "v%d" % i
        # an equal-rank operand with size-1 dims (lax broadcasts those)
        return "%s[%s]" % (self.memory(i),
                           _index_map(out_shape, shape,
                                      tuple(range(len(shape))), self.o))

    def emit(self, op):
        c, av = self.chain, self.chain.avals
        out = op.outs[0]
        shape, dtype = av[out].shape, av[out].dtype
        p = op.prim
        if p in _POINTWISE:
            rhs = _pointwise_rhs(c, op, lambda i, dt=None:
                                 self.operand(i, shape, dt))
        elif p == "broadcast_in_dim":
            i = op.ins[0]
            if i in c.literals:
                rhs = _c_literal(c.literals[i], av[i].dtype)
            else:
                rhs = "%s[%s]" % (self.memory(i), _index_map(
                    shape, av[i].shape,
                    _dims(op.params, "broadcast_dimensions"), self.o))
        elif p in ("squeeze", "expand_dims"):
            rhs = "%s[%s]" % (self.memory(op.ins[0]), self.o)
        elif p in _REDUCES:
            rhs = self.reduce(op)
        else:
            raise _Unsupported(p)
        self.lines.append("%sconst %s v%d = %s;"
                          % (self.pad, _ctype(dtype), out, rhs))
        self.local.add(out)
        if out in c.ext_out:
            self.lines.append("%s%s[%s] = v%d;"
                              % (self.pad, self.memory(out), self.o, out))
        elif out in self.plan.offset:
            self.lines.append("%s%s[%s] = v%d;"
                              % (self.pad, self.memory(out), self.o, out))

    def reduce(self, op):
        """A fixed-order loop over the reduced axes, no atomics."""
        c, av = self.chain, self.chain.avals
        i = op.ins[0]
        if i in c.literals:
            raise _Unsupported("reduction of a literal")
        src_shape, dtype = av[i].shape, av[i].dtype
        axes = sorted(_dims(op.params, "axes"))
        si = _strides(src_shape)
        kept = [d for d in range(len(src_shape)) if d not in axes]
        base = _decode(self.o, tuple(src_shape[d] for d in kept),
                       [si[d] for d in kept])
        if not axes:
            return "%s[%s]" % (self.memory(i), base)
        acc, pad, j = "acc%d" % op.outs[0], self.pad, []
        self.lines.append("%s%s %s = %s;" % (pad, _ctype(dtype), acc,
                                             _REDUCE_INIT[op.prim](dtype)))
        self.lines.append("%sconst int base%d = %s;"
                          % (pad, op.outs[0], base))
        for k, d in enumerate(axes):
            self.lines.append("%s%sfor (int j%d = 0; j%d < %d; ++j%d)"
                              % (pad, "  " * k, k, k, src_shape[d], k))
            j.append("j%d" % k if si[d] == 1 else "j%d * %d" % (k, si[d]))
        x = "%s[base%d + %s]" % (self.memory(i), op.outs[0], " + ".join(j))
        self.lines.append("%s%s%s = %s;" % (pad, "  " * len(axes), acc,
                                            _reduce_step(op.prim, acc, x,
                                                         dtype)))
        return acc


class _FlatBody(_Body):
    """The flat plan's body for one element ``j`` of a thread's run of
    16-byte accesses: the externals of the group's shape sit in the
    thread's registers (``x<k>`` inputs, ``y<k>`` outputs), loaded and
    stored around the run; single elements are read from memory."""

    def __init__(self, chain, plan, lines, indent):
        super().__init__(chain, plan, lines, indent, o="j")

    def memory(self, i):
        c = self.chain
        if i in self.plan.full:
            return ("x%d" % c.ext_in.index(i) if i in c.ext_in
                    else "y%d" % c.ext_out.index(i))
        return super().memory(i)


_ROW_CUTS = frozenset({"exchange", "shuffles", "loads"})


class _RowBody:
    """Emits the row plan's kernel: per phase, each warp's loop over its
    rows, then the exchange of the reductions over rows.

    ``cuts`` (measurement only, :mod:`mxnet_tpu_torch.tools.
    codegen_ablate`; the outputs are then wrong by design) leaves a part
    out: ``"exchange"`` the cluster barrier and the reads of the other
    CTAs' partials, ``"shuffles"`` the shuffle trees, ``"loads"`` the
    loads of the full inputs (each replaced by its row and column)."""

    def __init__(self, chain, plan, cuts=()):
        self.chain, self.plan, self.cuts = chain, plan, frozenset(cuts)
        self.lines = []

    # -- expressions -------------------------------------------------------
    def cross(self, i, idx, as_dtype=None):
        """Expression of element ``idx`` (a C expression of the flat index
        into ``i``'s shape) of cross-row value ``i``."""
        c, pl = self.chain, self.plan
        if i in c.literals:
            return _c_literal(c.literals[i], as_dtype if as_dtype is not None
                              else c.avals[i].dtype)
        if i in c.ext_in:
            return "in%d[%s]" % (c.ext_in.index(i), idx)
        if i in pl.reduced:
            return "rf%d[%s]" % (i, idx)
        op, shape = pl.made[i], c.avals[i].shape
        p = op.prim
        if p == "broadcast_in_dim":
            j = op.ins[0]
            return self.cross(j, _index_map(
                shape, c.avals[j].shape,
                _dims(op.params, "broadcast_dimensions"), "(%s)" % idx))
        if p in ("squeeze", "expand_dims") or p in _REDUCES:
            return self.cross(op.ins[0], idx)   # (a reduction of no axes)

        def operand(j, dt=None):
            s = c.avals[j].shape
            return self.cross(j, _index_map(shape, s, tuple(range(len(s))),
                                            "(%s)" % idx), dt)
        return "(%s)" % _pointwise_rhs(c, op, operand)

    def value(self, i, out, as_dtype=None, bdims=None):
        """Expression of operand ``i`` inside the row body of the op
        making ``out`` (``[j]``: the lane's column slot); a cross-row
        operand is read at the element of ``i`` that the output element
        sees (``bdims``: a broadcast's dimensions, else equal ranks)."""
        c, pl = self.chain, self.plan
        kind = pl.cls.get(i)
        if kind == "full":
            return "v%d[j]" % i
        if kind == "row":
            return "v%d" % i
        s = c.avals[i].shape
        o = "(row * %d + col)" % pl.cols if pl.cls[out] == "full" else "row"
        return self.cross(i, _index_map(
            c.avals[out].shape, s,
            tuple(range(len(s))) if bdims is None else bdims, o), as_dtype)

    # -- statements --------------------------------------------------------
    def full(self, pad, name, dtype, rhs, store=None):
        """A full value: one register per column slot of the lane."""
        pl = self.plan
        guard = "if (col < %d) " % pl.cols if pl.cols % 32 else ""
        self.lines += [
            "%s%s %s[%d];" % (pad, _ctype(dtype), name, pl.cpl),
            "%s#pragma unroll" % pad,
            "%sfor (int j = 0; j < %d; ++j) {" % (pad, pl.cpl),
            "%s  const int col = lane + 32 * j;" % pad,
            "%s  %s{" % (pad, guard),
            "%s    %s[j] = %s;" % (pad, name, rhs)]
        if store:
            self.lines.append("%s    %s = %s[j];" % (pad, store, name))
        self.lines += ["%s  }" % pad, "%s}" % pad]

    def tree(self, pad, prim, dtype, acc, src):
        """``acc`` = the reduction of full value ``src`` over the row: the
        lane's columns in order, then a fixed ``__shfl_xor_sync`` tree
        (every lane ends with the same value)."""
        pl = self.plan
        guard = "if (lane + 32 * j < %d) " % pl.cols if pl.cols % 32 else ""
        step = _step(prim, dtype)
        self.lines += [
            "%s%s %s = %s;" % (pad, _ctype(dtype), acc,
                               _REDUCE_INIT[prim](dtype)),
            "%s#pragma unroll" % pad,
            "%sfor (int j = 0; j < %d; ++j) %s%s = %s;"
            % (pad, pl.cpl, guard, acc, step(acc, "%s[j]" % src))]
        if "shuffles" in self.cuts:
            return
        # each lane shuffles before it combines: a bool's || or && would
        # skip the shuffle on some lanes, which every lane must reach
        cast = "(int)" if dtype == np.bool_ else ""
        back = "(bool)" if dtype == np.bool_ else ""
        for m in (16, 8, 4, 2, 1):
            self.lines.append(
                "%s{ const %s o = %s__shfl_xor_sync(0xffffffffu, %s%s, %d); "
                "%s = %s; }" % (pad, _ctype(dtype), back, cast, acc, m, acc,
                                step(acc, "o")))

    def row_op(self, op, pad):
        c, pl, av = self.chain, self.plan, self.chain.avals
        out, p = op.outs[0], op.prim
        dtype = av[out].dtype
        store = None
        if out in c.ext_out:
            store = "out%d[row * %d + col]" % (c.ext_out.index(out), pl.cols)
        if p in _REDUCES and _dims(op.params, "axes"):
            x = op.ins[0]
            if pl.cls[x] == "full":
                self.tree(pad, p, dtype, "t%d" % out, "v%d" % x)
                rhs = "t%d" % out
            else:
                rhs = "v%d" % x         # over a size-1 last axis
        elif p in _REDUCES or p in ("squeeze", "expand_dims"):
            rhs = self.value(op.ins[0], out)
        elif p == "broadcast_in_dim":
            rhs = self.value(op.ins[0], out, bdims=_dims(
                op.params, "broadcast_dimensions"))
        else:
            rhs = _pointwise_rhs(c, op, lambda i, dt=None:
                                 self.value(i, out, dt))
        if pl.cls[out] == "full":
            self.full(pad, "v%d" % out, dtype, rhs, store)
        else:
            self.lines.append("%sconst %s v%d = %s;" % (pad, _ctype(dtype),
                                                       out, rhs))
            if out in c.ext_out:
                self.lines.append("%sif (lane == 0) out%d[row] = v%d;"
                                  % (pad, c.ext_out.index(out), out))
        if out in pl.carried:
            if pl.cls[out] == "full":
                self.lines.append("%sfor (int j = 0; j < %d; ++j) x%d[k][j] "
                                  "= v%d[j];" % (pad, pl.cpl, out, out))
            else:
                self.lines.append("%sx%d[k] = v%d;" % (pad, out, out))

    def contribute(self, v, pad):
        """Adds this row's part of reduction-over-rows ``v`` to the warp's
        accumulator ``a<v>``."""
        pl, av = self.plan, self.chain.avals
        op, _, cp = pl.reduced[v]
        x, dtype = op.ins[0], av[v].dtype
        step = _step(op.prim, dtype)
        if cp > 1:                      # per column: the lane's slots
            self.lines.append("%sfor (int j = 0; j < %d; ++j) a%d[j] = %s;"
                              % (pad, pl.cpl, v,
                                 step("a%d[j]" % v, "v%d[j]" % x)))
            return
        part = "v%d" % x                # per row: one value
        if pl.cls[x] == "full":
            part = "t%d" % v
            self.tree(pad, op.prim, dtype, part, "v%d" % x)
        self.lines.append("%sa%d[0] = %s;" % (pad, v, step("a%d[0]" % v,
                                                           part)))

    def load(self, i, pad):
        """A row-local input of the row, into registers."""
        c, pl = self.chain, self.plan
        k, dtype = c.ext_in.index(i), c.avals[i].dtype
        if pl.cls[i] == "full":
            src = "in%d[row * %d + col]" % (k, pl.cols)
            if "loads" in self.cuts:
                src = "(%s)(row + col)" % _ctype(dtype)
            self.full(pad, "v%d" % i, dtype, src)
        else:
            self.lines.append("%sconst %s v%d = in%d[row];"
                              % (pad, _ctype(dtype), i, k))

    def phase(self, p):
        """Phase ``p``: each warp's rows, then the exchange of the
        reductions over rows whose inputs it makes."""
        c, pl, av = self.chain, self.plan, self.chain.avals
        L = self.lines
        ops = [op for op in c.ops if pl.phase.get(op.outs[0]) == p]
        reds = [op.outs[0] for op in ops if op.outs[0] in pl.reduced]
        L.append("  // phase %d: %d eqn(s) over the rows%s"
                 % (p, len(ops), ", then %d reduction(s) over rows"
                    % len(reds) if reds else ""))
        for v in reds:
            _, _, cp = pl.reduced[v]
            n = pl.cpl if cp > 1 else 1
            init = _REDUCE_INIT[pl.reduced[v][0].prim](av[v].dtype)
            L.append("  %s a%d[%d] = {%s};" % (_ctype(av[v].dtype), v, n,
                                               ", ".join([init] * n)))
        used = {i for op in ops for i in op.ins}
        loads = [i for i in c.ext_in if i in used and pl.cls[i] != "cross"]
        reload = sorted(i for i in pl.carried if i in used
                        and pl.phase[i] < p)
        unroll = "#pragma unroll" if pl.carried else "#pragma unroll 1"
        L += ["  %s" % unroll,
              "  for (int k = 0; k < %d; ++k) {" % pl.rows_per_warp,
              "    const int row = lo + warp + k * %d;" % pl.warps,
              "    if (row < hi) {"]
        pad = " " * 6
        for i in loads:
            self.load(i, pad)
        for i in reload:
            dt = _ctype(av[i].dtype)
            if pl.cls[i] == "full":
                L.append("%s%s v%d[%d];" % (pad, dt, i, pl.cpl))
                L.append("%sfor (int j = 0; j < %d; ++j) v%d[j] = x%d[k][j];"
                         % (pad, pl.cpl, i, i))
            else:
                L.append("%sconst %s v%d = x%d[k];" % (pad, dt, i, i))
        for op in ops:
            if op.outs[0] in pl.reduced:
                self.contribute(op.outs[0], pad)
            else:
                self.row_op(op, pad)
        L += ["    }", "  }"]
        if reds:
            self.exchange(reds, p == pl.n_phases - 1)

    def exchange(self, reds, last):
        """Warp partials -> CTA partials (in warp order) -> the cluster's
        sum (in rank order, every CTA alike); a value no later phase reads
        has its output slots split over the ranks.  Each step is one loop
        over every reduction's slots, each reduction on warps of its own."""
        c, pl, av = self.chain, self.plan, self.chain.avals
        L, cs, nt = self.lines, pl.cluster, pl.threads
        for v in reds:
            _, _, cp = pl.reduced[v]
            if cp > 1:
                g = "if (lane + 32 * j < %d) " % pl.cols if pl.cols % 32 \
                    else ""
                L.append("  for (int j = 0; j < %d; ++j) %spw%d[warp * %d + "
                         "lane + 32 * j] = a%d[j];" % (pl.cpl, g, v, cp, v))
            else:
                L.append("  if (lane == 0) pw%d[warp] = a%d[0];" % (v, v))
        L.append("  __syncthreads();")

        def combine(v):
            op, kept, cp = pl.reduced[v]
            dt = av[v].dtype
            step = _step(op.prim, dt)
            out = ["%s a = %s;" % (_ctype(dt), _REDUCE_INIT[op.prim](dt))]
            if kept > 1:
                out.append("const int c = s %% %d;" % cp)
                out.append("for (int w = ((s / %d - lo) %% %d + %d) %% %d; "
                           "w < %d; w += %d) a = %s;"
                           % (cp, kept, kept, kept, pl.warps, kept,
                              step("a", "pw%d[w * %d + c]" % (v, cp))))
            else:
                out.append("for (int w = 0; w < %d; ++w) a = %s;"
                           % (pl.warps, step("a", "pw%d[w * %d + s]"
                                             % (v, cp))))
            out.append("pc%d[s] = a;" % v)
            return out

        self.segments([(v, pl.reduced[v][1] * pl.reduced[v][2], "i",
                        combine(v)) for v in reds])
        remote = cs > 1 and "exchange" not in self.cuts
        L.append("  cluster.sync();" if remote else "  __syncthreads();")

        def final(v):
            op, _, _ = pl.reduced[v]
            dt = av[v].dtype
            step = _step(op.prim, dt)
            if remote:
                out = ["%s a = cluster.map_shared_rank(pc%d, 0)[s];"
                       % (_ctype(dt), v), "#pragma unroll",
                       "for (int q = 1; q < %d; ++q) a = %s;"
                       % (cs, step("a", "cluster.map_shared_rank(pc%d, q)[s]"
                                   % v))]
            else:
                out = ["const %s a = pc%d[s];" % (_ctype(dt), v)]
            if v in pl.read_later:
                out.append("rf%d[s] = a;" % v)
            if v in c.ext_out:
                guard = "if (s %% %d == rank) " % cs \
                    if v in pl.read_later and cs > 1 else ""
                out.append("%sout%d[s] = a;" % (guard, c.ext_out.index(v)))
            return out

        segs = []
        for v in reds:
            n = pl.reduced[v][1] * pl.reduced[v][2]
            if v in pl.read_later:
                segs.append((v, n, "i", final(v)))
            else:      # this rank's slots: rank, rank + cs, ...
                segs.append((v, -(-n // cs), "rank + %d * i" % cs,
                             ["if (s >= %d) continue;" % n] + final(v)
                             if n % cs else final(v)))
        self.segments(segs)
        if not last:
            L.append("  __syncthreads();")

    def segments(self, segs):
        """One loop of the CTA's threads over the slots of several
        reductions, each reduction's range 32-aligned (a warp works on one
        reduction): ``segs`` holds (value, indices, the slot ``s`` of
        index ``i``, the statements for slot ``s``)."""
        L, nt = self.lines, self.plan.threads
        total = sum(-(-n // 32) * 32 for _, n, _, _ in segs)
        L.append("  for (int e = threadIdx.x; e < %d; e += %d) {"
                 % (total, nt))
        base = 0
        for k, (v, n, slot, body) in enumerate(segs):
            span = -(-n // 32) * 32
            L.append("    %sif (e < %d) {" % ("} else " if k else "",
                                             base + span))
            L.append("      const int i = e - %d;" % base)
            if span != n:
                L.append("      if (i >= %d) continue;" % n)
            L.append("      const int s = %s;" % slot)
            L += ["      " + ln for ln in body]
            base += span
        L += ["    }", "  }"]

    def cross_outputs(self, p):
        """Cross-row outputs that are not reductions over rows, written
        by the cluster's threads together once they can be computed."""
        c, pl = self.chain, self.plan
        for v in c.ext_out:
            if pl.cls.get(v) != "cross" or v in pl.reduced \
                    or pl.ex.get(v, 0) != p:
                continue
            n = max(1, _numel(c.avals[v].shape))
            self.lines.append(
                "  for (int e = rank * %d + threadIdx.x; e < %d; e += %d) "
                "out%d[e] = %s;" % (pl.threads, n, pl.cluster * pl.threads,
                                    c.ext_out.index(v), self.cross(v, "e")))


def _emit_rows(chain, name, plan, cuts=()):
    """The row plan's CUDA text: one kernel over a cluster of
    ``plan.cluster`` CTAs, and its ``<symbol>_whole`` launcher."""
    if set(cuts) - _ROW_CUTS:
        raise ValueError("unknown cuts %s" % sorted(set(cuts) - _ROW_CUTS))
    sym = symbol_of(name)
    pl, av = plan, chain.avals
    ins, outs = _params(chain)
    b = _RowBody(chain, plan, cuts)
    L = b.lines
    L += _header(chain) + [
          "// Plan: rows.  %d rows %r x %d columns over a cluster of %d "
          "CTA(s): %d rows" % (pl.n_rows, pl.row_shape, pl.cols, pl.cluster,
                               pl.rows_per_cta),
          "// per CTA, %d warps of %d row(s) each, %d column(s) per lane; "
          "%d levels, %d phase(s)," % (pl.warps, pl.rows_per_warp, pl.cpl,
                                       pl.levels, pl.n_phases),
          "// %d exchange(s) of reductions over rows, %d B of shared "
          "memory, no workspace." % (pl.exchanges, pl.smem_bytes)]
    if cuts:
        L.append("// Ablation (wrong outputs by design): cut %s."
                 % ", ".join(sorted(cuts)))
    L += ["#include <cooperative_groups.h>", _PRELUDE.rstrip("\n"), ""]
    L.append("__global__ void __launch_bounds__(%d) %s_k(%s)"
             % (pl.threads, sym, ", ".join(ins + outs)))
    L.append("{")
    if pl.smem_bytes:
        L.append("  extern __shared__ __align__(16) unsigned char smem[];")
    for (tag, v), off in sorted(pl.offset.items(), key=lambda kv: kv[1]):
        L.append("  %s* const %s%d = (%s*)(smem + %d);"
                 % (_ctype(av[v].dtype), tag, v, _ctype(av[v].dtype), off))
    L += ["  cooperative_groups::cluster_group cluster = "
          "cooperative_groups::this_cluster();",
          "  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;",
          "  const int rank = (int)cluster.block_rank();",
          "  const int lo = rank * %d, hi = min(lo + %d, %d);"
          % (pl.rows_per_cta, pl.rows_per_cta, pl.n_rows)]
    L.append("  (void)lane; (void)hi;")
    for i in sorted(pl.carried):
        if pl.cls[i] == "full":
            L.append("  %s x%d[%d][%d];" % (_ctype(av[i].dtype), i,
                                            pl.rows_per_warp, pl.cpl))
        else:
            L.append("  %s x%d[%d];" % (_ctype(av[i].dtype), i,
                                        pl.rows_per_warp))
    for p in range(pl.n_phases):
        b.cross_outputs(p)
        b.phase(p)
    if pl.exchanges and pl.cluster > 1 and "exchange" not in cuts:
        L.append("  cluster.sync();   // no CTA leaves while another reads "
                 "its shared memory")
    L.append("}")
    opt_in = pl.smem_bytes > _SMEM_BYTES
    L += ["", "extern \"C\" int %s_whole(void* const* ins, void* const* "
          "outs, void* ws_g, void* stream) {" % sym,
          "  (void)ws_g;"]
    if opt_in:
        L += ["  static bool opted = false;",
              "  if (!opted) {",
              "    const cudaError_t e = cudaFuncSetAttribute(%s_k, "
              "cudaFuncAttributeMaxDynamicSharedMemorySize, %d);"
              % (sym, pl.smem_bytes),
              "    if (e != cudaSuccess) return (int)e;",
              "    opted = true;",
              "  }"]
    L += ["  cudaLaunchConfig_t cfg = {};",
          "  cfg.gridDim = dim3(%d);" % pl.cluster,
          "  cfg.blockDim = dim3(%d);" % pl.threads,
          "  cfg.dynamicSmemBytes = %d;" % pl.smem_bytes,
          "  cfg.stream = (cudaStream_t)stream;",
          "  cudaLaunchAttribute attr[1];",
          "  attr[0].id = cudaLaunchAttributeClusterDimension;",
          "  attr[0].val.clusterDim.x = %d;" % pl.cluster,
          "  attr[0].val.clusterDim.y = 1;",
          "  attr[0].val.clusterDim.z = 1;",
          "  cfg.attrs = attr;",
          "  cfg.numAttrs = 1;",
          "  const cudaError_t e = cudaLaunchKernelEx(&cfg, %s_k, %s);"
          % (sym, ", ".join(_casts(chain))),
          "  return (int)(e != cudaSuccess ? e : cudaGetLastError());", "}"]
    return "\n".join(L) + "\n"


def symbol_of(name):
    """The C symbol prefix of a generated kernel's launchers."""
    return "mxgen_" + name.strip("_")


def _params(chain):
    ins = ["const %s* __restrict__ in%d" % (_ctype(chain.avals[i].dtype), k)
           for k, i in enumerate(chain.ext_in)]
    outs = ["%s* __restrict__ out%d" % (_ctype(chain.avals[i].dtype), k)
            for k, i in enumerate(chain.ext_out)]
    return ins, outs


def _casts(chain):
    ins = ["(const %s*)ins[%d]" % (_ctype(chain.avals[i].dtype), k)
           for k, i in enumerate(chain.ext_in)]
    outs = ["(%s*)outs[%d]" % (_ctype(chain.avals[i].dtype), k)
            for k, i in enumerate(chain.ext_out)]
    return ins + outs


def _header(chain):
    return ["// mxgen: %s chain of %d eqns (tape %s, rank %d) - %d B fused "
            "vs %d B unfused." % (chain.kind, len(chain.ops), chain.tag,
                                 chain.rank, chain.fused_bytes,
                                 chain.unfused_bytes),
            "// Emitted by mxnet_tpu_torch/analysis/codegen.py; the "
            "Hopper counterpart of the",
            "// Pallas body mxnet_tpu/analysis/codegen.py lower_chain "
            "emits for generated_call."]


def _emit_tiled(chain, sym, plan):
    """The row-tiled kernel (flat-tileable chains): one block per
    ``(block_rows, 128)`` tile of the zero-padded flat arrays."""
    ins, outs = _params(chain)
    lines = ["", "// the row-tiled path: one block per (block_rows, "
             "%d) tile of the zero-padded flat arrays" % TILE_COLS,
             "__global__ void __launch_bounds__(%d) %s_tiled_k(%s, "
             "int tile)" % (_TILED_THREADS, sym, ", ".join(ins + outs)),
             "{",
             "  const int first = blockIdx.x * tile;",
             "  for (int t = threadIdx.x; t < tile; t += %d) {"
             % _TILED_THREADS,
             "    const int o = first + t;"]
    body = _Body(chain, plan, lines, 4)
    for op in chain.ops:
        body.emit(op)
    lines += ["  }", "}", "",
              "extern \"C\" int %s_tiled(void* const* ins, void* const* "
              "outs, int grid, int block_rows, void* stream) {" % sym,
              "  %s_tiled_k<<<grid, %d, 0, (cudaStream_t)stream>>>(%s, "
              "block_rows * %d);" % (sym, _TILED_THREADS,
                                     ", ".join(_casts(chain)), TILE_COLS),
              "  return (int)cudaGetLastError();", "}"]
    return lines


def _emit_cuda(chain, name, plan, tileable, why=None):
    """The group plan's CUDA text (``why``: what keeps the chain off the
    row plan)."""
    sym = symbol_of(name)
    ins, outs = _params(chain)
    lines = _header(chain) + [
        "// Plan: groups%s.  One block, %d threads, %d groups,"
        % (" (%s)" % why if why else "", plan.threads, len(plan.groups)),
        "// workspace %d B in %s memory."
        % (plan.ws_bytes, "shared" if plan.ws_shared else "global"),
        _PRELUDE.rstrip("\n"), ""]
    lines.append("__global__ void __launch_bounds__(%d) %s_k(%s)"
                 % (plan.threads, sym, ", ".join(
                     ins + outs + ["unsigned char* __restrict__ ws_g"])))
    lines.append("{")
    if plan.ws_bytes and plan.ws_shared:
        lines.append("  extern __shared__ __align__(16) unsigned char "
                     "ws[];")
    elif plan.ws_bytes:
        lines.append("  unsigned char* const ws = ws_g;")
    for g, (shape, ops) in enumerate(plan.groups):
        if g:
            lines.append("  __syncthreads();")
        lines.append("  // group %d: %d eqn(s) over %r"
                     % (g, len(ops), tuple(shape)))
        lines.append("  for (int o = threadIdx.x; o < %d; o += %d) {"
                     % (_numel(shape), plan.threads))
        body = _Body(chain, plan, lines, 4)
        for op in ops:
            body.emit(op)
        lines.append("  }")
    lines.append("}")
    smem = plan.ws_bytes if plan.ws_shared else 0
    lines += ["", "extern \"C\" int %s_whole(void* const* ins, void* const* "
              "outs, void* ws_g, void* stream) {" % sym,
              "  %s_k<<<1, %d, %d, (cudaStream_t)stream>>>(%s, "
              "(unsigned char*)ws_g);"
              % (sym, plan.threads, smem, ", ".join(_casts(chain))),
              "  return (int)cudaGetLastError();", "}"]
    if tileable:
        lines += _emit_tiled(chain, sym, plan)
    return "\n".join(lines) + "\n"


def _emit_flat(chain, name, plan, tileable, why=None):
    """The flat plan's CUDA text: a grid of ``plan.grid`` blocks; thread
    ``t`` of block ``b`` takes elements ``(b * threads + t) * per_thread``
    onward.  A whole run with every operand 16-byte aligned moves as
    float4 / int4 (``vec``, decided by the launcher from the pointers);
    the tail and unaligned operands go element by element.  Both evaluate
    the group plan's per-element arithmetic, so the outputs are bitwise
    the group plan's."""
    sym = symbol_of(name)
    av, pl = chain.avals, plan
    ins, outs = _params(chain)
    (shape, ops), = pl.groups
    e = pl.per_thread
    lines = _header(chain) + [
        "// Plan: flat%s.  A grid of %d blocks of %d threads over %d "
        "elements," % (" (%s)" % why if why else "", pl.grid, pl.threads,
                       pl.n),
        "// %d consecutive elements a thread, %s; no barrier, no "
        "workspace." % (e, "16-byte accesses where the operands are "
                        "aligned" if pl.vector else "element by element"),
        _PRELUDE.rstrip("\n"), ""]
    lines.append("__global__ void __launch_bounds__(%d) %s_k(%s)"
                 % (pl.threads, sym, ", ".join(ins + outs + ["int vec"])))
    lines.append("{")
    lines.append("  const int first = (blockIdx.x * %d + threadIdx.x) * %d;"
                 % (pl.threads, e))
    lines.append("  if (first >= %d) return;" % pl.n)
    if pl.vector:
        lines.append("  if (vec && first + %d <= %d) {" % (e, pl.n))
        vec4 = {np.dtype(np.float32): "float4", np.dtype(np.int32): "int4"}
        for k, i in enumerate(chain.ext_in):
            if i not in pl.full:
                continue
            ct, vt = _ctype(av[i].dtype), vec4[np.dtype(av[i].dtype)]
            lines.append("    %s x%d[%d];" % (ct, k, e))
            for q in range(0, e, 4):
                lines.append(
                    "    { const %s t = *reinterpret_cast<const %s*>(in%d + "
                    "first + %d); x%d[%d] = t.x; x%d[%d] = t.y; x%d[%d] = "
                    "t.z; x%d[%d] = t.w; }"
                    % (vt, vt, k, q, k, q, k, q + 1, k, q + 2, k, q + 3))
        for k, i in enumerate(chain.ext_out):
            lines.append("    %s y%d[%d];" % (_ctype(av[i].dtype), k, e))
        lines.append("#pragma unroll")
        lines.append("    for (int j = 0; j < %d; ++j) {" % e)
        body = _FlatBody(chain, pl, lines, 6)
        for op in ops:
            body.emit(op)
        lines.append("    }")
        for k, i in enumerate(chain.ext_out):
            vt = vec4[np.dtype(av[i].dtype)]
            for q in range(0, e, 4):
                lines.append(
                    "    *reinterpret_cast<%s*>(out%d + first + %d) = "
                    "make_%s(y%d[%d], y%d[%d], y%d[%d], y%d[%d]);"
                    % (vt, k, q, vt, k, q, k, q + 1, k, q + 2, k, q + 3))
        lines.append("    return;")
        lines.append("  }")
    lines.append("  for (int o = first; o < first + %d && o < %d; ++o) {"
                 % (e, pl.n))
    body = _Body(chain, pl, lines, 4)
    for op in ops:
        body.emit(op)
    lines.append("  }")
    lines.append("}")
    full = [("ins[%d]" % chain.ext_in.index(i)) if i in chain.ext_in
            else ("outs[%d]" % chain.ext_out.index(i)) for i in pl.full]
    aligned = " && ".join("((size_t)%s & 15) == 0" % p for p in full) \
        if pl.vector and full else "0"
    lines += ["", "extern \"C\" int %s_whole(void* const* ins, void* const* "
              "outs, void* ws_g, void* stream) {" % sym,
              "  const int vec = %s;" % aligned,
              "  %s_k<<<%d, %d, 0, (cudaStream_t)stream>>>(%s, vec);"
              % (sym, pl.grid, pl.threads, ", ".join(_casts(chain))),
              "  return (int)cudaGetLastError();", "}"]
    if tileable:
        lines += _emit_tiled(chain, sym, pl)
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------
class LoweredKernel:
    """One chain lowered to CUDA source + its cost contract.

    ``src`` is None when the chain is not provably lowerable — the GEN001
    findings say why; the byte model carries over either way."""

    __slots__ = ("name", "tag", "rank", "src", "ext_in", "ext_out",
                 "in_avals", "out_avals", "kind", "prims", "n_ops",
                 "scale", "unfused_bytes", "fused_bytes", "bytes_saved",
                 "bytes_read", "bytes_written", "flops", "transcendentals",
                 "findings", "chain", "symbol", "threads", "ws_bytes",
                 "ws_shared", "tileable", "plan", "cluster", "layout")

    def as_plan(self):
        return {
            "name": self.name,
            "tape": self.tag,
            "rank": int(self.rank),
            "kind": self.kind,
            "n_ops": int(self.n_ops),
            "prims": sorted(set(self.prims)),
            "n_inputs": len(self.ext_in),
            "n_outputs": len(self.ext_out),
            "unfused_bytes": int(self.unfused_bytes),
            "fused_bytes": int(self.fused_bytes),
            "bytes_saved": int(self.bytes_saved),
            "lowerable": self.src is not None,
            "plan": self.plan,
            "cluster": self.cluster,
            "findings": [f.rule_id for f in self.findings],
            "src": self.src,
        }


def lower_chain(ir, name=None, plan=None, cluster=None, cuts=(),
                flat=None):
    """Lower one chain of the IR (a :class:`Chain` or its JSON dict) into
    a :class:`LoweredKernel`.  The emitted text is deterministic in the
    chain: ops in tape order, externals in the IR's order, literals
    inlined exactly; ``()`` externals ride as ``(1,)`` buffers.

    The plan is chosen here, from the chain's shapes alone, and recorded
    (``plan``, ``cluster``, the header comment, :meth:`as_plan`): the row
    plan (:class:`_RowPlan`) where the chain fits it, at the cluster size
    :data:`ROW_CLUSTER` pins for its name (else the smallest that gives a
    CTA at most 32 rows); else the flat plan (:class:`_FlatPlan`) where
    the group plan would be one group of pointwise eqns, at
    :data:`FLAT_THREADS` x :data:`FLAT_PER_THREAD`; the group plan
    (:class:`_Plan`) otherwise.  ``plan`` ("rows" / "groups"),
    ``cluster`` (the row plan at that size) and ``flat`` (``(threads,
    elements a thread)``: the flat plan at that size) force a choice,
    raising where the chain does not fit it, and ``cuts`` leaves parts of
    a row-plan kernel out (``flat``, ``cuts``: measurement only,
    ``tools/codegen_ablate.py``)."""
    chain = Chain.from_json(ir)
    lk = LoweredKernel()
    lk.name = name or chain.name
    lk.tag = chain.tag
    lk.rank = chain.rank
    lk.kind = chain.kind
    lk.prims = chain.prims
    lk.n_ops = len(chain.ops)
    lk.chain = chain
    for k in _COST_KEYS:
        setattr(lk, k, getattr(chain, k))
    lk.scale = lk.scale or 1
    lk.ext_in, lk.ext_out = list(chain.ext_in), list(chain.ext_out)
    lk.in_avals = [chain.avals[i] for i in chain.ext_in]
    lk.out_avals = [chain.avals[i] for i in chain.ext_out]
    lk.symbol = symbol_of(lk.name)
    lk.findings = []
    lk.src, lk.threads, lk.ws_bytes, lk.ws_shared = None, 0, 0, True
    lk.tileable = False
    lk.plan, lk.cluster, lk.layout = None, None, None
    for k, op in enumerate(chain.ops):
        if op.prim not in LOWERABLE:
            lk.findings.append(Finding(
                "GEN001", lk.name,
                "chain op %r (eqn %d) is outside the provable-lowering "
                "set — mxgen refuses to guess its semantics; the chain "
                "stays a hand-written-kernel candidate" % (op.prim, k)))
        elif len(op.outs) != 1:
            lk.findings.append(Finding(
                "GEN001", lk.name,
                "chain op %r has %d outputs — the lowering only proves "
                "single-output eqns" % (op.prim, len(op.outs))))
        elif not _eqn_avals_consistent(chain, op):
            lk.findings.append(Finding(
                "GEN001", lk.name,
                "chain eqn %d (%r) has dataflow the lowering cannot "
                "prove: the recorded operand/result avals do not "
                "re-infer through the plain evaluator — the chain "
                "stays a hand-written-kernel candidate" % (k, op.prim)))
    if lk.findings:
        return lk
    if plan not in (None, "rows", "groups"):
        raise ValueError("plan %r: 'rows' or 'groups'" % (plan,))
    if flat is not None and (plan is not None or cluster is not None):
        raise ValueError("flat=%r forces the flat plan: no plan or "
                         "cluster beside it" % (flat,))
    try:
        layout, why = None, None
        if plan != "groups":
            try:
                layout = _RowPlan(chain, cluster or ROW_CLUSTER.get(lk.name))
            except _NoFit as e:
                if plan == "rows" or cluster is not None:
                    raise ValueError("%s does not fit the row plan: %s"
                                     % (lk.name, e))
                why = "no row plan: %s" % (e,)
        if layout is not None and flat is not None:
            raise ValueError("%s takes the row plan, not the flat plan"
                             % lk.name)
        if layout is not None:
            lk.src = _emit_rows(chain, lk.name, layout, cuts)
        else:
            layout = _Plan(chain)
            lk.tileable = _tileable_ir(chain)
            if plan is None:
                try:
                    layout = _FlatPlan(chain, layout, *(flat or ()))
                except _NoFit as e:
                    if flat is not None:
                        raise ValueError("%s does not fit the flat plan: "
                                         "%s" % (lk.name, e))
            emit = _emit_flat if layout.name == "flat" else _emit_cuda
            lk.src = emit(chain, lk.name, layout, lk.tileable, why)
    except _Unsupported as e:
        lk.findings.append(Finding(
            "GEN001", lk.name,
            "the CUDA emitter has no form for %s — the chain stays a "
            "hand-written-kernel candidate" % (e,)))
        lk.tileable = False
        return lk
    lk.threads, lk.ws_bytes, lk.ws_shared = (layout.threads,
                                             layout.ws_bytes,
                                             layout.ws_shared)
    lk.plan, lk.cluster, lk.layout = layout.name, layout.cluster, layout
    return lk


# ---------------------------------------------------------------------------
# seeded inputs, the twin's outputs, the equivalence check
# ---------------------------------------------------------------------------
def seeded_inputs(avals, seed):
    """Deterministic host arrays for a list of avals — the reference's
    recipe (``mxnet_tpu/analysis/codegen.py:408``), bitwise."""
    rs = np.random.RandomState(seed)
    out = []
    for aval in avals:
        shape = tuple(getattr(aval, "shape", ()))
        dt = np.dtype(aval.dtype)
        if dt == np.bool_:
            out.append(rs.rand(*shape) > 0.5)
        elif np.issubdtype(dt, np.integer):
            out.append(rs.randint(0, 5, size=shape).astype(dt))
        else:
            out.append(rs.standard_normal(shape).astype(dt))
    return out


def reference_outputs(lk, inputs):
    """The twin: interpret the chain's eqns op by op in plain PyTorch, on
    the inputs' device (every intermediate materializes)."""
    chain = lk.chain
    xs = [torch.as_tensor(x) for x in inputs]
    device = xs[0].device if xs else torch.device("cpu")
    env = dict(zip(chain.ext_in, xs))
    for op in chain.ops:
        env[op.outs[0]] = _prim_eval(op.prim, _operands(chain, op, env,
                                                        device), op.params)
    return [env[i] for i in chain.ext_out]


def compare_outputs(got, want, tol=EQUIV_TOL):
    """(ok, max_abs_err): floats at ``tol`` (rtol = atol), ints and bools
    exactly; a shape or dtype mismatch fails with an infinite error."""
    ok, max_err = True, 0.0
    for g, w in zip(got, want):
        g, w = torch.as_tensor(g).cpu(), torch.as_tensor(w).cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            return False, float("inf")
        if g.is_floating_point():
            if g.numel():
                max_err = max(max_err, float((g.double() - w.double())
                                             .abs().max()))
            if not torch.allclose(g, w, rtol=tol, atol=tol):
                ok = False
        elif not torch.equal(g, w):
            ok, max_err = False, float("inf")
    return ok, max_err


def equivalence_check(lk, device=None, seed=EQUIV_SEED, tol=EQUIV_TOL,
                      block_rows=None):
    """(ok, max_abs_err): the emitted kernel against the twin on the
    same seeded inputs on ``device`` (default: the card).  Only a CUDA
    device runs the emitted CUDA: off the card a generated kernel's call
    IS the twin, so there is nothing to compare and the result is
    ``(None, None)`` — unproven, never passed."""
    from ..base import resolve_device
    from ..ops import generated_kernels as gen

    if lk.src is None:
        return False, float("inf")
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None, None
    inputs = [torch.as_tensor(x).to(dev)
              for x in seeded_inputs(lk.in_avals, seed)]
    got = gen.generated_call(gen.GeneratedKernel(lk), *inputs,
                             block_rows=block_rows)
    return compare_outputs(got, reference_outputs(lk, inputs), tol)


# ---------------------------------------------------------------------------
# autotune: seeded, measured on the device, disk-cached, replayed bitwise
# ---------------------------------------------------------------------------
def flat_tileable(lk):
    """True when the kernel can run row-tiled over a ``(rows, 128)``
    grid: a pure elementwise chain whose externals (and values) all
    share one 1-D shape — padding rows are computed and discarded."""
    return lk.src is not None and bool(lk.tileable)


def _cache_valid(obj, seed, ladder):
    return (isinstance(obj, dict)
            and obj.get("schema") == AUTOTUNE_CACHE_SCHEMA
            and obj.get("seed") == seed
            and obj.get("ladder") == list(ladder)
            and isinstance(obj.get("kernels"), dict))


def _load_cache(path, seed, ladder):
    try:
        with open(path, "r", encoding="utf-8") as f:
            obj = json.load(f)
    except (OSError, ValueError):
        return None
    return obj if _cache_valid(obj, seed, ladder) else None


def _call_ns(fn, dev):
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return int(start.elapsed_time(end) * 1e6)
    t0 = time.perf_counter_ns()
    fn()
    return time.perf_counter_ns() - t0


def autotune_block_rows(gk, cache_path=None, seed=AUTOTUNE_SEED,
                        ladder=AUTOTUNE_LADDER, reps=AUTOTUNE_REPS,
                        device=None):
    """Pick block rows for a flat-tileable generated kernel.

    A valid cache (schema + seed + ladder match, choice on the ladder) is
    REPLAYED — no measurement, no rewrite, so two runs sharing a cache
    file agree bitwise.  A corrupt or mismatched cache is rebuilt from
    fresh measurements.  The winner is the median of ``reps`` timed tiled
    calls on seeded inputs (CUDA events on the card, the host clock on
    the CPU), the smallest rung on ties."""
    from ..base import resolve_device
    from ..ops import generated_kernels as gen

    cache_path = cache_path or os.environ.get("MXTPU_MXGEN_CACHE")
    cached = _load_cache(cache_path, seed, ladder) if cache_path else None
    if cached is not None:
        entry = cached["kernels"].get(gk.name)
        if isinstance(entry, dict) and entry.get("block_rows") in ladder:
            return int(entry["block_rows"])

    dev = resolve_device(device)
    inputs = [torch.as_tensor(x).to(dev)
              for x in seeded_inputs(gk.in_avals, seed)]
    times = []
    for br in ladder:
        def call(br=br):
            gen.generated_call(gk, *inputs, block_rows=br)
        call()                          # warm: first launch, allocations
        samples = sorted(_call_ns(call, dev) for _ in range(reps))
        times.append(samples[len(samples) // 2])
    best = ladder[times.index(min(times))]

    if cache_path:
        obj = cached or {"schema": AUTOTUNE_CACHE_SCHEMA, "seed": seed,
                         "ladder": list(ladder), "kernels": {}}
        obj["kernels"][gk.name] = {"block_rows": int(best),
                                   "t_ns": [int(t) for t in times]}
        tmp = cache_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps(obj, indent=2, sort_keys=True) + "\n")
        os.replace(tmp, cache_path)
    return int(best)


# ---------------------------------------------------------------------------
# the shipped chains: top-3 of the transformer train-step and ZeRO-1
# tapes, from the checked-in IR
# ---------------------------------------------------------------------------
_LOWERED_MEMO = {}


def shipped_lowered():
    """LoweredKernels of the shipped chains, in (tape, rank) order —
    names ``_gen_<tape>_top<rank>`` (memoized per process)."""
    if "all" not in _LOWERED_MEMO:
        _LOWERED_MEMO["all"] = [lower_chain(c) for c in load_ir()]
    return _LOWERED_MEMO["all"]


def shipped_chain_rows():
    """{kernel name: bytes_saved} of the shipped chains."""
    return {lk.name: int(lk.bytes_saved) for lk in shipped_lowered()}


def codegen_plans():
    """Deterministic lowered plan per shipped chain."""
    return [lk.as_plan() for lk in shipped_lowered()]


def render_codegen(plans=None):
    plans = codegen_plans() if plans is None else plans
    lines = ["mxgen: %d shipped chain(s) lowered" % len(plans)]
    for p in plans:
        lines.append(
            "  %-28s %-18s %4d ops  %2d in /%2d out  saves %10d B  %s"
            % (p["name"], "%s#%d:%s" % (p["tape"], p["rank"], p["kind"]),
               p["n_ops"], p["n_inputs"], p["n_outputs"],
               p["bytes_saved"],
               "ok" if p["lowerable"] else ",".join(p["findings"])))
        if p["src"]:
            for ln in p["src"].rstrip("\n").splitlines():
                lines.append("    | " + ln)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the GEN-rule lint
# ---------------------------------------------------------------------------
def lint_generated_kernels(disable=(), device=None):
    """GEN sweep: every shipped chain must lower inside the provable set
    (GEN001), and every REGISTERED generated kernel must carry a passing
    equivalence check (GEN002).  Only a run on the card can pass that
    check, so off the card every registered kernel is GEN002 unproven."""
    from ..ops import generated_kernels as gen

    findings = []
    try:
        gen.build_shipped_generated(device=device)
    except Exception as e:  # noqa: BLE001 — a broken build IS the finding
        findings.append(Finding(
            "GEN001", "codegen",
            "building the shipped generated kernels failed: %r — the "
            "top chains cannot be proven lowerable" % (e,)))
        return filter_findings(findings, disable)
    for lk in shipped_lowered():
        findings.extend(lk.findings)
    for name in sorted(gen.GENERATED_KERNELS):
        gk = gen.GENERATED_KERNELS[name]
        if gk.equivalence_ok:
            continue
        if gk.equivalence_err is None:
            why = ("unproven: emitted CUDA runs only on the card, and no "
                   "run there has compared it with the twin")
        else:
            why = ("its equivalence check failed (emitted kernel vs the "
                   "twin at %g, max |diff| %g)" % (EQUIV_TOL,
                                                   gk.equivalence_err))
        findings.append(Finding(
            "GEN002", name,
            "generated kernel %r is registered without a passing "
            "equivalence check: %s — an unproven lowering must not ship"
            % (name, why)))
    return filter_findings(findings, disable)
