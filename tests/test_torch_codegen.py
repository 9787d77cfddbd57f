"""The mxgen tier of the port (B10): ``mxnet_tpu_torch/analysis/codegen.py``
lowers the reference's six shipped fusion chains into CUDA C++,
``mxnet_tpu_torch/ops/generated_kernels.py`` runs them (whole-array and
row-tiled), and ``mxnet_tpu_torch/codegen_bench.py`` is the entry point.

The chains reach the port as ``mxnet_tpu_torch/analysis/shipped_chains.json``.
This file exports the reference's ``shipped_lowered()`` into that IR in a
SUBPROCESS (``python tests/test_torch_codegen.py --export <path> [--npz
<path>]`` under ``JAX_PLATFORMS=cpu``), together with the reference's
outputs on the seeded inputs: ``reference_outputs`` and
``generated_call(interpret=True)`` of every chain whole-array, and of the
flat-tileable chain at every ladder rung.  Only that subprocess aliases
``jax.core.Literal``/``ClosedJaxpr`` from ``jax.extend.core`` (where the
installed jax lacks them) and fills the reference's memo tables; the
pytest process never does, so no reference test sharing a worker sees a
different process.

On the CPU the port's kernels run their plain PyTorch twin, held here
against the reference within 1e-5 (ints and bools exact).  The emitted
CUDA runs only on the card: ``python3 chip_smoke.py`` (phases 15-16) and
the ``cuda``-marked test below hold it against the twin there.

Regenerate the IR with
``python tests/test_torch_codegen.py --export mxnet_tpu_torch/analysis/shipped_chains.json``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, REPO)        # run as a script: import from the repo

PARAM_KEYS = ("axes", "shape", "broadcast_dimensions", "y", "new_dtype",
              "dimensions")
COST_KEYS = ("scale", "unfused_bytes", "fused_bytes", "bytes_saved",
             "bytes_read", "bytes_written", "flops", "transcendentals")


# ---------------------------------------------------------------------------
# the export (runs in a subprocess only)
# ---------------------------------------------------------------------------
def _alias_jax_core():
    import jax
    import jax.extend.core as jec
    for name in ("Literal", "ClosedJaxpr"):
        if not hasattr(jax.core, name):
            setattr(jax.core, name, getattr(jec, name))


def _ir_param(key, v):
    if key == "new_dtype":
        return str(np.dtype(v))
    if key == "y":
        return int(v)
    return [int(d) for d in (v or ())]


def _ir_literal(v):
    v = np.asarray(v)
    flat = v.reshape(-1)
    if v.dtype == np.float32:
        vals = ["0x%08x" % b for b in flat.view(np.uint32).tolist()]
    elif v.dtype == np.bool_:
        vals = [bool(b) for b in flat.tolist()]
    else:
        vals = [int(b) for b in flat.tolist()]
    return {"dtype": str(v.dtype), "shape": list(v.shape), "values": vals}


def _ir_chain(cg, lk):
    """One reference LoweredKernel as IR.  Value ids are renumbered by
    their rank among the ids the chain touches, which keeps the
    reference's sorted order and drops the tape's global numbering."""
    tape = lk.tape
    ops = [tape.ops[i] for i in lk.chain.op_indices]
    touched = set(lk.ext_in) | set(lk.ext_out)
    for op in ops:
        touched.update(op.in_ids)
        touched.update(op.out_ids)
    canon = {orig: k for k, orig in enumerate(sorted(touched))}
    avals, literals = {}, {}
    for orig in sorted(touched):
        aval = tape.avals[orig]
        dtype = str(np.dtype(aval.dtype))
        if orig in tape.literal_ids:
            # the value as the reference's twin reads it (its dtype
            # canonical, so a weak Python int is the int32 it computes in)
            lit = _ir_literal(np.asarray(cg._literal_val(tape, orig)))
            literals[str(canon[orig])] = lit
            dtype = lit["dtype"]
        avals[str(canon[orig])] = [[int(d) for d in aval.shape], dtype]
    chain = {
        "name": lk.name, "tag": lk.tag, "rank": int(lk.rank),
        "kind": lk.kind, "n_ops": int(lk.n_ops),
        "ext_in": [canon[i] for i in lk.ext_in],
        "ext_out": [canon[i] for i in lk.ext_out],
        "avals": avals, "literals": literals,
        "ops": [{"prim": op.prim, "in": [canon[i] for i in op.in_ids],
                 "out": [canon[i] for i in op.out_ids],
                 "params": {k: _ir_param(k, op.params[k])
                            for k in PARAM_KEYS if k in op.params}}
                for op in ops],
    }
    chain.update({k: int(getattr(lk, k)) for k in COST_KEYS})
    return chain


def dump_ir(doc):
    """The IR's text: deterministic, one op / value / literal a line."""
    def block(items, pad):
        return ("\n" + pad).join(items)

    out = ['{', ' "chains": [']
    for ci, c in enumerate(doc["chains"]):
        fields = []
        for k in sorted(c):
            v = c[k]
            if k in ("avals", "literals") and v:
                body = block(['%s: %s' % (json.dumps(i), json.dumps(
                    v[i], sort_keys=True)) for i in sorted(v, key=int)],
                    "    ")
                fields.append('   %s: {\n    %s}' % (json.dumps(k),
                                                    body.replace(
                                                        "\n    ",
                                                        ",\n    ")))
            elif k == "ops":
                body = ",\n    ".join(json.dumps(op, sort_keys=True)
                                      for op in v)
                fields.append('   "ops": [\n    %s]' % body)
            else:
                fields.append('   %s: %s' % (json.dumps(k),
                                             json.dumps(v, sort_keys=True)))
        out.append('  {\n' + ",\n".join(fields) + '\n  }'
                   + (',' if ci < len(doc["chains"]) - 1 else ''))
    out.append(' ],')
    out.append(' "jax": %s,' % json.dumps(doc["jax"]))
    out.append(' "schema": %d,' % doc["schema"])
    out.append(' "source": %s' % json.dumps(doc["source"]))
    out.append('}')
    return "\n".join(out) + "\n"


def export(json_path, npz_path=None):
    """Write the IR of the reference's shipped chains (and, with
    ``npz_path``, the reference's outputs on the seeded inputs)."""
    _alias_jax_core()
    import jax
    from mxnet_tpu.analysis import codegen as cg

    lowered = cg.shipped_lowered()
    doc = {"schema": 1, "jax": jax.__version__,
           "source": "mxnet_tpu.analysis.codegen.shipped_lowered()",
           "chains": [_ir_chain(cg, lk) for lk in lowered]}
    with open(json_path, "w", encoding="utf-8") as f:
        f.write(dump_ir(doc))
    if npz_path is None:
        return
    from mxnet_tpu.ops import generated_kernels as gen

    unfused = sum(lk.unfused_bytes for lk in lowered)
    saved = sum(lk.bytes_saved for lk in lowered)
    arrays = {"modeled_bytes_saved_pct": np.float64(
        round(100.0 * saved / unfused, 2) if unfused else 0.0)}
    kernels = {gk.name: gk for gk in gen.build_shipped_generated()}
    for lk in lowered:
        inputs = cg.seeded_inputs(lk.in_avals, cg.EQUIV_SEED)
        runs = {"ref": cg.reference_outputs(lk, inputs),
                "whole": gen.generated_call(kernels[lk.name], *inputs,
                                            interpret=True)}
        if cg.flat_tileable(lk):
            for br in cg.AUTOTUNE_LADDER:
                runs["tiled%d" % br] = gen.generated_call(
                    kernels[lk.name], *inputs, interpret=True,
                    block_rows=br)
        for k, x in enumerate(inputs):
            arrays["%s/in/%d" % (lk.name, k)] = np.asarray(x)
        for run, outs in runs.items():
            for k, x in enumerate(outs):
                arrays["%s/%s/%d" % (lk.name, run, k)] = np.asarray(x)
    np.savez(npz_path, **arrays)



# ---------------------------------------------------------------------------
# the tests (the pytest process imports the port and jax, never the
# reference's codegen: the reference's side arrives through the export)
# ---------------------------------------------------------------------------
import torch  # noqa: E402

from mxnet_tpu_torch import codegen_bench  # noqa: E402
from mxnet_tpu_torch.analysis import codegen as cg  # noqa: E402
from mxnet_tpu_torch.analysis.cost import KERNEL_COSTS  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops import generated_kernels as gen  # noqa: E402

FLOAT_TOL = cg.EQUIV_TOL   # allclose(rtol = atol = 1e-5), the reference's
SHIPPED_NAMES = [
    "_gen_tp_transformer_top1", "_gen_tp_transformer_top2",
    "_gen_tp_transformer_top3", "_gen_zero1_top1", "_gen_zero1_top2",
    "_gen_zero1_top3",
]
TILEABLE = "_gen_zero1_top2"


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    """One export of the reference, in a subprocess (about 20 s)."""
    out = tmp_path_factory.mktemp("mxgen_export")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("MXTPU_MXGEN_CACHE", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--export",
         str(out / "chains.json"), "--npz", str(out / "ref.npz")],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return out


@pytest.fixture(scope="module")
def ref(export_dir):
    with np.load(str(export_dir / "ref.npz")) as d:
        return {k: d[k] for k in d.files}


def _lowered(name):
    return {lk.name: lk for lk in cg.shipped_lowered()}[name]


def _assert_matches(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
        if np.issubdtype(w.dtype, np.floating):
            assert np.allclose(g, w, rtol=FLOAT_TOL, atol=FLOAT_TOL), \
                (what, k, float(np.abs(g.astype("f8") - w).max()))
        else:
            assert np.array_equal(g, w), (what, k)


def _outputs(ref, name, run):
    n = len(_lowered(name).ext_out)
    return [ref["%s/%s/%d" % (name, run, k)] for k in range(n)]


def _without_jax_line(text):
    """The IR's text but its one top-level ``"jax"`` line (the version
    the export ran under), and that version."""
    lines = text.splitlines(keepends=True)
    tagged = [ln for ln in lines if ln.startswith(' "jax": ')]
    assert len(tagged) == 1, tagged
    version = json.loads(tagged[0].split(":", 1)[1].strip().rstrip(","))
    return "".join(ln for ln in lines if ln is not tagged[0]), version


def test_checked_in_ir_equals_a_fresh_export(export_dir):
    """Byte for byte, except the line naming the jax version: the IR
    checked in under one jax must equal a fresh export under the jax
    installed here, so a version whose tapes differ fails by name."""
    with open(str(export_dir / "chains.json"), encoding="utf-8") as f:
        fresh, fresh_jax = _without_jax_line(f.read())
    with open(cg.SHIPPED_IR, encoding="utf-8") as f:
        shipped, shipped_jax = _without_jax_line(f.read())
    assert fresh == shipped, (
        "the IR checked in under jax %s differs from a fresh export under "
        "jax %s: regenerate with python tests/test_torch_codegen.py "
        "--export mxnet_tpu_torch/analysis/shipped_chains.json"
        % (shipped_jax, fresh_jax))
    assert [c.name for c in cg.load_ir()] == SHIPPED_NAMES


@pytest.mark.parametrize("name", SHIPPED_NAMES)
def test_seeded_inputs_bitwise_equal_the_reference(ref, name):
    lk = _lowered(name)
    ours = cg.seeded_inputs(lk.in_avals, cg.EQUIV_SEED)
    assert len(ours) == len(lk.ext_in)
    for k, x in enumerate(ours):
        want = ref["%s/in/%d" % (name, k)]
        assert x.dtype == want.dtype and x.shape == want.shape
        assert np.array_equal(x, want), (name, k)


@pytest.mark.parametrize("name", SHIPPED_NAMES)
def test_whole_array_twin_matches_the_reference(ref, name):
    """The port's CPU path (the twin) against the reference's tape
    interpreter and its Pallas kernel in interpret mode.  The kernel
    stays unproven: off the card its call is the twin itself."""
    gk = gen.build_shipped_generated(device="cpu")[SHIPPED_NAMES.index(name)]
    assert gk.name == name
    assert not gk.equivalence_ok and gk.equivalence_err is None
    assert cg.equivalence_check(gk.lowered, "cpu") == (None, None)
    xs = [torch.from_numpy(x) for x in
          cg.seeded_inputs(gk.in_avals, cg.EQUIV_SEED)]
    got = gen.generated_call(gk, *xs)
    _assert_matches(got, _outputs(ref, name, "ref"), (name, "ref"))
    _assert_matches(got, _outputs(ref, name, "whole"), (name, "pallas"))


@pytest.mark.parametrize("block_rows", cg.AUTOTUNE_LADDER)
def test_tiled_twin_matches_the_reference_at_every_rung(ref, block_rows):
    gk = {g.name: g for g in gen.build_shipped_generated(device="cpu")}[
        TILEABLE]
    assert [lk.name for lk in cg.shipped_lowered()
            if cg.flat_tileable(lk)] == [TILEABLE]
    xs = [torch.from_numpy(x) for x in
          cg.seeded_inputs(gk.in_avals, cg.EQUIV_SEED)]
    got = gen.generated_call(gk, *xs, block_rows=block_rows)
    _assert_matches(got, _outputs(ref, TILEABLE, "tiled%d" % block_rows),
                    (TILEABLE, block_rows))
    _assert_matches(got, [t.numpy() for t in gen.generated_call(gk, *xs)],
                    (TILEABLE, "whole"))


def test_codegen_bench_cpu_keys_and_modeled_pct(ref, capsys):
    assert codegen_bench.main(["--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == {
        "codegen_n_kernels", "codegen_modeled_bytes_saved_pct",
        "codegen_unfused_ms", "codegen_fused_ms",
        "codegen_generated_speedup", "codegen_numerics_max_err",
        "codegen_numerics_ok", "device"}
    assert rec["device"] == "cpu" and rec["codegen_n_kernels"] == 6
    # no emitted kernel ran: nothing proven, nothing claimed
    assert rec["codegen_numerics_ok"] is None
    assert rec["codegen_numerics_max_err"] is None
    assert rec["codegen_modeled_bytes_saved_pct"] == float(
        ref["modeled_bytes_saved_pct"])


# ---------------------------------------------------------------------------
# the emitter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", SHIPPED_NAMES)
def test_emitted_cuda_is_deterministic(name):
    chain = {c.name: c for c in cg.load_ir()}[name]
    a, b = cg.lower_chain(chain), cg.lower_chain(cg.load_ir()[
        SHIPPED_NAMES.index(name)])
    assert a.findings == [] and a.src is not None
    assert a.src == b.src and a.src == _lowered(name).src
    assert (a.ext_in, a.ext_out) == (b.ext_in, b.ext_out)
    assert '%s_whole(' % a.symbol in a.src
    assert ('%s_tiled(' % a.symbol in a.src) == (name == TILEABLE)


@pytest.mark.parametrize("name", SHIPPED_NAMES)
def test_seam_changes_the_text_of_chains_with_a_sub_only(name, monkeypatch):
    chain = cg.load_ir()[SHIPPED_NAMES.index(name)]
    exact = cg.lower_chain(chain).src
    monkeypatch.setattr(cg, "MXGEN_LOWER_EXACT", False)
    mutated = cg.lower_chain(chain).src
    assert (mutated != exact) == ("sub" in chain.prims)
    # only the subtractions change: f32 __fsub_rn, int32 " - "
    assert "__fsub_rn" not in mutated
    assert mutated.count("__fadd_rn") == exact.count("__fadd_rn") \
        + exact.count("__fsub_rn")
    monkeypatch.undo()
    assert cg.lower_chain(chain).src == exact


def test_literals_are_exact_float32_constants():
    src = _lowered(TILEABLE).src
    # 0.9f and 0.1f by bit pattern, never a double literal
    assert "__uint_as_float(0x3f666666u)" in src
    assert "__uint_as_float(0x3dcccccdu)" in src
    assert "0.9" not in src and "0.1" not in src


# ---------------------------------------------------------------------------
# the twin against jax.lax, prim by prim (the semantics the chains need)
# ---------------------------------------------------------------------------
def _lax_cases():
    import jax.numpy as jnp
    from jax import lax
    rs = np.random.RandomState(3)
    f = rs.standard_normal((4, 32)).astype(np.float32)
    g = rs.standard_normal((4, 32)).astype(np.float32)
    f[0, 0], g[1, 1] = np.nan, np.nan
    pred = rs.rand(4, 32) > 0.5
    i = rs.randint(-7, 8, (4, 32)).astype(np.int32)
    j = rs.randint(1, 5, (4, 32)).astype(np.int32)
    return {
        "select_n": ("select_n", [pred, f, g], {},
                     lambda: lax.select_n(pred, f, g)),
        "max_nan": ("max", [f, g], {}, lambda: lax.max(f, g)),
        "min_nan": ("min", [f, g], {}, lambda: lax.min(f, g)),
        "div_int": ("div", [i, j], {}, lambda: lax.div(i, j)),
        "rem_int": ("rem", [i, j], {}, lambda: lax.rem(i, j)),
        "integer_pow_2": ("integer_pow", [f], {"y": 2},
                          lambda: lax.integer_pow(f, 2)),
        "integer_pow_3": ("integer_pow", [f], {"y": 3},
                          lambda: lax.integer_pow(f, 3)),
        "bool_to_f32": ("convert_element_type", [pred],
                        {"new_dtype": "float32"},
                        lambda: lax.convert_element_type(pred, jnp.float32)),
        "and_bool": ("and", [pred, ~pred[::-1]], {},
                     lambda: lax.bitwise_and(pred, ~pred[::-1])),
        "ge_int": ("ge", [i, j], {}, lambda: lax.ge(i, j)),
        "bcast_4x32_to_4x32x32": (
            "broadcast_in_dim", [f], {"shape": [4, 32, 32],
                                      "broadcast_dimensions": [0, 1]},
            lambda: lax.broadcast_in_dim(f, (4, 32, 32), (0, 1))),
        "bcast_32_to_1x1x32": (
            "broadcast_in_dim", [f[0]], {"shape": [1, 1, 32],
                                         "broadcast_dimensions": [2]},
            lambda: lax.broadcast_in_dim(f[0], (1, 1, 32), (2,))),
        "bcast_scalar_to_4x32": (
            "broadcast_in_dim", [f[2, 3]], {"shape": [4, 32],
                                            "broadcast_dimensions": []},
            lambda: lax.broadcast_in_dim(f[2, 3], (4, 32), ())),
        "bcast_512_to_1x512": (
            "broadcast_in_dim", [np.tile(f[1], 16)],
            {"shape": [1, 512], "broadcast_dimensions": [1]},
            lambda: lax.broadcast_in_dim(np.tile(f[1], 16), (1, 512), (1,))),
        "add_size1_dims": ("add", [f, f[:1]], {},
                           lambda: lax.add(f, f[:1])),
        "reduce_sum_01": ("reduce_sum", [np.abs(f) + 1.0], {"axes": [0, 1]},
                          lambda: jnp.sum(np.abs(f) + 1.0, axis=(0, 1))),
        "tanh_rsqrt": ("tanh", [f], {}, lambda: lax.tanh(f)),
        "rsqrt": ("rsqrt", [np.abs(f) + 0.5], {},
                  lambda: lax.rsqrt(np.abs(f) + 0.5)),
    }


@pytest.mark.parametrize("case", sorted(_lax_cases()))
def test_twin_prim_semantics_match_lax(case):
    prim, args, params, want = _lax_cases()[case]
    got = cg._prim_eval(prim, [torch.from_numpy(np.array(a))
                               for a in args], params)
    want = np.asarray(want())
    assert tuple(got.shape) == want.shape
    got = got.numpy()
    assert got.dtype == want.dtype
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# GEN001 / GEN002 / the cost registry
# ---------------------------------------------------------------------------
def _ir(ops, avals, ext_in, ext_out, literals=None):
    return {"name": "_probe", "kind": "elementwise", "ext_in": ext_in,
            "ext_out": ext_out, "avals": avals, "literals": literals or {},
            "ops": ops}


def test_gen001_prim_outside_the_provable_set():
    lk = cg.lower_chain(_ir(
        [{"prim": "mul", "in": [0, 1], "out": [2]},
         {"prim": "argmax", "in": [2], "out": [3],
          "params": {"axes": [0]}}],
        {"0": [[8], "float32"], "1": [[], "float32"], "2": [[8], "float32"],
         "3": [[], "int32"]}, [0], [3],
        {"1": {"dtype": "float32", "shape": [], "values": ["0x40000000"]}}))
    assert lk.src is None
    assert [f.rule_id for f in lk.findings] == ["GEN001"]
    assert "argmax" in lk.findings[0].message
    assert not cg.flat_tileable(lk)


def test_gen001_multi_output_eqn():
    lk = cg.lower_chain(_ir(
        [{"prim": "add", "in": [0, 0], "out": [1, 2]}],
        {"0": [[8], "float32"], "1": [[8], "float32"],
         "2": [[8], "float32"]}, [0], [1, 2]))
    assert lk.src is None
    assert [f.rule_id for f in lk.findings] == ["GEN001"]
    assert "2 outputs" in lk.findings[0].message


def test_gen001_dataflow_that_does_not_re_infer():
    # lax refuses (8,) + (4,); torch would also refuse, and a recorded
    # (8,) result of (8,)+(8,) typed int32 does not re-infer either
    for b_shape, out_dtype in (([4], "float32"), ([8], "int32")):
        lk = cg.lower_chain(_ir(
            [{"prim": "add", "in": [0, 1], "out": [2]}],
            {"0": [[8], "float32"], "1": [b_shape, "float32"],
             "2": [[8], out_dtype]}, [0, 1], [2]))
        assert lk.src is None
        assert [f.rule_id for f in lk.findings] == ["GEN001"]


def test_gen002_unproven_registration_flagged():
    gen.build_shipped_generated(device="cpu")
    # off the card the emitted CUDA never runs: every kernel is unproven
    findings = cg.lint_generated_kernels(device="cpu")
    assert [(f.rule_id, f.subject) for f in findings] == [
        ("GEN002", n) for n in sorted(SHIPPED_NAMES)]
    assert all("unproven: emitted CUDA runs only on the card" in f.message
               for f in findings)
    assert cg.lint_generated_kernels(disable=("GEN002",),
                                     device="cpu") == []
    # as a run on the card leaves them: proven, then one failing its check
    kernels = [gen.GENERATED_KERNELS[n] for n in SHIPPED_NAMES]
    try:
        for gk in kernels:
            gk.equivalence_ok, gk.equivalence_err = True, 0.0
        assert cg.lint_generated_kernels(device="cpu") == []
        gk = kernels[0]
        gk.equivalence_ok, gk.equivalence_err = False, 0.5
        findings = cg.lint_generated_kernels(device="cpu")
        assert [(f.rule_id, f.subject) for f in findings] == [
            ("GEN002", gk.name)]
        assert "check failed" in findings[0].message
    finally:
        for gk in kernels:
            gk.equivalence_ok, gk.equivalence_err = False, None


def test_kernel_costs_equal_the_ir_byte_split():
    gen.build_shipped_generated(device="cpu")
    with open(cg.SHIPPED_IR, encoding="utf-8") as f:
        chains = {c["name"]: c for c in json.load(f)["chains"]}
    for name in SHIPPED_NAMES:
        c, gk = chains[name], gen.GENERATED_KERNELS[name]
        cost = KERNEL_COSTS[name](None)
        assert cost == {k: c[k] for k in ("flops", "transcendentals",
                                          "bytes_read", "bytes_written")}
        assert cost["bytes_read"] + cost["bytes_written"] \
            == c["fused_bytes"] // max(c["scale"], 1)
        assert gk.bytes_saved == c["bytes_saved"] \
            == c["unfused_bytes"] - c["fused_bytes"] > 0
    assert cg.shipped_chain_rows() == {n: chains[n]["bytes_saved"]
                                       for n in SHIPPED_NAMES}


def test_plans_and_render():
    plans = cg.codegen_plans()
    assert [p["name"] for p in plans] == SHIPPED_NAMES
    for p in plans:
        assert p["lowerable"] and p["findings"] == [] and p["src"]
    text = cg.render_codegen(plans)
    assert text.startswith("mxgen: 6 shipped chain(s) lowered")
    assert all(n in text for n in SHIPPED_NAMES)


def test_generated_call_refuses_bad_operands():
    gks = {g.name: g for g in gen.build_shipped_generated(device="cpu")}
    gk = gks[TILEABLE]
    xs = [torch.zeros(9458) for _ in range(3)]
    with pytest.raises(MXNetError, match="takes 3 inputs"):
        gen.generated_call(gk, *xs[:2])
    with pytest.raises(MXNetError, match="input 1"):
        gen.generated_call(gk, xs[0], torch.zeros(9457), xs[2])
    with pytest.raises(MXNetError, match="input 2"):
        gen.generated_call(gk, xs[0], xs[1], torch.zeros(9458,
                                                         dtype=torch.int32))
    other = gks[SHIPPED_NAMES[1]]
    ins = [torch.from_numpy(x) for x in
           cg.seeded_inputs(other.in_avals, 0)]
    with pytest.raises(MXNetError, match="not flat-tileable"):
        gen.generated_call(other, *ins, block_rows=8)


# ---------------------------------------------------------------------------
# the autotune cache (CPU path: the host clock times the twin)
# ---------------------------------------------------------------------------
def test_autotune_cache_replay_corruption_and_mismatch(tmp_path):
    gk = {g.name: g for g in gen.build_shipped_generated(device="cpu")}[
        TILEABLE]
    cache = str(tmp_path / "mxgen_cache.json")
    first = cg.autotune_block_rows(gk, cache_path=cache, device="cpu")
    assert first in cg.AUTOTUNE_LADDER
    with open(cache, "rb") as f:
        blob = f.read()
    obj = json.loads(blob)
    assert (obj["schema"], obj["seed"], obj["ladder"]) == (
        cg.AUTOTUNE_CACHE_SCHEMA, cg.AUTOTUNE_SEED,
        list(cg.AUTOTUNE_LADDER))
    assert obj["kernels"][TILEABLE]["block_rows"] == first
    assert len(obj["kernels"][TILEABLE]["t_ns"]) == len(cg.AUTOTUNE_LADDER)
    # replayed: same answer, no rewrite
    assert cg.autotune_block_rows(gk, cache_path=cache, device="cpu") \
        == first
    with open(cache, "rb") as f:
        assert f.read() == blob
    # corrupt: rebuilt from fresh measurements
    with open(cache, "w") as f:
        f.write("{not json")
    assert cg.autotune_block_rows(gk, cache_path=cache, device="cpu") \
        in cg.AUTOTUNE_LADDER
    with open(cache) as f:
        assert json.load(f)["schema"] == cg.AUTOTUNE_CACHE_SCHEMA
    # another seed or ladder: not trusted, rebuilt under ours
    for stale in ({"seed": 1}, {"ladder": [2, 4]}, {"schema": 0}):
        obj = {"schema": cg.AUTOTUNE_CACHE_SCHEMA, "seed": cg.AUTOTUNE_SEED,
               "ladder": list(cg.AUTOTUNE_LADDER),
               "kernels": {TILEABLE: {"block_rows": 2, "t_ns": [1]}}}
        obj.update(stale)
        with open(cache, "w") as f:
            json.dump(obj, f)
        assert cg._load_cache(cache, cg.AUTOTUNE_SEED,
                              cg.AUTOTUNE_LADDER) is None
        assert cg.autotune_block_rows(gk, cache_path=cache, device="cpu") \
            in cg.AUTOTUNE_LADDER
        with open(cache) as f:
            rebuilt = json.load(f)
        assert (rebuilt["seed"], rebuilt["ladder"]) == (
            cg.AUTOTUNE_SEED, list(cg.AUTOTUNE_LADDER))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_generated_kernels_match_their_twin_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the emitted kernels have no CPU "
                    "mode")
    for gk in gen.build_shipped_generated(device="cuda"):
        assert gk.equivalence_ok, (gk.name, gk.equivalence_err)
        rungs = cg.AUTOTUNE_LADDER if cg.flat_tileable(gk.lowered) else ()
        for br in (None,) + tuple(rungs):
            ok, err = cg.equivalence_check(gk.lowered, "cuda",
                                           block_rows=br)
            assert ok, (gk.name, br, err)


if __name__ == "__main__":
    argv = sys.argv[1:]
    if not argv or argv[0] != "--export" or len(argv) not in (2, 4):
        sys.exit("usage: python tests/test_torch_codegen.py --export "
                 "<ir.json> [--npz <outputs.npz>]")
    export(argv[1], argv[3] if len(argv) == 4 else None)
    sys.exit(0)
