"""The bf16 ``wgmma`` design of B5 (the flash forward), B6 (dq) and B7
(dk/dv), ``csrc/flash_bf16_wgmma.cu``, and what routes a bfloat16 call to
it, held
on the CPU: a torch emulation of its arithmetic against the reference's
Pallas kernels in interpret mode, the choice of design
(``ops.pallas_kernels.flash_design``), the forced designs, the launch
counters, the shared headers and the ablation tool's edits.

The emulation repeats the kernels' numerics on bfloat16 q, k, v, dO: the
exact products (s = q·kᵀ, dp = dO·vᵀ) from the bf16 operands accumulated in
float32 (a bf16 × bf16 product is exact in float32); the forward's online
softmax over tiles of 64 keys in the kernel's order (s rounded times the
scale, masked to -1e30, the running max, p and ``corr`` as 2^x of one
fused multiply-add); the backward's recompute per tile of 32 queries
(dk/dv) or of 64 keys (dq) (``p = exp(s·scale - lse)`` where valid, ``ds
= p (dp - delta)``); every
product with the float32 p or ds as the sum, in float32, of the products
of its bf16 parts (``hi = bf16(x)``, each next part bf16 of what the
earlier ones leave) with the exact bf16 operand, part by part; the outputs
rounded to bf16 once.  The tensor cores' order inside a k-step, the
kernels' independent accumulators and the SFU's rounding of 2^x are not
modelled.  The limit is the bf16 routes' contract
(``tests/test_torch_flash_bf16.py``): one bf16 ulp, magnitudes counted no
finer than 1/64 of the outputs' RMS, lse within 1e-5.  Two parts meet it;
one part leaves the float32 sums far further off (``PYTHONPATH=. python
tests/test_torch_flash_bf16_wgmma.py`` prints the error with 1, 2 and 3
parts).  ``cuda``-marked tests hold each kernel to its plain version on a
card (skipped here; ``chip_smoke.py`` phase 17 runs the same at the
training path's shapes).
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_torch_flash_bf16 as tb
from mxnet_tpu.ops import pallas_kernels as jpk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import build
from mxnet_tpu_torch.ops import pallas_kernels as pk
from mxnet_tpu_torch.tools import flash_ablate

FWD, DQ, DKV = "flash_forward_with_lse", "flash_dq", "flash_dkv"
SOURCE = "flash_bf16_wgmma"
ENTRIES = {FWD: "mxtt_flash_fwd_wgmma_bf16", DQ: "mxtt_flash_dq_wgmma_bf16",
           DKV: "mxtt_flash_dkv_wgmma_bf16"}
PARTS = 2                         # the kernels' split of p and ds
FWD_BT, DKV_BT, DQ_BT = 64, 32, 64   # streamed tile rows
LOG2E = 1.4426950408889634
# (BH, Tq, Tk, D, causal): the ring path's D = 16 at a CPU size, T a
# multiple of the tiles and ragged, causal and full, Tq != Tk both ways;
# and D = 8 and 32, the design's other widths
EMULATED = [(2, 64, 64, 16, False), (2, 64, 64, 16, True),
            (2, 200, 200, 16, False), (2, 200, 200, 16, True),
            (2, 70, 130, 16, True), (2, 130, 70, 16, True),
            (2, 96, 96, 8, True), (2, 100, 100, 32, False)]


# -- the emulation --------------------------------------------------------------
def _parts(x, n):
    """x (float32) as n bf16 parts, each bf16 of what the earlier leave."""
    out = []
    for _ in range(n):
        h = x.bfloat16().float()
        out.append(h)
        x = x - h
    return out


def _mixed(x, b, n):
    """Σ over x's n bf16 parts of partᵀ·b, in float32, part by part."""
    acc = torch.zeros(x.shape[1], b.shape[1])
    for part in _parts(x, n):
        acc = acc + part.t() @ b
    return acc


def _exp2_fma(x, ml):
    """2^(x·log2 e - ml), the exponent one fused multiply-add."""
    return torch.exp2((x.double() * LOG2E - ml.double()).float())


def emulate_fwd(q, k, v, causal, scale, parts=PARTS):
    """(out f32 before rounding, out bf16, lse) as the forward computes
    them on bf16 q, k, v (BH, T, D)."""
    q, k, v = (t.float() for t in (q, k, v))
    bh, tq, _ = q.shape
    tk = k.shape[1]
    out = torch.zeros_like(q)
    lse = torch.zeros(bh, tq)
    qi = torch.arange(tq)[:, None]
    for b in range(bh):
        m = torch.full((tq, 1), -1e30)
        l = torch.zeros(tq, 1)
        acc = torch.zeros(tq, q.shape[2])
        for c0 in range(0, tk, FWD_BT):
            kt, vt = k[b, c0:c0 + FWD_BT], v[b, c0:c0 + FWD_BT]
            s = (q[b] @ kt.t()) * scale
            kj = c0 + torch.arange(kt.shape[0])[None, :]
            valid = (qi >= kj) if causal else torch.ones_like(s, dtype=bool)
            s = torch.where(valid, s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.max(dim=1, keepdim=True).values)
            ml = (torch.where(m_new <= -5e29, 0.0, m_new) * LOG2E).float()
            corr = torch.where(m <= -5e29, 0.0, _exp2_fma(m, ml))
            p = _exp2_fma(s, ml)
            l = l * corr + p.sum(dim=1, keepdim=True)
            acc = acc * corr + _mixed(p.t(), vt, parts)
            m = m_new
        denom = torch.clamp(l, min=1e-30)
        out[b] = acc / denom
        lse[b] = (m + torch.log(denom))[:, 0]
    return out, out.bfloat16(), lse


def emulate_dkv(q, k, v, do, lse, delta, causal, scale, parts=PARTS):
    """(dk, dv) f32 before rounding and (dk, dv) bf16 as dk/dv computes
    them on bf16 q, k, v, dO and f32 lse, delta."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    bh, tq, _ = q.shape
    tk = k.shape[1]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    kj = torch.arange(tk)[None, :]
    for b in range(bh):
        for c0 in range(0, tq, DKV_BT):
            qt, dot = q[b, c0:c0 + DKV_BT], do[b, c0:c0 + DKV_BT]
            qi = c0 + torch.arange(qt.shape[0])[:, None]
            valid = (qi >= kj) if causal else torch.ones(len(qi), tk,
                                                         dtype=bool)
            s = qt @ k[b].t()
            dp = dot @ v[b].t()
            p = torch.where(valid, torch.exp(
                s * scale - lse[b, c0:c0 + DKV_BT, None]), 0.0)
            ds = torch.where(valid, p * (dp - delta[b, c0:c0 + DKV_BT,
                                                    None]), 0.0)
            dv[b] += _mixed(p, dot, parts)
            dk[b] += _mixed(ds, qt, parts)
    dk = dk * scale
    return (dk, dv), (dk.bfloat16(), dv.bfloat16())


def emulate_dq(q, k, v, do, lse, delta, causal, scale, parts=PARTS):
    """dq f32 before rounding and dq bf16 as dq computes it on bf16 q, k, v,
    dO and f32 lse, delta: q-major over key tiles of DQ_BT, s and dp
    summed in f32, the ``expf`` recompute, dq the f32 sum over ds's bf16
    parts of part·k, times the scale, rounded once."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    bh, tq, _ = q.shape
    tk = k.shape[1]
    dq = torch.zeros_like(q)
    qi = torch.arange(tq)[:, None]
    for b in range(bh):
        for c0 in range(0, tk, DQ_BT):
            kt, vt = k[b, c0:c0 + DQ_BT], v[b, c0:c0 + DQ_BT]
            kj = c0 + torch.arange(kt.shape[0])[None, :]
            valid = (qi >= kj) if causal else torch.ones(tq, len(kt),
                                                         dtype=bool)
            s = q[b] @ kt.t()
            dp = do[b] @ vt.t()
            p = torch.where(valid, torch.exp(s * scale - lse[b, :, None]),
                            0.0)
            ds = torch.where(valid, p * (dp - delta[b, :, None]), 0.0)
            dq[b] += _mixed(ds.t(), kt, parts)
    dq = dq * scale
    return dq, dq.bfloat16()


def _case(bh, tq, tk, d, causal):
    """Seeded bf16 inputs (torch), the reference's bf16 forward, dq and
    dk/dv (interpret mode) and its lse, delta."""
    rng = np.random.RandomState(tq + tk + d + causal)
    q, tq_ = tb._bf16(rng, bh, tq, d)
    do, tdo = tb._bf16(rng, bh, tq, d)
    k, tk_ = tb._bf16(rng, bh, tk, d)
    v, tv = tb._bf16(rng, bh, tk, d)
    scale = d ** -0.5
    jq, jk, jv, jdo = (tb._jbf16(a) for a in (q, k, v, do))
    want_o, want_lse = jpk.flash_forward_with_lse(jq, jk, jv, causal, scale,
                                                  interpret=True)
    delta = jpk.flash_delta(want_o, jdo)
    want_dk, want_dv = jpk.flash_dkv(jq, jk, jv, jdo, want_lse, delta,
                                     causal, scale, interpret=True)
    want_dq = jpk.flash_dq(jq, jk, jv, jdo, want_lse, delta, causal, scale,
                           interpret=True)
    lse_t = torch.from_numpy(np.array(want_lse))
    delta_t = torch.from_numpy(np.array(delta))
    return dict(ins=(tq_, tk_, tv, tdo), lse=lse_t, delta=delta_t,
                scale=scale, want_o=want_o, want_lse=want_lse,
                want_dkv=(want_dk, want_dv), want_dq=want_dq)


def _exact(case):
    """The float64 forward, dq and dk/dv on the same inputs and lse,
    delta: what the float32 sums approximate."""
    bh, tq, tk, d, causal = case
    c = _case(*case)
    q, k, v, do = (t.double() for t in c["ins"])
    o, _ = pk.flash_forward_with_lse_reference(q, k, v, causal, c["scale"])
    args = (q, k, v, do, c["lse"].double(), c["delta"].double(), causal,
            c["scale"])
    dq = pk.flash_dq_reference(*args)
    dk, dv = pk.flash_dkv_reference(*args)
    return c, o, dq, (dk, dv)


def _sum_errors(case, parts):
    """The largest |f32 sum - f64| of out, dq, dk and dv with `parts`
    parts."""
    c, o, dq, dkv = _exact(case)
    bh, tq, tk, d, causal = case
    got_o = emulate_fwd(*c["ins"][:3], causal, c["scale"], parts)[0]
    bwd = (*c["ins"], c["lse"], c["delta"], causal, c["scale"], parts)
    got_dq = emulate_dq(*bwd)[0]
    got = emulate_dkv(*bwd)[0]
    return {"out": float((got_o.double() - o).abs().max()),
            "dq": float((got_dq.double() - dq).abs().max()),
            "dk": float((got[0].double() - dkv[0]).abs().max()),
            "dv": float((got[1].double() - dkv[1]).abs().max())}


@pytest.mark.parametrize("case", EMULATED, ids=str)
def test_bf16_wgmma_forward_emulation_matches_the_reference(case):
    """Two bf16 parts of p meet the contract against the reference's
    ``flash_forward_with_lse`` on bf16 inputs in interpret mode."""
    bh, tq, tk, d, causal = case
    c = _case(*case)
    _, got_o, got_lse = emulate_fwd(*c["ins"][:3], causal, c["scale"])
    tb._within_one_ulp(got_o, c["want_o"], "out")
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(c["want_lse"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", EMULATED, ids=str)
def test_bf16_wgmma_dkv_emulation_matches_the_reference(case):
    """Two bf16 parts of p and ds meet the contract against the
    reference's ``flash_dkv`` on bf16 inputs in interpret mode."""
    bh, tq, tk, d, causal = case
    c = _case(*case)
    _, got = emulate_dkv(*c["ins"], c["lse"], c["delta"], causal,
                         c["scale"])
    for g, w, what in zip(got, c["want_dkv"], ("dk", "dv")):
        tb._within_one_ulp(g, w, what)


@pytest.mark.parametrize("case", EMULATED, ids=str)
def test_bf16_wgmma_dq_emulation_matches_the_reference(case):
    """Two bf16 parts of ds meet the contract against the reference's
    ``flash_dq`` on bf16 inputs in interpret mode."""
    bh, tq, tk, d, causal = case
    c = _case(*case)
    _, got = emulate_dq(*c["ins"], c["lse"], c["delta"], causal,
                        c["scale"])
    tb._within_one_ulp(got, c["want_dq"], "dq")


@pytest.mark.parametrize("case", [EMULATED[3], EMULATED[4]], ids=str)
def test_one_bf16_part_is_far_further_off(case):
    """Why two parts: with one, the float32 sums of out, dq, dk and dv are
    many times further from the float64 values than with two, and the
    rounded outputs miss the contract (a control: the emulation can
    fail it)."""
    one, two = _sum_errors(case, 1), _sum_errors(case, 2)
    for what in one:
        assert one[what] > 16 * two[what], (what, one, two)
    bh, tq, tk, d, causal = case
    c = _case(*case)
    _, got_o, _ = emulate_fwd(*c["ins"][:3], causal, c["scale"], parts=1)
    bwd = (*c["ins"], c["lse"], c["delta"], causal, c["scale"])
    _, got_dq = emulate_dq(*bwd, parts=1)
    _, got = emulate_dkv(*bwd, parts=1)
    for g, w in zip((got_o, got_dq) + got,
                    (c["want_o"], c["want_dq"]) + c["want_dkv"]):
        assert tb._ulps(tb._f32(g), tb._f32(w)).max() > 1.0


# -- the choice of design ----------------------------------------------------------
def test_bf16_routes_by_wrapper_and_head_dim():
    bf = torch.bfloat16
    for w in (FWD, DQ, DKV):
        assert pk.flash_design(16, w, dtype=bf) == "wgmma_bf16"
        for d in (4, 12, 20, 40, 64, 128, 256):
            assert pk.flash_design(d, w, dtype=bf) == "bf16", (w, d)
        for d in (8, 16, 24, 32):
            assert pk.wgmma_bf16_takes(d)
            assert pk.flash_design(d, w, dtype=bf) == "wgmma_bf16"
            assert pk.flash_design(d, w, aligned=False, dtype=bf) == "bf16"
    for d in (0, 4, 12, 40, 64):
        assert not pk.wgmma_bf16_takes(d)
    assert not pk.wgmma_bf16_takes(16, aligned=False)
    # float32 keeps its designs
    assert pk.flash_design(16, FWD) == "wgmma"


@pytest.mark.parametrize("wrapper,shape", [
    (FWD, (1, 8, 12)), (DKV, (1, 8, 64)), (DQ, (1, 8, 12))])
def test_a_forced_bf16_wgmma_design_is_refused_before_any_launch(wrapper,
                                                                  shape):
    """A head dim the design does not take or float32 operands raise
    before anything is built or launched."""
    q = torch.zeros(shape, dtype=torch.bfloat16)
    before = pk.launch_counts()
    with pytest.raises(MXNetError, match="does not take"):
        pk._design_entry(wrapper, (q,), shape[2], "wgmma_bf16")
    with pytest.raises(MXNetError, match="does not take"):
        pk._design_entry(wrapper, (q.float()[..., :8],), 8, "wgmma_bf16")
    assert pk.launch_counts() == before
    entry = pk._design_entry(wrapper, (q[..., :8].contiguous(),), 8,
                             "wgmma_bf16")
    assert entry == (SOURCE, ENTRIES[wrapper], "wgmma_bf16")


def test_cpu_calls_take_the_plain_version_and_count_nothing():
    rng = np.random.RandomState(3)
    q, do = (torch.from_numpy(rng.randn(2, 40, 16).astype(np.float32))
             .bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(2, 50, 16).astype(np.float32))
            .bfloat16() for _ in range(2))
    before = pk.launch_counts()
    for design in (None, "wgmma_bf16", "bf16"):
        o, lse = pk._flash_forward_with_lse(q, k, v, True, 0.25,
                                            design=design)
        want = pk.flash_forward_with_lse_reference(q, k, v, True, 0.25)
        assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
        delta = pk.flash_delta(o, do)
        args = (q, k, v, do, lse, delta, True, 0.25)
        assert torch.equal(pk._flash_dq(*args, design=design),
                           pk.flash_dq_reference(*args))
        got = pk._flash_dkv(*args, design=design)
        want = pk.flash_dkv_reference(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert pk.launch_counts() == before


# -- counters, sources and headers ----------------------------------------------------
def _text(name):
    """``csrc/<name>.cu``, or ``csrc/<name>`` for a header."""
    path = build.source_path(name)
    if "." in name:
        path = os.path.join(os.path.dirname(path), name)
    with open(path, encoding="utf-8") as f:
        return f.read()


def test_bf16_wgmma_launch_counters_and_source():
    for w in (FWD, DQ, DKV):
        assert pk.LAUNCHES[w + "/wgmma_bf16"] >= 0
    assert pk._FLASH_DESIGNS["wgmma_bf16"] == {
        w: (SOURCE, entry) for w, entry in ENTRIES.items()}
    assert SOURCE in build.KERNEL_SOURCES
    src = _text(SOURCE)
    for text in ("_fa_kernel     (:62", "_fa_dq_kernel  (:171",
                 "_fa_dkv_kernel (:226",
                 "m64nNk16 .bf16", "tma_load_3d(",
                 "constexpr int PARTS = %d;" % PARTS,
                 "constexpr int DQ_BT = %d;" % DQ_BT,
                 '#include "sm90.cuh"', '#include "flash_wgmma.cuh"'):
        assert text in src, text
    for name in ENTRIES.values():
        assert 'extern "C" int %s(' % name in src, name
        assert pk._ARGTYPES[name] == pk._ARGTYPES[name.replace(
            "_wgmma_bf16", "")]


def test_the_bf16_wgmma_helpers_have_one_home():
    """The Hopper instructions the bf16 design adds (bf16 wgmma with A from
    registers, the 3-D TMA load, the unswizzled descriptor) live in
    ``csrc/sm90.cuh``, the forward's online softmax in
    ``csrc/flash_wgmma.cuh``; no kernel source defines them."""
    sm90 = _text("sm90.cuh")
    shared = _text("flash_wgmma.cuh")
    homes = {"void wgmma_bf16_rs_n16(": sm90, "void wgmma_bf16_rs_n32(": sm90,
             "void wgmma_bf16_rs_n64(": sm90, "void tma_load_3d(": sm90,
             "uint64_t il_desc(": sm90, "void softmax_tile(": shared,
             "float exp2_approx(": shared}
    for name in ("flash_fwd_wgmma", "flash_bwd_wgmma", SOURCE):
        src = _text(name)
        for helper, home in homes.items():
            assert helper in home, helper
            assert helper not in src, (name, helper)
    assert "softmax_tile<BT, true>(" in _text("flash_fwd_wgmma")
    assert "softmax_tile<BT, true>(" in _text(SOURCE)


_PTXAS_LOG = """\
ptxas info    : (C7519) warpgroup.arrive is injected in around line 3787 by \
compiler to allow use of registers in GMMA in function '_Z1bILi32EEvv'
ptxas info    : (C7511) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to insufficient register resources for the \
wgmma pipeline in the function '_Z1bILi32EEvv'
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1aILi16EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z1aILi16EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bILi32EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z1bILi32EEvv
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 384 bytes cmem[0]
"""


def test_the_ptxas_report_reads_each_instantiation():
    """``build._parse_ptxas`` (what ``chip_smoke.py``'s phase 1 prints for
    this source and ``csrc/flash_bwd_wgmma.cu``): registers and spills per
    compiled entry, in the order compiled, and each C75xx advisory, which
    ptxas prints before the entries, on the function it names."""
    rows = build._parse_ptxas(_PTXAS_LOG)
    assert [r["kernel"] for r in rows] == ["_Z1aILi16EEvv", "_Z1bILi32EEvv"]
    assert [(r["registers"], r["spill_stores"], r["spill_loads"])
            for r in rows] == [(168, 0, 0), (255, 12, 16)]
    assert rows[0]["advisories"] == []
    assert rows[1]["advisories"] == [
        "C7519 warpgroup.arrive is injected in around line 3787 by compiler "
        "to allow use of registers in GMMA",
        "C7511 Potential Performance Loss: wgmma.mma_async instructions are "
        "serialized due to insufficient register resources for the wgmma "
        "pipeline"]


# -- the ablation tool ------------------------------------------------------------
@pytest.mark.parametrize("variant", sorted(flash_ablate.BF16_CUTS))
def test_bf16_ablation_edits_apply_to_the_kernel_source(variant):
    """Each cut of ``tools/flash_ablate.py`` finds its texts in
    ``csrc/flash_bf16_wgmma.cu`` exactly once."""
    cut = flash_ablate.variant_source(variant, SOURCE)
    assert (cut == _text(SOURCE)) == (variant == "full")
    for entry in ENTRIES.values():
        assert entry in cut


@pytest.mark.parametrize("bt", flash_ablate.DQ_TILES)
def test_dq_key_tile_edit_applies_to_the_kernel_source(bt):
    """``flash_ablate.dq_tile_source`` sets dq's key tile, and only it; the
    shipped width is the emulation's."""
    text, shipped = flash_ablate.dq_tile_source(bt)
    assert shipped == DQ_BT
    assert text.count("constexpr int DQ_BT = %d;" % bt) == 1
    assert (text == _text(SOURCE)) == (bt == shipped)
    assert text.replace("DQ_BT = %d;" % bt, "DQ_BT = %d;" % shipped) \
        == _text(SOURCE)


# -- on the card ---------------------------------------------------------------
# (BH, Tq, Tk, D, causal): ragged tiles, Tq != Tk both ways, T = 1, every
# head dim the design takes
CUDA_CASES = [(4, 200, 200, 16, True), (3, 97, 130, 16, False),
              (2, 130, 97, 16, True), (2, 1, 1, 16, False),
              (2, 70, 70, 8, True), (3, 97, 33, 24, True),
              (2, 64, 64, 32, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=str)
def test_bf16_wgmma_kernels_match_plain_on_cuda(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bf16 wgmma kernels have no "
                    "CPU mode")
    bh, tq, tk, d, causal = case
    g = torch.Generator(device="cuda").manual_seed(tq + d)
    q, do = (torch.randn(bh, tq, d, device="cuda", generator=g).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(bh, tk, d, device="cuda", generator=g).bfloat16()
            for _ in range(2))
    scale = d ** -0.5
    before = pk.launch_counts()
    runs = [pk._flash_forward_with_lse(q, k, v, causal, scale,
                                       design="wgmma_bf16")
            for _ in range(2)]
    want_o, want_lse = pk.flash_forward_with_lse_reference(q, k, v, causal,
                                                           scale)
    assert torch.equal(runs[0][0], runs[1][0])
    tb._within_one_ulp(runs[0][0].cpu(), want_o.cpu(), "out")
    torch.testing.assert_close(runs[0][1], want_lse, rtol=1e-5, atol=1e-5)
    delta = pk.flash_delta(want_o, do)
    args = (q, k, v, do, want_lse, delta, causal, scale)
    got = pk._flash_dkv(*args, design="wgmma_bf16")
    for a, w, what in zip(got, pk.flash_dkv_reference(*args), ("dk", "dv")):
        tb._within_one_ulp(a.cpu(), w.cpu(), what)
    after = pk.launch_counts()
    assert after[FWD + "/wgmma_bf16"] == before[FWD + "/wgmma_bf16"] + 2
    assert after[DKV + "/wgmma_bf16"] == before[DKV + "/wgmma_bf16"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=str)
def test_bf16_wgmma_dq_matches_plain_on_cuda(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bf16 wgmma kernels have no "
                    "CPU mode")
    bh, tq, tk, d, causal = case
    g = torch.Generator(device="cuda").manual_seed(tq + d)
    q, do = (torch.randn(bh, tq, d, device="cuda", generator=g).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(bh, tk, d, device="cuda", generator=g).bfloat16()
            for _ in range(2))
    scale = d ** -0.5
    want_o, lse = pk.flash_forward_with_lse_reference(q, k, v, causal, scale)
    args = (q, k, v, do, lse, pk.flash_delta(want_o, do), causal, scale)
    before = pk.launch_counts()[DQ + "/wgmma_bf16"]
    runs = [pk._flash_dq(*args, design="wgmma_bf16") for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    tb._within_one_ulp(runs[0].cpu(), pk.flash_dq_reference(*args).cpu(),
                       "dq")
    assert pk.launch_counts()[DQ + "/wgmma_bf16"] == before + 2


if __name__ == "__main__":
    for case in EMULATED[3:5]:
        for parts in (1, 2, 3):
            print(case, "parts", parts, _sum_errors(case, parts))
