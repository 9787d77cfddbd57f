"""B5, the flash forward ``flash_forward_with_lse``: its two designs on the
card and what routes a call between them, held on the CPU — the choice of
design (``ops.pallas_kernels.flash_design``), the forced design of
``_flash_forward_with_lse``, the per-design launch counters, the shared
header of the split-TF32 kernels, the ablation tool's edits, and a numpy
emulation of the wgmma design's arithmetic against the reference's Pallas
kernel in interpret mode.

The emulation repeats ``csrc/flash_fwd_wgmma.cu``'s numerics: tiles of 64
keys (zeros past Tk) over a head dim padded to 16 or 32; every operand of
both products split into ``hi`` (its low 13 bits cleared) and ``lo`` (the
rest, its low 13 bits cleared); s = q·kᵀ as hi·hi + hi·lo + lo·hi in
float32, pass by pass over k-steps of 8 into one accumulator; the online
softmax in the kernel's order (s rounded times the scale, masked to -1e30,
the running max, p = 2^(s·log2 e - m_safe·log2 e) from one fused
multiply-add, ``corr`` likewise, each lane of a row's quad keeping its own
partial sum of its keys in trees of four, summed over the quad at the end);
p.v into the design's independent accumulators (4 at D <= 16, 2 above),
the contraction order of p permuted within each group of 8 as [0, 2, 4, 6,
1, 3, 5, 7], summed in the kernel's order before the division.  The tensor
cores' own order inside a k-step and the SFU's rounding of 2^x are not
modelled.  Tolerance 1e-5 (rtol = atol), the kernel's f32 contract; the
one-pass TF32 error at the same inputs is the reason for three passes
(``PYTHONPATH=. python tests/test_torch_flash_fwd.py`` prints both).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as jpk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import build
from mxnet_tpu_torch.ops import pallas_kernels as pk
from mxnet_tpu_torch.tools import flash_ablate

TOL = 1e-5
FWD = "flash_forward_with_lse"
COUNTERS = (FWD, FWD + "/wgmma", FWD + "/simt")
# (BH, Tq, Tk, D, causal): the ring path's D = 16 at a CPU size, T a
# multiple of the key tile and ragged, causal and full, and Tq != Tk both
# ways (causal)
EMULATED = [(4, 64, 64, 16, False), (4, 64, 64, 16, True),
            (4, 200, 200, 16, False), (4, 200, 200, 16, True),
            (4, 70, 130, 16, True), (4, 130, 70, 16, True)]
PERM = np.array([0, 2, 4, 6, 1, 3, 5, 7])
BT = 64                                   # keys per streamed tile
LOG2E = np.float32(1.4426950408889634)


def _tf32(x):
    """x with its low 13 mantissa bits cleared (truncation to TF32)."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(np.float32(x) - hi)


def _products(acc, a, b, passes, permuted=False):
    """``acc[kk % len(acc)] += a[:, step kk] · b[:, step kk]ᵀ`` over k-steps
    of 8, pass by pass (hi·hi, hi·lo, lo·hi; the first ``passes``), all in
    float32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    cols = np.arange(a.shape[1])
    if permuted:
        cols = cols // 8 * 8 + PERM[cols % 8]
    for x, y in [(ah, bh), (ah, bl), (al, bh)][:passes]:
        for kk in range(a.shape[1] // 8):
            c = cols[8 * kk:8 * kk + 8]
            i = kk % len(acc)
            acc[i] = (acc[i] + x[:, c] @ y[:, c].T).astype(np.float32)
    return acc


def _padded(x, rows, cols):
    """x zero-padded to (rows, cols)."""
    out = np.zeros((rows, cols), np.float32)
    part = x[:rows]
    out[:len(part), :x.shape[1]] = part
    return out


def _exp2_fma(x, ml):
    """2^(x·log2 e - ml), the exponent one fused multiply-add (the float32
    product is exact in float64)."""
    arg = (x.astype(np.float64) * np.float64(LOG2E) - ml).astype(np.float32)
    with np.errstate(over="ignore"):
        return np.exp2(arg).astype(np.float32)


def _quad_sum(p):
    """Each quad lane's sum of its 16 keys of a tile: lane t holds keys 8 nb
    + 2 t + c, partial j takes nb = j, j + 4 (c = 0, 1 in turn), and the
    partials add as (0 + 1) + (2 + 3).  (rows, 64) -> (rows, 4)."""
    pp = p.reshape(p.shape[0], 8, 4, 2)
    part = []
    for j in range(4):
        a = pp[:, j, :, 0]
        for x in (pp[:, j, :, 1], pp[:, j + 4, :, 0], pp[:, j + 4, :, 1]):
            a = (a + x).astype(np.float32)
        part.append(a)
    return ((part[0] + part[1]).astype(np.float32)
            + (part[2] + part[3]).astype(np.float32)).astype(np.float32)


def emulate_fwd(q, k, v, causal, scale, passes=3):
    """(out, lse) as the wgmma design computes them (q-major, key tiles of
    64)."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    dp, na = (16, 4) if d <= 16 else (32, 2)
    out = np.zeros_like(q)
    lse = np.zeros((bh, tq), np.float32)
    qi = np.arange(tq)[:, None]
    for b in range(bh):
        qb = _padded(q[b], tq, dp)
        m = np.full((tq, 1), -1e30, np.float32)
        l = np.zeros((tq, 4), np.float32)
        acc = [np.zeros((tq, dp), np.float32) for _ in range(na)]
        for c0 in range(0, tk, BT):
            kt = _padded(k[b][c0:], BT, dp)
            vt = _padded(v[b][c0:], BT, dp)
            x = _products([np.zeros((tq, BT), np.float32)], qb, kt,
                          passes)[0]
            s = (x * np.float32(scale)).astype(np.float32)
            kj = c0 + np.arange(BT)[None, :]
            valid = (kj < tk) & ((qi >= kj) if causal else True)
            s = np.where(valid, s, np.float32(-1e30))
            m_new = np.maximum(m, s.max(axis=1, keepdims=True))
            ml = (np.where(m_new <= -5e29, np.float32(0), m_new)
                  * LOG2E).astype(np.float32)
            corr = np.where(m <= -5e29, np.float32(0), _exp2_fma(m, ml))
            p = _exp2_fma(s, ml)
            l = (l * corr + _quad_sum(p)).astype(np.float32)
            acc = [(a * corr).astype(np.float32) for a in acc]
            acc = _products(acc, p, vt.T, passes, permuted=True)
            m = m_new
        total = np.zeros((tq, dp), np.float32)
        for a in acc:
            total += a
        lq = ((l[:, :1] + l[:, 1:2]).astype(np.float32)
              + (l[:, 2:3] + l[:, 3:]).astype(np.float32)).astype(np.float32)
        denom = np.maximum(lq, np.float32(1e-30))
        out[b] = (total / denom)[:, :d]
        lse[b] = (m + np.log(denom))[:, 0]
    return out, lse


def _case(bh, tq, tk, d, causal, seed):
    """Seeded inputs and the reference's (out, lse) (interpret mode)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(bh, tq, d).astype(np.float32)
    k, v = (rng.randn(bh, tk, d).astype(np.float32) for _ in range(2))
    scale = d ** -0.5
    want = jpk.flash_forward_with_lse(*map(jnp.asarray, (q, k, v)), causal,
                                      scale, interpret=True)
    return (q, k, v), scale, tuple(map(np.asarray, want))


def _errors(case, passes):
    bh, tq, tk, d, causal = case
    ins, scale, want = _case(bh, tq, tk, d, causal, seed=sum(case[:4]))
    return emulate_fwd(*ins, causal, scale, passes), want


def _counts():
    return {k: pk.launch_counts()[k] for k in COUNTERS}


def _source(name):
    with open(build.source_path(name), encoding="utf-8") as f:
        return f.read()


# -- the choice of design -------------------------------------------------------
def test_flash_design_for_the_forward_by_head_dim():
    """The forward's wgmma design takes ``D % 4 == 0`` up to 32 and is
    chosen at every such D (phase 7's sweep timed it faster there); the
    rest — D = 64 and 128 among them — and unaligned operands on the
    CUDA-core design."""
    for d in range(1, 129):
        want = "wgmma" if d % 4 == 0 and d <= 32 else "simt"
        assert pk.flash_design(d, FWD) == want, d
        assert pk.flash_design(d, FWD, aligned=False) == "simt", d
    assert pk.FLASH_WGMMA_DIMS[FWD] == frozenset(range(4, 33, 4))


# (BH, Tq, Tk, D, causal) above D = 128: the CUDA-core design's 192- and
# 256-wide builds and its wide kernels (D in chunks of 256); ragged
WIDE = [(2, 37, 45, 160, True), (2, 45, 37, 160, False),
        (2, 40, 40, 256, True), (2, 29, 51, 256, False)]


def test_wide_head_dims_go_to_the_cuda_core_design():
    """Every D above 32 runs the CUDA-core design; its launch shape
    (``simt_launch_shape``, the table ``csrc/flash_attention.cu``'s
    ``shape_of`` holds) pads D to 8, 16, 32, 64, 128, 192 or 256 with 1,
    2, 4 or 8 lanes a row (each lane a multiple of 4 floats: the float4
    reads), and above 256 takes chunks of 256 on 8 lanes; two tiles of
    a block fit the 48 KB of static shared memory."""
    widths = (8, 16, 32, 64, 128, 192, 256)
    for d in range(1, 700):
        for wrapper in (FWD, "flash_dq", "flash_dkv"):
            if d > 32:
                assert pk.flash_design(d, wrapper) == "simt", (wrapper, d)
        width, lanes, tile, chunks, rows = pk.simt_launch_shape(d)
        assert rows * lanes == 128 and width % (4 * lanes) == 0
        assert 2 * tile * width * 4 <= 48 * 1024
        if d <= 256:
            assert chunks == 1 and width == min(w for w in widths if w >= d)
        else:
            assert (width, lanes, chunks) == (256, 8, -(-d // 256))
    assert pk.simt_launch_shape(160) == (192, 8, 16, 1, 16)
    assert pk.simt_launch_shape(320) == (256, 8, 16, 2, 16)
    assert pk.simt_launch_shape(128)[:3] == (128, 4, 32)
    with pytest.raises(ValueError):
        pk.simt_launch_shape(0)
    assert "MAX_HEAD_DIM" not in pk.__all__
    assert not hasattr(pk, "MAX_HEAD_DIM")


def test_the_cuda_core_source_has_the_wide_design():
    src = _source("flash_attention")
    for text in ("Launch<192, 8, 16, false>", "Launch<256, 8, 16, false>",
                 "Launch<kWide, 8, 16, true>", "flash_fwd_wide_kernel",
                 "flash_dq_wide_kernel", "flash_dkv_wide_kernel",
                 "mxtt_flash_simt_shape", "long long bh", "b % n_bh"):
        assert text in src, text
    assert "kMaxD" not in src and "d > kMaxD" not in src


@pytest.mark.parametrize("case", WIDE, ids=str)
def test_plain_forward_at_wide_head_dims_matches_the_reference(case):
    """The port's CPU forward (the plain version the card's kernels are
    held to) against the reference's Pallas kernel in interpret mode."""
    bh, tq, tk, d, causal = case
    ins, scale, want = _case(bh, tq, tk, d, causal, seed=d + tq)
    got = pk.flash_forward_with_lse(*map(torch.from_numpy, ins), causal,
                                    scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


def test_the_ring_path_routes_the_forward_to_wgmma():
    pairings = flash_ablate.path_pairings()
    assert [(c[0], c[3]) for c in pairings] == [(512, 16), (256, 16)]
    for bh, tq, tk, d, causal in pairings:
        assert pk.flash_design(d, FWD) == "wgmma"


def test_forced_forward_design_is_checked_before_any_launch():
    """Forcing the wgmma design where the head dim is not its own raises
    (no fallback), a design name that does not exist too; the forward's
    wgmma design lives in its own source."""
    t64, t16 = torch.zeros(2, 8, 64), torch.zeros(2, 8, 16)
    with pytest.raises(MXNetError, match="wgmma"):
        pk._design_entry(FWD, (t64,), 64, "wgmma")
    with pytest.raises(MXNetError, match="tensor"):
        pk._design_entry(FWD, (t16,), 16, "tensor")
    assert pk._design_entry(FWD, (t16,), 16, None) == (
        "flash_fwd_wgmma", "mxtt_flash_fwd_wgmma", "wgmma")
    assert pk._design_entry(FWD, (t64,), 64, None) == (
        "flash_attention", "mxtt_flash_fwd", "simt")
    assert pk._design_entry(FWD, (t16,), 16, "simt") == (
        "flash_attention", "mxtt_flash_fwd", "simt")
    t12 = torch.zeros(2, 8, 12)
    assert pk._design_entry(FWD, (t12,), 12, "wgmma")[2] == "wgmma"


@pytest.mark.parametrize("design", [None, "wgmma", "simt"])
def test_cpu_forward_takes_the_plain_version_and_counts_nothing(design):
    rng = np.random.RandomState(5)
    q = torch.from_numpy(rng.randn(2, 9, 16).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(2, 11, 16).astype(np.float32))
            for _ in range(2))
    before = _counts()
    got = pk._flash_forward_with_lse(q, k, v, True, 0.25, design=design)
    assert _counts() == before
    want = pk.flash_forward_with_lse_reference(q, k, v, True, 0.25)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)


def test_forward_launch_counters_and_source():
    for name in COUNTERS:
        assert name in pk.LAUNCHES
    assert "flash_fwd_wgmma" in build.KERNEL_SOURCES
    src = _source("flash_fwd_wgmma")
    assert '#include "flash_wgmma.cuh"' in src
    for text in ("mxnet_tpu/ops/pallas_kernels.py", "_fa_kernel (:62",
                 "mxtt_flash_fwd_wgmma", "m64n64k8 .tf32", "cp.async.bulk"):
        assert text in src


def test_the_split_tf32_helpers_have_one_home():
    """The pieces both split-TF32 kernels use live in ``csrc/
    flash_wgmma.cuh``, which both include; neither source defines them."""
    with open(build.source_path("flash_wgmma")[:-len(".cu")] + ".cuh",
              encoding="utf-8") as f:
        header = f.read()
    helpers = ("uint32_t sw_off(", "uint64_t tile_desc(", "void warp_arrive(",
               "void wait_phase(", "void split_rows(", "void split_cols(",
               "struct Rs;", "void mma_rs(")
    for name in ("flash_fwd_wgmma", "flash_bwd_wgmma"):
        src = _source(name)
        assert '#include "flash_wgmma.cuh"' in src, name
        for helper in helpers:
            assert helper in header, helper
            assert helper not in src, (name, helper)


# -- the split arithmetic, emulated -------------------------------------------
@pytest.mark.parametrize("case", EMULATED, ids=str)
def test_split_tf32_forward_emulation_matches_the_reference(case):
    """Three TF32 passes meet the f32 contract against the reference's
    ``flash_forward_with_lse`` in interpret mode; one pass, at the same
    inputs, is further off."""
    got, want = _errors(case, passes=3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    one, _ = _errors(case, passes=1)
    three_err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    one_err = max(float(np.abs(g - w).max()) for g, w in zip(one, want))
    assert one_err > 4 * three_err


# -- the ablation tool ------------------------------------------------------------
@pytest.mark.parametrize("variant", sorted(flash_ablate.FWD_CUTS))
def test_forward_ablation_edits_apply_to_the_kernel_source(variant):
    """Each cut of ``tools/flash_ablate.py`` finds its text in
    ``csrc/flash_fwd_wgmma.cu`` exactly once."""
    cut = flash_ablate.variant_source(variant, "flash_fwd_wgmma")
    assert (cut == _source("flash_fwd_wgmma")) == (variant == "full")
    assert "mxtt_flash_fwd_wgmma" in cut


# -- on the card ---------------------------------------------------------------
# (BH, Tq, Tk, D, causal): ragged key and query tiles, Tq != Tk both ways,
# T = 1, every D % 4 == 0 up to 32 besides 16, and D = 64 and 128 (the
# CUDA-core design only)
CUDA_CASES = [(4, 200, 200, 16, True), (3, 97, 130, 64, False),
              (2, 1, 1, 16, True), (2, 70, 70, 128, True),
              (2, 70, 130, 32, True), (2, 130, 70, 16, True),
              (3, 33, 97, 12, False), (2, 130, 70, 4, True),
              (2, 97, 33, 20, True), (2, 64, 64, 24, False),
              (2, 200, 130, 28, True), (2, 5, 300, 8, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["wgmma", "simt"])
def test_each_forward_design_matches_plain_on_cuda(design):
    """Each design, forced, against the plain version on the card at 1e-5,
    every case it takes; reruns bitwise; each launch counted on its
    design."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for i, (bh, tq, tk, d, causal) in enumerate(CUDA_CASES):
        if design == "wgmma" and not pk.wgmma_takes(d):
            continue
        gen = torch.Generator(device="cuda").manual_seed(i)
        q = torch.randn(bh, tq, d, device="cuda", generator=gen)
        k, v = (torch.randn(bh, tk, d, device="cuda", generator=gen)
                for _ in range(2))
        scale = d ** -0.5
        before = _counts()
        runs = [pk._flash_forward_with_lse(q, k, v, causal, scale,
                                           design=design) for _ in range(2)]
        torch.cuda.synchronize()
        assert _counts()[FWD + "/" + design] \
            == before[FWD + "/" + design] + 2
        want = pk.flash_forward_with_lse_reference(q, k, v, causal, scale)
        for got, again, w in zip(runs[0], runs[1], want):
            assert torch.equal(got, again)
            torch.testing.assert_close(got, w, rtol=TOL, atol=TOL)


if __name__ == "__main__":
    for case in EMULATED:
        errs = []
        for passes in (3, 1):
            got, want = _errors(case, passes)
            errs.append(max(float(np.abs(g - w).max())
                            for g, w in zip(got, want)))
        print("(BH, Tq, Tk, D, causal) %s: max |emulation - reference| "
              "over out, lse: three TF32 passes %.3g, one pass %.3g"
              % (case, errs[0], errs[1]))
