"""B6 ``flash_dq`` and B7 ``flash_dkv``'s two designs on the card and what
routes a call between them, held on the CPU: the choice of design
(``ops.pallas_kernels.flash_design``), the forced design of
``_flash_dq`` / ``_flash_dkv``, the per-design launch counters, the
ablation tool's edits, and a numpy emulation of the wgmma design's split
TF32 arithmetic against the reference's Pallas kernels in interpret mode.

The emulation repeats ``csrc/flash_bwd_wgmma.cu``'s numerics: every
operand split into ``hi`` (its low 13 bits cleared) and ``lo`` (the rest,
its low 13 bits cleared), each product summed as hi·hi + hi·lo + lo·hi in
float32, pass by pass over k-steps of 8, the register operands' (p, ds)
contraction order permuted within each group of 8 as [0, 2, 4, 6, 1, 3, 5,
7], the streamed tiles (64 keys for dq, 32 queries for dk/dv) and the
independent accumulators (4 for dq, 2 each for dk and dv at D = 16)
summed in the kernel's order.  The tensor cores' own summation order
inside a k-step is not modelled.  Tolerance 1e-4 (rtol = atol), the
kernels' f32 contract; the one-pass TF32 error at the same inputs is the
reason for three passes (``PYTHONPATH=. python tests/test_torch_flash_bwd.py``
prints both).
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

TOL = 1e-4
COUNTERS = ("flash_dq", "flash_dq/wgmma", "flash_dq/simt", "flash_dkv",
            "flash_dkv/wgmma", "flash_dkv/simt")
# (BH, T, D, causal): the ring path's D = 16 at a CPU size, T a multiple
# of the tiles and ragged
EMULATED = [(4, 64, 16, False), (4, 64, 16, True), (4, 200, 16, False),
            (4, 200, 16, True)]
# the kernel's contraction order within a group of 8 register-operand
# columns: position l holds column PERM[l]
PERM = np.array([0, 2, 4, 6, 1, 3, 5, 7])
# the wgmma design's streamed tile and accumulators at D = 16:
# (rows per tile, independent accumulators)
DQ_TILE, DKV_TILE = (64, 4), (32, 2)


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


def _rows(x, r0, n):
    """Rows r0 .. r0 + n - 1 of x, zeros past its end."""
    out = np.zeros((n,) + x.shape[1:], np.float32)
    part = x[r0:r0 + n]
    out[:len(part)] = part
    return out


def _recompute(x, y, lse, delta, valid, scale):
    with np.errstate(over="ignore", invalid="ignore"):
        p = np.where(valid, np.exp(x * np.float32(scale) - lse), 0)
        ds = np.where(valid, p * (y - delta), 0)
    return p.astype(np.float32), ds.astype(np.float32)


def emulate_dq(q, k, v, do, lse, delta, causal, scale, passes=3):
    """dq as the wgmma design computes it (q-major, key tiles of 64)."""
    bt, na = DQ_TILE
    bh, tq, d = q.shape
    tk = k.shape[1]
    out = np.zeros_like(q)
    for b in range(bh):
        acc = [np.zeros((tq, d), np.float32) for _ in range(na)]
        for c0 in range(0, tk, bt):
            kt, vt = _rows(k[b], c0, bt), _rows(v[b], c0, bt)
            x = _products([np.zeros((tq, bt), np.float32)], q[b], kt, passes)
            y = _products([np.zeros((tq, bt), np.float32)], do[b], vt,
                          passes)
            qi, kj = np.arange(tq)[:, None], c0 + np.arange(bt)[None, :]
            valid = (kj < tk) & ((qi >= kj) if causal else True)
            _, ds = _recompute(x[0], y[0], lse[b][:, None],
                               delta[b][:, None], valid, scale)
            acc = _products(acc, ds, kt.T, passes, permuted=True)
        total = np.zeros((tq, d), np.float32)
        for a in acc:
            total += a
        out[b] = total * np.float32(scale)
    return out


def emulate_dkv(q, k, v, do, lse, delta, causal, scale, passes=3):
    """(dk, dv) as the wgmma design computes them (k-major, query tiles of
    32)."""
    bt, na = DKV_TILE
    bh, tq, d = q.shape
    tk = k.shape[1]
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for b in range(bh):
        acc_k = [np.zeros((tk, d), np.float32) for _ in range(na)]
        acc_v = [np.zeros((tk, d), np.float32) for _ in range(na)]
        for c0 in range(0, tq, bt):
            qt, dot = _rows(q[b], c0, bt), _rows(do[b], c0, bt)
            lt, dt = _rows(lse[b], c0, bt), _rows(delta[b], c0, bt)
            x = _products([np.zeros((tk, bt), np.float32)], k[b], qt, passes)
            y = _products([np.zeros((tk, bt), np.float32)], v[b], dot,
                          passes)
            kj, qi = np.arange(tk)[:, None], c0 + np.arange(bt)[None, :]
            valid = (qi < tq) & ((qi >= kj) if causal else True)
            p, ds = _recompute(x[0], y[0], lt[None, :], dt[None, :], valid,
                               scale)
            acc_k = _products(acc_k, ds, qt.T, passes, permuted=True)
            acc_v = _products(acc_v, p, dot.T, passes, permuted=True)
        for out, acc, mul in ((dk, acc_k, scale), (dv, acc_v, 1.0)):
            total = np.zeros((tk, d), np.float32)
            for a in acc:
                total += a
            out[b] = total * np.float32(mul)
    return dk, dv


def _case(bh, t, d, causal, seed):
    """Seeded inputs and the reference's dq, dk, dv (interpret mode)."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(bh, t, d).astype(np.float32)
                   for _ in range(4))
    scale = d ** -0.5
    o, lse = jpk.flash_forward_with_lse(*map(jnp.asarray, (q, k, v)),
                                        causal, scale, interpret=True)
    delta = jpk.flash_delta(o, jnp.asarray(do))
    args = tuple(map(jnp.asarray, (q, k, v, do, lse, delta)))
    want_dq = jpk.flash_dq(*args, causal, scale, interpret=True)
    want_dk, want_dv = jpk.flash_dkv(*args, causal, scale, interpret=True)
    ins = (q, k, v, do, np.asarray(lse), np.asarray(delta))
    return ins, scale, tuple(map(np.asarray, (want_dq, want_dk, want_dv)))


def _errors(case, passes):
    bh, t, d, causal = case
    ins, scale, want = _case(bh, t, d, causal, seed=sum(case[:3]))
    got = (emulate_dq(*ins, causal, scale, passes),) + emulate_dkv(
        *ins, causal, scale, passes)
    return got, want


def _counts():
    return {k: pk.launch_counts()[k] for k in COUNTERS}


# -- the choice of design -------------------------------------------------------
def test_flash_design_by_head_dim():
    """The wgmma design takes ``D % 4 == 0`` up to 32 (whole 16-byte rows
    for the bulk copies, accumulators that fit the registers); it is
    chosen there for dq, and for dk/dv from D = 12 (at D = 4 and 8 the
    CUDA-core design was timed faster); the rest — D = 64 and 128 among
    them — on the CUDA-core design; unaligned operands always on the
    CUDA-core design."""
    for d in range(1, 129):
        takes = d % 4 == 0 and d <= 32
        assert pk.wgmma_takes(d) == takes, d
        assert not pk.wgmma_takes(d, aligned=False), d
        for wrapper, lo in (("flash_dq", 4), ("flash_dkv", 12)):
            want = "wgmma" if takes and d >= lo else "simt"
            assert pk.flash_design(d, wrapper) == want, (wrapper, d)
            assert pk.flash_design(d, wrapper, aligned=False) == "simt"
    with pytest.raises(KeyError):
        pk.flash_design(16, "flash_delta")


# (BH, T, D, causal) above D = 128 on the CUDA-core design; ragged
WIDE = [(2, 37, 160, True), (2, 45, 160, False), (2, 40, 256, True),
        (2, 29, 256, False)]


@pytest.mark.parametrize("case", WIDE, ids=str)
def test_plain_backward_at_wide_head_dims_matches_the_reference(case):
    """The port's CPU dq, dk and dv (the plain versions the card's
    kernels are held to) against the reference's Pallas kernels in
    interpret mode at head dims above 128."""
    bh, t, d, causal = case
    ins, scale, want = _case(bh, t, d, causal, seed=d + t)
    args = tuple(torch.tensor(np.asarray(x)) for x in ins)
    got = (pk.flash_dq(*args, causal, scale),) + pk.flash_dkv(
        *args, causal, scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)


def test_the_ring_path_routes_to_wgmma():
    for bh, tq, tk, d, causal in flash_ablate.path_pairings():
        assert pk.flash_design(d, "flash_dq") == "wgmma"
        assert pk.flash_design(d, "flash_dkv") == "wgmma"
    assert [c[0] for c in flash_ablate.path_pairings()] == [512, 256]


def test_forced_design_is_checked_before_any_launch():
    """Forcing the wgmma design where the head dim is not its own raises
    (no fallback); a design name that does not exist too."""
    t64 = torch.zeros(2, 8, 64)
    t16 = torch.zeros(2, 8, 16)
    with pytest.raises(MXNetError, match="wgmma"):
        pk._design_entry("flash_dq", (t64,), 64, "wgmma")
    with pytest.raises(MXNetError, match="tensor"):
        pk._design_entry("flash_dkv", (t16,), 16, "tensor")
    assert pk._design_entry("flash_dq", (t16,), 16, None) == (
        "flash_bwd_wgmma", "mxtt_flash_dq_wgmma", "wgmma")
    assert pk._design_entry("flash_dkv", (t64,), 64, None) == (
        "flash_attention", "mxtt_flash_dkv", "simt")
    assert pk._design_entry("flash_dkv", (t16,), 16, "simt")[2] == "simt"
    # dk/dv at D = 8 is routed to the CUDA-core design, yet the wgmma one
    # takes it when forced (phase 7 times both there)
    t8 = torch.zeros(2, 8, 8)
    assert pk._design_entry("flash_dkv", (t8,), 8, None)[2] == "simt"
    assert pk._design_entry("flash_dkv", (t8,), 8, "wgmma")[2] == "wgmma"
    assert pk._design_entry("flash_dq", (t8,), 8, None)[2] == "wgmma"


@pytest.mark.parametrize("design", [None, "wgmma", "simt"])
def test_cpu_calls_take_the_plain_version_and_count_nothing(design):
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 9, 16).astype(np.float32))
                   for _ in range(4))
    o, lse = pk.flash_forward_with_lse_reference(q, k, v, True, 0.25)
    delta = pk.flash_delta(o, do)
    before = _counts()
    dq = pk._flash_dq(q, k, v, do, lse, delta, True, 0.25, design=design)
    dk, dv = pk._flash_dkv(q, k, v, do, lse, delta, True, 0.25,
                           design=design)
    assert _counts() == before
    torch.testing.assert_close(
        dq, pk.flash_dq_reference(q, k, v, do, lse, delta, True, 0.25))
    want_dk, want_dv = pk.flash_dkv_reference(q, k, v, do, lse, delta,
                                              True, 0.25)
    torch.testing.assert_close(dk, want_dk)
    torch.testing.assert_close(dv, want_dv)


def test_launch_counters_include_each_design():
    for name in COUNTERS:
        assert name in pk.LAUNCHES
    assert "flash_bwd_wgmma" in build.KERNEL_SOURCES
    with open(build.source_path("flash_bwd_wgmma"), encoding="utf-8") as f:
        src = f.read()
    assert '#include "sm90.cuh"' in src
    for text in ("mxnet_tpu/ops/pallas_kernels.py", "_fa_dq_kernel  (:171",
                 "_fa_dkv_kernel (:226", "tf32"):
        assert text in src


# -- the split arithmetic, emulated -------------------------------------------
@pytest.mark.parametrize("case", EMULATED, ids=str)
def test_split_tf32_emulation_matches_the_reference(case):
    """Three TF32 passes meet the f32 contract against the reference's
    ``flash_dq`` / ``flash_dkv`` in interpret mode; one pass, at the same
    inputs, is further off."""
    got, want = _errors(case, passes=3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    one, _ = _errors(case, passes=1)
    three_err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    one_err = max(float(np.abs(g - w).max()) for g, w in zip(one, want))
    assert one_err > 4 * three_err


def test_permutation_matches_the_accumulator_fragment():
    """The accumulator holds columns (2t, 2t + 1) of each 8-column block for
    lane t (mod 4); the tf32 A fragment wants columns (t, t + 4): position
    t of the permuted order is column 2t, position t + 4 column 2t + 1."""
    for t in range(4):
        assert PERM[t] == 2 * t and PERM[t + 4] == 2 * t + 1
    assert sorted(PERM) == list(range(8))


# -- the ablation tool ------------------------------------------------------------
@pytest.mark.parametrize("variant", sorted(flash_ablate.CUTS))
def test_ablation_edits_apply_to_the_kernel_source(variant):
    """Each cut of ``tools/flash_ablate.py`` finds its text in
    ``csrc/flash_bwd_wgmma.cu`` exactly once."""
    with open(build.source_path("flash_bwd_wgmma"), encoding="utf-8") as f:
        src = f.read()
    cut = flash_ablate.variant_source(variant)
    assert (cut == src) == (variant == "full")
    assert "mxtt_flash_dkv_wgmma" in cut


def test_ablation_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        flash_ablate.main(["--iters", "1"])


# -- on the card ---------------------------------------------------------------
# (BH, Tq, Tk, D, causal) of tests/test_torch_transformer_train.py's
# CUDA_CASES, and the wgmma design's tile edges
CUDA_CASES = [(4, 200, 200, 16, True), (3, 97, 130, 64, False),
              (2, 1, 16, 16, True), (2, 70, 70, 128, True),
              (2, 70, 130, 32, True), (2, 70, 130, 16, True),
              (2, 130, 70, 16, True), (3, 33, 97, 12, False),
              (2, 130, 70, 4, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["wgmma", "simt"])
def test_each_design_matches_plain_on_cuda(design):
    """Each design, forced, against the plain version on the card at 1e-4,
    every case it takes; reruns bitwise; each launch counted on its
    design."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for i, (bh, tq, tk, d, causal) in enumerate(CUDA_CASES):
        if design == "wgmma" and not pk.wgmma_takes(d):
            continue
        gen = torch.Generator(device="cuda").manual_seed(i)
        q, do = (torch.randn(bh, tq, d, device="cuda", generator=gen)
                 for _ in range(2))
        k, v = (torch.randn(bh, tk, d, device="cuda", generator=gen)
                for _ in range(2))
        scale = d ** -0.5
        o, lse = pk.flash_forward_with_lse_reference(q, k, v, causal, scale)
        args = (q, k, v, do, lse, pk.flash_delta(o, do), causal, scale)
        before = _counts()
        runs = [(pk._flash_dq(*args, design=design),)
                + pk._flash_dkv(*args, design=design) for _ in range(2)]
        torch.cuda.synchronize()
        after = _counts()
        assert after["flash_dq/" + design] == before["flash_dq/" + design] + 2
        assert after["flash_dkv/" + design] \
            == before["flash_dkv/" + design] + 2
        want = (pk.flash_dq_reference(*args),) + pk.flash_dkv_reference(*args)
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
        print("(BH, T, D, causal) %s: max |emulation - reference| over "
              "dq, dk, dv: three TF32 passes %.3g, one pass %.3g"
              % (case, errs[0], errs[1]))
