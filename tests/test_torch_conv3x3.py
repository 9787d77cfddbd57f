"""The port's implicit-GEMM 3×3 convolution ``conv3x3_epilogue`` (B9) held
against the reference's Pallas kernel, run in interpret mode on the CPU
as ``tests/test_pallas_conv.py`` runs it; and the port's conv A/B harness
(``mxnet_tpu_torch.tools.conv_ab``).

Tolerances:
- int8 output: bitwise (exact int32 sums, the same two-rounding epilogue,
  half to even, clip after rounding).
- bf16: one bf16 ulp at the larger magnitude, magnitudes below 1/64 of
  the outputs' RMS counted at that floor (the reference sums bf16
  products in float32, the plain version in float64; near zero a bf16
  ulp is finer than the float32 sums' own rounding).
- float32: 1e-4 relative to max(1, max |reference|) (float32 against
  float64 sums over K = 4608).
- An int8 input with a float32 output is not rounded: bitwise equal to
  the reference's two-rounding formula; against the reference's
  interpret-mode run, whose CPU compiler contracts the epilogue's
  multiply-add into an FMA, within the rounding that contraction moves
  (half a float32 ulp of ``acc * scale`` plus one of the result).
"""
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax import lax

from mxnet_tpu.ops.pallas_kernels import conv3x3_epilogue as j_conv3x3
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import pallas_kernels as pk
from mxnet_tpu_torch.tools import conv_ab, conv_ablate

F32_RTOL = 1e-4
BF16_FLOOR = 2.0 ** -6
ROUTES = ("conv3x3_epilogue", "conv3x3_epilogue[int8]",
          "conv3x3_epilogue[bf16]", "conv3x3_epilogue[float32]",
          "conv3x3_epilogue/wgmma", "conv3x3_epilogue/mma")
# the conv A/B harness's four stages and CONV_RAGGED's widest shape, as
# ((N, H, W, Cin), Cout)
WGMMA_SHAPES = [((256, h, w, c), c) for h, w, c in conv_ab.STAGES] + [
    ((1, 7, 7, 512), 512)]
# the wgmma design's tile edges: M = 189 with Cout 96, Cout 200 over two
# 128-wide tiles, a 128-position tile over two images of 99 positions
WGMMA_EDGES = [((3, 7, 9, 64), 96), ((1, 5, 5, 128), 200),
               ((2, 9, 11, 64), 64)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _counts():
    return {k: pk.launch_counts()[k] for k in ROUTES}


def _int8_inputs(shape, cout, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.randint(-127, 128, shape).astype(np.int8)
    w = rng.randint(-16, 16, (3, 3, c, cout)).astype(np.int8)
    scale = (rng.rand(cout) * 0.01 + 1e-3).astype(np.float32)
    shift = rng.randn(cout).astype(np.float32)
    return x, w, scale, shift


def _float_inputs(shape, cout, seed, w_std):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, shape[-1], cout) * w_std).astype(np.float32)
    scale = (rng.rand(cout) + 0.5).astype(np.float32)
    shift = rng.randn(cout).astype(np.float32)
    return x, w, scale, shift


def _reference(x, w, scale, shift, relu, out_dtype=None):
    return np.asarray(j_conv3x3(x, w, scale, shift, relu=relu,
                                out_dtype=out_dtype))


def _bf16_ulps(got, want):
    """|got - want| in bf16 ulps at max(|got|, |want|, floor)."""
    got, want = np.float32(got), np.float32(want)
    floor = BF16_FLOOR * np.sqrt(np.mean(want.astype(np.float64) ** 2))
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), floor)
    ulp = np.ldexp(1.0, np.frexp(np.maximum(mag, 2.0 ** -126))[1] - 8)
    return np.abs(got - want) / ulp


def _xla_acc(x, w):
    """The reference oracle's exact int32 convolution."""
    dn = lax.conv_dimension_numbers(x.shape, w.shape,
                                    ("NHWC", "HWIO", "NHWC"))
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=dn, preferred_element_type=jnp.int32))


# -- the port against the reference's Pallas kernel ---------------------------
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape,cout", [
    ((2, 8, 8, 16), 32), ((4, 6, 6, 16), 32), ((1, 14, 14, 8), 16),
    ((2, 6, 6, 8), 24),          # Cout below every tile
    ((2, 9, 11, 3), 5)])         # Cin 3, odd W, Cout 5
def test_int8_bitwise_equal_to_pallas_reference(shape, cout, relu):
    x, w, scale, shift = _int8_inputs(shape, cout, sum(shape) + cout)
    want = _reference(jnp.asarray(x), jnp.asarray(w), scale, shift, relu)
    before = _counts()
    got = pk.conv3x3_epilogue(_t(x), _t(w), scale, shift, relu=relu)
    assert _counts() == before          # the plain version on the CPU
    assert got.dtype == torch.int8 and tuple(got.shape) == shape[:-1] + (
        cout,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 50    # the codes spread over the range


@pytest.mark.parametrize("relu", [True, False])
def test_bf16_within_one_ulp_of_pallas_reference(relu):
    x, w, scale, shift = _float_inputs((2, 8, 8, 16), 32, 1, 0.1)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = _reference(xb, wb, scale, shift, relu)
    assert want.dtype == jnp.bfloat16
    got = pk.conv3x3_epilogue(_t(np.float32(xb)).to(torch.bfloat16),
                              _t(np.float32(wb)).to(torch.bfloat16),
                              _t(scale), _t(shift), relu=relu)
    assert got.dtype == torch.bfloat16
    ulps = _bf16_ulps(got.float().numpy(), np.float32(want))
    assert ulps.max() <= 1.0, ulps.max()


def test_f32_matches_pallas_reference():
    x, w, scale, shift = _float_inputs((2, 28, 28, 512), 128, 0, 0.05)
    want = _reference(jnp.asarray(x), jnp.asarray(w), scale, shift, False)
    got = pk.conv3x3_epilogue(_t(x), _t(w), scale, shift, relu=False)
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    assert err <= F32_RTOL * max(1.0, np.abs(want).max()), err


def test_int8_in_float32_out_is_not_rounded():
    x, w, scale, shift = _int8_inputs((2, 8, 8, 16), 32, 3)
    got = pk.conv3x3_epilogue(_t(x), _t(w), scale, shift, relu=True,
                              out_dtype=torch.float32).numpy()
    assert got.dtype == np.float32
    acc = _xla_acc(x, w).astype(np.float32)
    oracle = np.maximum((acc * scale).astype(np.float32) + shift, 0.0)
    np.testing.assert_array_equal(got, oracle)
    pos = got[got > 0]
    assert (pos != np.round(pos)).mean() > 0.9
    want = _reference(jnp.asarray(x), jnp.asarray(w), scale, shift, True,
                      out_dtype=jnp.float32)
    # a contracted FMA skips the product's rounding (half an ulp of it)
    # and rounds its sum once: half an ulp of either result
    mag = np.maximum(np.abs(got), np.abs(want))
    bound = np.spacing(np.abs(acc * scale)) / 2 + np.spacing(mag)
    assert (np.abs(got - want) <= bound).all()


# -- the plain version on its own ---------------------------------------------
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_plain_equals_an_independent_float64_conv2d(dtype):
    """The im2col plain version against ``F.conv2d`` in float64: exact
    sums of exact products either way, so the float32 outputs are equal."""
    if dtype == torch.int8:
        x, w, scale, shift = (_t(a) for a in _int8_inputs((2, 7, 9, 24), 40,
                                                          5))
    else:
        x, w, scale, shift = (_t(a) for a in _float_inputs((2, 7, 9, 24), 40,
                                                           5, 0.1))
        x, w = x.to(dtype), w.to(dtype)
    got = pk.conv3x3_epilogue_reference(x, w, scale, shift, relu=False,
                                        out_dtype=torch.float32)
    acc = F.conv2d(x.double().permute(0, 3, 1, 2),
                   w.double().permute(3, 2, 0, 1), padding=1)
    want = acc.permute(0, 2, 3, 1).float() * scale + shift
    assert torch.equal(got, want)


def test_requant_keeps_b8_results_and_takes_per_channel_scales():
    rng = np.random.RandomState(7)
    acc = _t(rng.randint(-2 ** 20, 2 ** 20, (64, 24)).astype(np.int32))
    bias = _t((rng.randn(24) * 10).astype(np.float32))
    scale = 60.0 / (np.sqrt(512) * 127 * 127 / 3)
    for relu in (True, False):
        # the epilogue as B8 computed it before per-channel scales
        real = acc.float() * torch.full((), scale, dtype=torch.float32) \
            + bias
        if relu:
            real = torch.clamp_min(real, 0.0)
        before = torch.round(real).clamp(-127, 127).to(torch.int8)
        assert torch.equal(pk._requant(acc, scale, bias, relu), before)
        same = torch.full((24,), scale, dtype=torch.float32)
        assert torch.equal(pk._requant(acc, same, bias, relu), before)
    per = _t((rng.rand(24) * 1e-3).astype(np.float32))
    got = pk._requant(acc, per, bias, False)
    for c in (0, 11, 23):
        col = pk._requant(acc[:, c], float(per[c]), bias[c], False)
        assert torch.equal(got[:, c], col)
    as_float = pk._requant(acc, per, bias, False, torch.float32)
    assert torch.equal(as_float, acc.float() * per + bias)


def test_refuses_bad_operands():
    x = torch.zeros(1, 4, 4, 8, dtype=torch.int8)
    w = torch.zeros(3, 3, 8, 4, dtype=torch.int8)
    ones, zeros = np.ones(4, np.float32), np.zeros(4, np.float32)
    with pytest.raises(MXNetError, match="one dtype"):
        pk.conv3x3_epilogue(x, w.float(), ones, zeros)
    with pytest.raises(MXNetError, match="one dtype"):
        pk.conv3x3_epilogue(x.to(torch.int32), w.to(torch.int32), ones,
                            zeros)
    with pytest.raises(MXNetError, match=r"\(3, 3, Cin, Cout\)"):
        pk.conv3x3_epilogue(x, w[:, :, :4], ones, zeros)
    with pytest.raises(MXNetError, match="scale"):
        pk.conv3x3_epilogue(x, w, np.ones(5, np.float32), zeros)
    meta = pk.conv3x3_epilogue(x.to("meta"), w.to("meta"), ones, zeros,
                               out_dtype=torch.bfloat16)
    assert meta.shape == (1, 4, 4, 4) and meta.dtype == torch.bfloat16


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """Both designs against the plain version on the card: int8 bitwise,
    bf16 within one ulp, relu on and off, each launch on the design
    ``conv3x3_design`` names — the mma.sync design at Cin 16 and 3, the
    wgmma design at a harness stage and across its tile edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for shape, cout in [((2, 8, 8, 16), 32), ((2, 9, 11, 3), 5),
                        ((4, 28, 28, 128), 128)] + WGMMA_EDGES:
        for relu in (True, False):
            x, w, scale, shift = (_t(a).cuda() for a in _int8_inputs(
                shape, cout, 0))
            design = "conv3x3_epilogue/" + pk.conv3x3_design(
                shape[-1], torch.int8)
            before = pk.launch_counts()
            got = pk.conv3x3_epilogue(x, w, scale, shift, relu=relu)
            want = pk.conv3x3_epilogue_reference(x, w, scale, shift, relu)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            after = pk.launch_counts()
            for key in ("conv3x3_epilogue[int8]", design):
                assert after[key] == before[key] + 1
            xb, wb, sb, hb = (_t(a).cuda() for a in _float_inputs(
                shape, cout, 0, 0.05))
            xb, wb = xb.to(torch.bfloat16), wb.to(torch.bfloat16)
            design = "conv3x3_epilogue/" + pk.conv3x3_design(
                shape[-1], torch.bfloat16)
            before = pk.launch_counts()[design]
            got = pk.conv3x3_epilogue(xb, wb, sb, hb, relu=relu)
            want = pk.conv3x3_epilogue_reference(xb, wb, sb, hb, relu)
            ulps = _bf16_ulps(got.float().cpu().numpy(),
                              want.float().cpu().numpy())
            assert ulps.max() <= 1.0
            assert pk.launch_counts()[design] == before + 1
    # the two designs agree with each other on a wgmma-design shape
    x, w, scale, shift = (_t(a).cuda() for a in _int8_inputs(
        (3, 7, 9, 64), 96, 1))
    assert torch.equal(
        pk._conv3x3_epilogue(x, w, scale, shift, design="mma"),
        pk._conv3x3_epilogue(x, w, scale, shift, design="wgmma"))


# -- the choice of design -------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", WGMMA_SHAPES + WGMMA_EDGES)
def test_design_wgmma_takes_the_stages_and_edges(shape, cout, dtype):
    assert pk.conv3x3_design(shape[-1], dtype) == "wgmma"


@pytest.mark.parametrize("cin,dtype,aligned", [
    (3, torch.int8, True), (3, torch.bfloat16, True),   # CONV_RAGGED's Cin 3
    (8, torch.int8, True), (16, torch.int8, True),      # int8 Cin 8, 16
    (8, torch.bfloat16, True), (16, torch.bfloat16, True),
    (48, torch.int8, True),                             # 48 bytes a tap
    (64, torch.float32, True), (512, torch.float32, True),
    (64, torch.int8, False), (256, torch.bfloat16, False)])  # unaligned x
def test_design_mma_takes_the_rest(cin, dtype, aligned):
    assert pk.conv3x3_design(cin, dtype, aligned) == "mma"


def test_design_rule_is_whole_64_byte_channel_slices():
    for cin in range(1, 1025):
        for dtype in (torch.int8, torch.bfloat16):
            want = "wgmma" if cin * dtype.itemsize % 64 == 0 else "mma"
            assert pk.conv3x3_design(cin, dtype) == want, (cin, dtype)


def test_forced_design_on_the_cpu_is_the_plain_version():
    x, w, scale, shift = (_t(a) for a in _int8_inputs((3, 7, 9, 64), 96, 2))
    before = _counts()
    want = pk.conv3x3_epilogue_reference(x, w, scale, shift)
    for design in ("wgmma", "mma"):
        got = pk._conv3x3_epilogue(x, w, scale, shift, design=design)
        assert torch.equal(got, want)
    assert _counts() == before


# -- the ablation tool ------------------------------------------------------------
@pytest.mark.parametrize("variant", sorted(conv_ablate.CUTS))
def test_ablation_edits_apply_to_the_kernel_source(variant):
    """Each cut of ``tools/conv_ablate.py`` finds its text in
    ``csrc/conv3x3_wgmma.cu`` exactly once, so the tool times the kernel
    as it is, less that one part."""
    from mxnet_tpu_torch.ops import build
    with open(build.source_path("conv3x3_wgmma"), encoding="utf-8") as f:
        src = f.read()
    cut = conv_ablate.variant_source(variant)
    assert (cut == src) == (variant == "full")
    assert "mxtt_conv3x3_wgmma" in cut


def test_ablation_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        conv_ablate.main(["--batch", "1", "--iters", "1"])


# -- the A/B harness ------------------------------------------------------------
def test_harness_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        conv_ab.main(["--batch", "1", "--iters", "1"])


def test_harness_runs_on_the_cpu_and_prints_its_records(capsys):
    before = _counts()
    recs = conv_ab.main(["--batch", "2", "--iters", "1", "--device", "cpu",
                         "--dtypes", "int8", "bf16"])
    assert _counts() == before
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines()]
    assert lines == recs and len(recs) == 16
    assert [(tuple(r["stage"]), r["dtype"], r["impl"]) for r in recs] == [
        (s, d, i) for s in conv_ab.STAGES for d in ("int8", "bf16")
        for i in ("library", "kernel")]
    for r in recs:
        assert r["device"] == "cpu" and "error" not in r, r
        assert r["ms"] > 0 and r["img_per_s"] == pytest.approx(
            2e3 / r["ms"])


@pytest.mark.parametrize("relu", [True, False])
def test_int8_library_route_equals_the_plain_version(relu):
    """The harness's int8 library route (im2col + int8 GEMM + epilogue)
    computes B9's function: bitwise equal on the CPU."""
    x, w, scale, shift = (_t(a) for a in _int8_inputs((2, 7, 7, 32), 32,
                                                      9))
    assert torch.equal(conv_ab.library_int8(x, w, scale, shift, relu),
                       pk.conv3x3_epilogue_reference(x, w, scale, shift,
                                                     relu))
