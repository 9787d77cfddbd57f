"""B4, the LayerNorm forward kernel (``csrc/fused_ln.cu``), held on the
CPU through a numpy float32 emulation of its order of operations.

The kernel runs only on the card.  What it computes in which order is
emulated here: the row on the 32 lanes of a warp (lanes strided over
single columns, or runs of 4 columns a lane where a variant moves
float4s), each lane's partials in its own order, then the reduction —
the two xor shuffle trees (mean, then the centred sum of squares), or the
one tree that merges each lane's (count, mean, M2) (Chan's form, kept as
a variant).  Fused multiply-adds (``ss += xc * xc``, the variance's
``* inv_d + eps``, the output's ``* scale + bias``) round once, as on
the card; ``rsqrtf`` is taken as the correctly rounded reciprocal square
root (the card's is within 2 ulp).  Each emulated form is held to the
reference's ``fused_layer_norm`` (the Pallas kernel in interpret mode on
the CPU) and to the port's ``layer_norm_reference`` within 1e-5 (f32;
only the order of the sums differs), at the decode and prefill shapes
and the ragged widths 3, 33, 96 and 1100 (the re-read kernel, which
strides like the scalar layout), on inputs made from a seed with numpy.

Which parts the main path runs is read from the source (``kShipped``),
and the names agree with ``ops.fused_optimizer.LN_PARTS``.  On a card
(``cuda`` marker) the kernel and every ablation variant are held to the
plain version.
"""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import fused_optimizer as jax_fused
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused_optimizer as F
from mxnet_tpu_torch.tools import ln_ablate

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SOURCE = os.path.join(REPO, "mxnet_tpu_torch", "csrc", "fused_ln.cu")

LN_TOL = 1e-5
EPS = 1e-5
# (leading shape, d): the decode step's slot batch, a prefill bucket of 8
# and one position; the prefill; the ragged widths (1100: the re-read
# kernel past d = 1024)
SHAPES = [((8, 1), 128), ((1, 8), 128), ((1, 1), 128), ((1024,), 128),
          ((5,), 3), ((3,), 33), ((37,), 96), ((5,), 1100)]
# the kernel's layouts: lanes strided over single columns (the shipped
# one, and the re-read kernel's), and runs of 4 columns a lane moved as
# float4 (the vec4 variant, where d % 4 == 0)
LAYOUTS = {"scalar": False, "vec4": True}
F32 = np.float32


def _inputs(lead, d, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*lead, d) * 3 + 1).astype(F32)
    s = rng.randn(d).astype(F32)
    b = rng.randn(d).astype(F32)
    return x, s, b


def _fma(a, b, c):
    """``a * b + c`` rounded once to float32 (the product is exact in
    float64; the sum rounds there first, which can differ from one
    rounding in the last place only on a tie)."""
    f64 = [np.asarray(t, np.float64) for t in (a, b, c)]
    return (f64[0] * f64[1] + f64[2]).astype(F32)


def _columns(d, vec):
    """``(32, P)`` column of value j of lane l, and whether it lies in
    the row."""
    per = -(-d // 32)
    if vec:
        per = -(-per // 4) * 4
    j = np.arange(per)[None, :]
    lane = np.arange(32)[:, None]
    col = ((j // 4) * 32 + lane) * 4 + j % 4 if vec else j * 32 + lane
    return col, col < d


def _tree(v):
    """The xor shuffle tree over axis 1 (lanes): ``v[l] + v[l ^ off]``."""
    for off in (16, 8, 4, 2, 1):
        v = v + v[:, np.arange(32) ^ off]
    return v


def emulate(x, scale, bias, layout="scalar", merge=False, eps=EPS):
    """The kernel's f32 arithmetic in its order, over rows at once."""
    d = x.shape[-1]
    rows = x.reshape(-1, d)
    vec = LAYOUTS[layout] and d % 4 == 0     # else the scalar path
    col, ok = _columns(d, vec)
    v = np.where(ok, rows[:, np.minimum(col, d - 1)], F32(0))  # (R, G, P)
    inv_d = F32(1) / F32(d)
    if merge:
        n = ok.sum(1).astype(F32)[None, :].repeat(len(rows), 0)
        s = np.zeros(n.shape, F32)
        for j in range(v.shape[2]):
            s = np.where(ok[:, j], s + v[:, :, j], s)
        m = np.where(n > 0, s / np.where(n > 0, n, F32(1)), F32(0))
        m2 = np.zeros(n.shape, F32)
        for j in range(v.shape[2]):
            dv = v[:, :, j] - m
            m2 = np.where(ok[:, j], _fma(dv, dv, m2), m2)
        for off in (16, 8, 4, 2, 1):
            p = np.arange(32) ^ off
            nb, mb, m2b = n[:, p], m[:, p], m2[:, p]
            nt = n + nb
            delta = mb - m
            eq = n == nb
            safe = np.where(nt > 0, nt, F32(1))
            m_gen = (n * m + nb * mb) / safe
            w_gen = (n * nb) / safe
            m = np.where(eq, (m + mb) * F32(0.5), np.where(nt > 0, m_gen, m))
            w = np.where(eq, n * F32(0.5), np.where(nt > 0, w_gen, F32(0)))
            m2 = (m2 + m2b) + (delta * delta) * w
            n = nt
        # the merge is symmetric in the two lanes: all end with one value
        assert (m == m[:, :1]).all() and (m2 == m2[:, :1]).all()
        mu, var_sum = m[:, :1], m2[:, :1]
        xc = v - mu[:, :, None]
    else:
        s = np.zeros(v.shape[:2], F32)
        for j in range(v.shape[2]):
            s = s + v[:, :, j]
        mu = _tree(s)[:, :1] * inv_d
        xc = np.where(ok, v - mu[:, :, None], F32(0))
        ss = np.zeros(v.shape[:2], F32)
        for j in range(v.shape[2]):
            ss = _fma(xc[:, :, j], xc[:, :, j], ss)
        var_sum = _tree(ss)[:, :1]
    rstd = (1.0 / np.sqrt(np.asarray(_fma(var_sum, inv_d, F32(eps)),
                                     np.float64))).astype(F32)
    y = _fma(xc * rstd[:, :, None], scale[np.minimum(col, d - 1)],
             bias[np.minimum(col, d - 1)])
    out = np.empty_like(rows)
    out[:, col[ok]] = y[:, ok]
    return out.reshape(x.shape)


def _want(x, s, b):
    pallas = np.asarray(jax_fused.fused_layer_norm(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    plain = F.layer_norm_reference(torch.from_numpy(x), torch.from_numpy(s),
                                   torch.from_numpy(b)).numpy()
    return pallas, plain


def _source_parts():
    """``{name: bit}`` of the source's enum and the shipped set."""
    with open(SOURCE, encoding="utf-8") as f:
        src = f.read()
    enum = dict((k, int(v)) for k, v in
                re.findall(r"^\s+k(\w+) = (\d+),", src, re.M))
    shipped = re.search(r"kShipped = ([^;]+);", src).group(1)
    return enum, {p.strip()[1:] for p in shipped.split("|")}


# ---------------------------------------------------------------------------
# the emulated arithmetic against both references
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lead,d", SHAPES)
def test_shipped_order_matches_the_references(lead, d):
    """The main path's form: lanes strided over the columns, the two
    trees over 32 lanes (loading the parameters early changes no
    arithmetic)."""
    x, s, b = _inputs(lead, d, seed=d + len(lead))
    got = emulate(x, s, b, "scalar")
    assert got.shape == x.shape and np.isfinite(got).all()
    pallas, plain = _want(x, s, b)
    np.testing.assert_allclose(got, pallas, rtol=LN_TOL, atol=LN_TOL)
    np.testing.assert_allclose(got, plain, rtol=LN_TOL, atol=LN_TOL)


@pytest.mark.parametrize("layout,merge", [("vec4", False), ("vec4", True),
                                          ("scalar", True)])
@pytest.mark.parametrize("lead,d", [((8, 1), 128), ((1024,), 128),
                                    ((3,), 33), ((37,), 96)])
def test_variant_orders_match_the_references(lead, d, layout, merge):
    """The ablation variants' orders: float4 runs, and the (count, mean,
    M2) merge (whose unequal-count branch the ragged widths take) on
    either layout, each within 1e-5."""
    x, s, b = _inputs(lead, d, seed=7 * d + len(lead))
    got = emulate(x, s, b, layout, merge)
    pallas, plain = _want(x, s, b)
    np.testing.assert_allclose(got, pallas, rtol=LN_TOL, atol=LN_TOL)
    np.testing.assert_allclose(got, plain, rtol=LN_TOL, atol=LN_TOL)


def test_emulated_layouts_cover_every_column_once():
    for d in (3, 4, 33, 96, 128, 160, 256, 1024, 1100):
        for layout, vec in LAYOUTS.items():
            col, ok = _columns(d, vec and d % 4 == 0)
            assert sorted(col[ok].tolist()) == list(range(d)), (d, layout)


# ---------------------------------------------------------------------------
# the source's parts and the wrapper
# ---------------------------------------------------------------------------
def test_parts_agree_with_the_source():
    enum, shipped = _source_parts()
    names = {"EarlyParams": "early_params", "Vec4": "vec4",
             "Merge": "merge", "RowWarps": "row_warps"}
    assert {names[k]: v for k, v in enum.items()} == F.LN_PARTS
    # the emulation's shipped form: lanes strided, two trees
    assert {names[k] for k in shipped} == {"early_params"}
    vs = ln_ablate.variants(sorted(names[k] for k in shipped))
    assert vs["previous"] == [] and len(vs) == len(F.LN_PARTS) + 2
    assert vs["with_merge"] == ["early_params", "merge"]
    assert vs["no_early_params"] == []
    every = ln_ablate.variants((), every=True)
    assert len(every) == 2 ** len(F.LN_PARTS)
    assert every["set:"] == [] and every["set:early_params"] == [
        "early_params"]


def test_variants_run_on_the_card_only():
    x, s, b = (torch.from_numpy(a) for a in _inputs((2,), 128, 0))
    with pytest.raises(MXNetError, match="card only"):
        F._fused_layer_norm_parts(x, s, b, ())
    with pytest.raises(MXNetError, match="no part"):
        F._fused_layer_norm_parts(x, s, b, ("twiddle",))
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError):
            ln_ablate.main([])


@pytest.mark.cuda
def test_kernel_and_every_variant_match_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    shipped = F.ln_shipped_parts()
    for lead, d in SHAPES + [((2, 5, 3), 160), ((130,), 64), ((9,), 1024)]:
        x, s, b = (torch.from_numpy(a).cuda()
                   for a in _inputs(lead, d, seed=d))
        want = F.layer_norm_reference(x, s, b)
        got = F.fused_layer_norm(x, s, b)
        torch.testing.assert_close(got, want, rtol=LN_TOL, atol=LN_TOL)
        assert torch.equal(got, F.fused_layer_norm(x, s, b))
        assert torch.equal(got, F._fused_layer_norm_parts(x, s, b, shipped))
        for v, parts in ln_ablate.variants(shipped).items():
            torch.testing.assert_close(
                F._fused_layer_norm_parts(x, s, b, parts), want,
                rtol=LN_TOL, atol=LN_TOL, msg=lambda m, v=v: v + ": " + m)
