"""The bf16 routes of the flash kernels (B5 ``flash_forward_with_lse``, B6
``flash_dq``, B7 ``flash_dkv``) and the bf16 ring of ring attention,
held against mxnet_tpu.

- Each wrapper's plain version on bfloat16 inputs (the f32 plain version
  on the widened inputs, its outputs rounded to bfloat16) against the
  reference's Pallas kernel in interpret mode on the same bfloat16
  inputs, per hop pairing: out, dq, dk and dv within one bf16 ulp
  elementwise (both compute in f32 and round once, so only an f32 value
  that lands within its summation-order difference of a rounding
  boundary rounds the other way; magnitudes are counted no finer than
  1/64 of the outputs' RMS, where a bf16 ulp is finer than the rounding
  of the f32 sums), lse within 1e-5 (f32).  Outputs are bfloat16, lse float32.
- Ring attention over ``(K, B, Tl, H, D)`` bfloat16 chunks (K = 2, causal
  and full) against the reference's ``ring_attention_sharded`` on a
  K-device CPU mesh: forward and gradients within 2 bf16 ulps of the
  largest magnitude (each hop rounds its output before the f32 merge, in
  the reference's order; the merged output and the per-hop gradients'
  sum round once more).
- ``flash_design`` sends bfloat16 calls of all three to the ``"bf16"``
  route except at the bf16 wgmma design's head dims
  (``tests/test_torch_flash_bf16_wgmma.py``); a forced design must match
  the operands' dtype, and mixed dtypes are refused.
- ``cuda``-marked tests hold each bf16 kernel to its plain version on a
  card (skipped here; ``chip_smoke.py`` phase 17 runs them at the
  training path's shapes).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from mxnet_tpu.ops import pallas_kernels as jax_pk
from mxnet_tpu.parallel import ring_attention_sharded as jax_ring_sharded
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import pallas_kernels as pk
from mxnet_tpu_torch.parallel import ring_attention_sharded

# (BH, Tq, Tk, D): the small width, T over the 128-row Pallas block with a
# ragged tail, Tq != Tk, and the head dims 64 / 128 of the CUDA-core route
SHAPES = [(2, 16, 16, 4), (3, 200, 200, 8), (2, 192, 160, 16),
          (2, 70, 130, 64), (1, 40, 40, 128)]


def _bf16(rng, *shape):
    """bfloat16 values as (numpy f32 array holding them, torch tensor)."""
    t = torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()
    return t.float().numpy(), t


def _jbf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


ULP_FLOOR = 1.0 / 64


def _ulps(got, want):
    """Elementwise |got - want| in bf16 ulps at max(|got|, |want|), a
    magnitude below ``ULP_FLOOR`` x rms(want) taken at that floor (as
    ``chip_smoke.py``'s ``_bf16_ulps``): an output that cancels to near
    zero carries the f32 sums' rounding, far above its own bf16 ulp."""
    g, w = got.astype(np.float64), want.astype(np.float64)
    floor = ULP_FLOOR * float(np.sqrt(np.mean(w * w)))
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), max(floor, 2.0 ** -126))
    return np.abs(g - w) / 2.0 ** (np.floor(np.log2(mag)) - 7)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within_one_ulp(got, want, what):
    assert got.dtype == torch.bfloat16, what
    u = _ulps(_f32(got), _f32(want))
    assert u.max() <= 1.0, (what, float(u.max()))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,tq,tk,d", SHAPES)
def test_bf16_plain_versions_match_pallas_per_hop(bh, tq, tk, d, causal):
    rng = np.random.RandomState(tq + tk + d)
    q, tq_ = _bf16(rng, bh, tq, d)
    do, tdo = _bf16(rng, bh, tq, d)
    k, tk_ = _bf16(rng, bh, tk, d)
    v, tv = _bf16(rng, bh, tk, d)
    scale = d ** -0.5
    jq, jk, jv, jdo = (_jbf16(a) for a in (q, k, v, do))
    want_o, want_lse = jax_pk.flash_forward_with_lse(jq, jk, jv, causal,
                                                     scale, interpret=True)
    assert want_o.dtype == jnp.bfloat16
    before = pk.launch_counts()
    got_o, got_lse = pk.flash_forward_with_lse(tq_, tk_, tv, causal, scale)
    assert got_lse.dtype == torch.float32 and got_lse.shape == (bh, tq)
    _within_one_ulp(got_o, want_o, "out")
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=1e-5, atol=1e-5)
    # the backward kernels on the reference's (lse, delta)
    delta = jax_pk.flash_delta(want_o, jdo)
    tdelta = pk.flash_delta(torch.from_numpy(_f32(want_o).copy()).bfloat16(),
                           tdo)
    np.testing.assert_allclose(tdelta.numpy(), np.asarray(delta), rtol=1e-5,
                               atol=1e-5)
    args = (jq, jk, jv, jdo, want_lse, delta, causal, scale)
    targs = (tq_, tk_, tv, tdo, torch.from_numpy(np.asarray(want_lse)),
             torch.from_numpy(np.asarray(delta)), causal, scale)
    _within_one_ulp(pk.flash_dq(*targs),
                    jax_pk.flash_dq(*args, interpret=True), "dq")
    got_dk, got_dv = pk.flash_dkv(*targs)
    want_dk, want_dv = jax_pk.flash_dkv(*args, interpret=True)
    _within_one_ulp(got_dk, want_dk, "dk")
    _within_one_ulp(got_dv, want_dv, "dv")
    # CPU tensors take the plain versions: no kernel launch is counted
    assert pk.launch_counts() == before


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_ring_attention_matches_reference(causal):
    k_ranks, B, T, H, D = 2, 2, 32, 4, 8
    rng = np.random.RandomState(5)
    arrs = [_bf16(rng, B, T, H, D) for _ in range(4)]
    (q, tq_), (k, tk_), (v, tv), (g, tg) = arrs
    mesh = Mesh(np.array(jax.devices()[:k_ranks]), ("sp",))
    jargs = [_jbf16(a) for a in (q, k, v)]
    want, vjp = jax.vjp(lambda a, b, c: jax_ring_sharded(
        a, b, c, mesh, "sp", causal=causal), *jargs)
    want_grads = vjp(_jbf16(g))
    ts = [t.clone().requires_grad_() for t in (tq_, tk_, tv)]
    got = ring_attention_sharded(*ts, k_ranks, causal=causal)
    assert got.dtype == torch.bfloat16
    got.backward(tg)
    for name, a, b in (("out", got.detach(), want),
                       ("dq", ts[0].grad, want_grads[0]),
                       ("dk", ts[1].grad, want_grads[1]),
                       ("dv", ts[2].grad, want_grads[2])):
        assert a.dtype == torch.bfloat16, name
        a32, b32 = _f32(a), _f32(b)
        top = float(np.abs(b32).max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        assert float(np.abs(a32 - b32).max()) <= 2 * ulp, name


def test_bf16_route_design_and_refusals():
    # all three take the bf16 wgmma design at D % 8 == 0 up to 32 (the ring
    # path's D = 16 among them), the CUDA-core bf16 route elsewhere
    for d in (4, 16, 32, 64, 128, 320):
        for w in ("flash_forward_with_lse", "flash_dq", "flash_dkv"):
            want = "wgmma_bf16" if d in (16, 32) else "bf16"
            assert pk.flash_design(d, w, dtype=torch.bfloat16) == want
    assert pk.flash_design(16, "flash_dq") == "wgmma"
    assert pk.flash_design(64, "flash_dq") == "simt"
    for w in ("flash_forward_with_lse", "flash_dq", "flash_dkv"):
        entry = {"flash_forward_with_lse": "mxtt_flash_fwd_bf16",
                 "flash_dq": "mxtt_flash_dq_bf16",
                 "flash_dkv": "mxtt_flash_dkv_bf16"}[w]
        assert pk._FLASH_DESIGNS["bf16"][w] == ("flash_attention", entry)
        assert pk.LAUNCHES[w + "/bf16"] >= 0
    q = torch.zeros(1, 4, 4, dtype=torch.bfloat16)
    with pytest.raises(MXNetError, match="want torch.bfloat16"):
        pk.flash_forward_with_lse(q, q.float(), q, True, 0.5)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        pk.flash_forward_with_lse(*(q.half() for _ in range(3)), True, 0.5)
    lse = torch.zeros(1, 4)
    with pytest.raises(MXNetError, match="want torch.float32"):
        pk.flash_dq(q, q, q, q, lse.bfloat16(), lse, True, 0.5)
    with pytest.raises(MXNetError, match="does not take"):
        pk._design_entry("flash_dq", (q,), 4, "simt")
    with pytest.raises(MXNetError, match="does not take"):
        pk._design_entry("flash_dq", (q.float(),), 4, "bf16")


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bf16 flash kernels have no "
                    "CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,tq,tk,d", SHAPES)
def test_bf16_kernels_match_plain_on_cuda(bh, tq, tk, d, causal):
    _needs_cuda()
    g = torch.Generator(device="cuda").manual_seed(tq + d)
    q, do = (torch.randn(bh, tq, d, device="cuda", generator=g).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(bh, tk, d, device="cuda", generator=g).bfloat16()
            for _ in range(2))
    scale = d ** -0.5
    before = pk.launch_counts()
    o, lse = pk.flash_forward_with_lse(q, k, v, causal, scale)
    want_o, want_lse = pk.flash_forward_with_lse_reference(q, k, v, causal,
                                                           scale)
    _within_one_ulp(o.cpu(), want_o.cpu(), "out")
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    delta = pk.flash_delta(want_o, do)
    args = (q, k, v, do, want_lse, delta, causal, scale)
    _within_one_ulp(pk.flash_dq(*args).cpu(),
                    pk.flash_dq_reference(*args).cpu(), "dq")
    for got, want, what in zip(pk.flash_dkv(*args),
                               pk.flash_dkv_reference(*args), ("dk", "dv")):
        _within_one_ulp(got.cpu(), want.cpu(), what)
    after = pk.launch_counts()
    for w in ("flash_forward_with_lse", "flash_dq", "flash_dkv"):
        key = w + "/" + pk.flash_design(d, w, dtype=torch.bfloat16)
        assert after[key] == before[key] + 1
