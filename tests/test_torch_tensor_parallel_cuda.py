"""B4 and B5-B7 at the tensor-parallel layout's shapes on a card, each
against its plain version: LayerNorm over ``(Km, Ks, B, T/Ks, d)`` rows
(1e-5) and one ring hop of the flash kernels over ``Km * B * H/Km``
heads (forward 1e-5, backward 1e-4).  Marked ``cuda``: skipped without
a card.  On the card: ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_tensor_parallel_cuda.py -q``.
"""
import pytest
import torch

from mxnet_tpu_torch.ops import fused_optimizer as fo
from mxnet_tpu_torch.ops import pallas_kernels as pk


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
def test_tp_layout_kernels_match_plain_on_cuda():
    _needs_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, 2, 4, 8, 128, device="cuda", generator=gen)
    s, b = (torch.randn(128, device="cuda", generator=gen) for _ in "sb")
    before = fo.launch_counts()["fused_layer_norm"]
    got = fo.fused_layer_norm(x, s, b)
    torch.cuda.synchronize()
    assert fo.launch_counts()["fused_layer_norm"] == before + 1
    torch.testing.assert_close(got, fo.layer_norm_reference(x, s, b),
                               rtol=1e-5, atol=1e-5)
    q, k, v, do = (torch.randn(2 * 4 * 4, 64, 16, device="cuda",
                               generator=gen) for _ in range(4))
    o, lse = pk.flash_forward_with_lse(q, k, v, True, 0.25)
    want_o, want_lse = pk.flash_forward_with_lse_reference(q, k, v, True,
                                                           0.25)
    torch.testing.assert_close(o, want_o, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    args = (q, k, v, do, want_lse, pk.flash_delta(want_o, do), True, 0.25)
    torch.testing.assert_close(pk.flash_dq(*args), pk.flash_dq_reference(
        *args), rtol=1e-4, atol=1e-4)
    for got, want in zip(pk.flash_dkv(*args), pk.flash_dkv_reference(*args)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
