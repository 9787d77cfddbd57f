"""``mxnet_tpu_torch.test_utils`` against ``mxnet_tpu.test_utils`` on the
CPU: the same draws after one numpy seed, the same verdicts from the
comparison and gradient oracles, ``check_consistency`` over torch devices
(degenerate legs refused under ``require_distinct``), local and
``file://`` downloads only.  The card's half (``ctx_list`` of the card
and the CPU) is ``tests/test_torch_random_cuda.py``."""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import test_utils as jtu
from mxnet_tpu_torch import context, nd
from mxnet_tpu_torch import test_utils as tu
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def _on_cpu():
    with context.use("cpu"):
        yield


def test_default_context_and_list_gpus():
    assert tu.default_context().type == "cpu"
    assert tu.list_gpus() == []


def test_comparisons_match_reference():
    a = np.array([1.0, 2.0, 3.0], np.float32)
    for b in (a + 1e-7, a + 1e-3):
        assert tu.almost_equal(nd.array(a), b) == jtu.almost_equal(
            jmx.nd.array(a), b)
    tu.assert_almost_equal(nd.array(a), a * (1 + 1e-6))
    with pytest.raises(AssertionError):
        tu.assert_almost_equal(nd.array(a), a + 0.1)
    assert tu.same(nd.array(a), a) and not tu.same(a, a + 1)


def test_draws_match_reference_after_one_numpy_seed():
    np.random.seed(3)
    want = (jtu.rand_ndarray((3, 4)).asnumpy(), jtu.rand_shape_2d(),
            jtu.rand_shape_nd(3))
    np.random.seed(3)
    got = (tu.rand_ndarray((3, 4)).asnumpy(), tu.rand_shape_2d(),
           tu.rand_shape_nd(3))
    assert want[0].tobytes() == got[0].tobytes()
    assert want[1] == got[1] and tuple(want[2]) == tuple(got[2])
    np.random.seed(3)
    want = jtu.rand_ndarray((2, 2), stype="csr")
    np.random.seed(3)
    got = tu.rand_ndarray((2, 2), stype="csr")
    assert got.stype == "csr"
    assert want.asnumpy().tobytes() == got.asnumpy().tobytes()


def test_check_numeric_gradient_passes_and_catches_a_wrong_gradient():
    x = np.random.RandomState(0).rand(3, 2)
    tu.check_numeric_gradient(lambda a: a * a + nd.sin(a), [x.copy()],
                              ctx="cpu")
    jtu.check_numeric_gradient(lambda a: a * a + jmx.nd.sin(a), [x.copy()])
    # MakeLoss's backward is its grad_scale whatever the head gradient, so
    # a scaled loss's autograd gradient is not its derivative
    with pytest.raises(AssertionError):
        tu.check_numeric_gradient(lambda a: nd.MakeLoss(a * a) * 3.0,
                                  [x.copy()], ctx="cpu")


def test_check_consistency_legs_and_refusal():
    x = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    res = tu.check_consistency(lambda a: nd.softmax(a), [x],
                               ctx_list=["cpu", "cpu"])
    want = jtu.check_consistency(lambda a: jmx.nd.softmax(a), [x])
    np.testing.assert_allclose(res[0][0], want[0], rtol=1e-6, atol=1e-7)
    two = tu.check_consistency(lambda a: (a * 2, nd.topk(a, k=2)), [x],
                               scale_atol=True, rtol=0)
    assert len(two[0]) == 2
    with pytest.raises(RuntimeError, match="degenerate"):
        tu.check_consistency(lambda a: a, [x], ctx_list=["cpu", "cpu"],
                             require_distinct=True)


def test_download_local_and_file_urls_only(tmp_path):
    src = tmp_path / "weights.bin"
    src.write_bytes(b"\x01\x02\x03")
    out = tu.download(str(src), dirname=str(tmp_path / "a"))
    assert open(out, "rb").read() == b"\x01\x02\x03"
    out = tu.download(src.as_uri(), fname="w.bin",
                      dirname=str(tmp_path / "b"))
    assert os.path.basename(out) == "w.bin"
    with pytest.raises(MXNetError, match="file://"):
        tu.download("http://example.invalid/x.bin",
                    dirname=str(tmp_path / "c"))


def test_separable_images_match_reference():
    want = jtu.separable_images(np.random.RandomState(4), 10, nclass=6)
    got = tu.separable_images(np.random.RandomState(4), 10, nclass=6)
    for a, b in zip(want, got):
        assert a.tobytes() == b.tobytes()
