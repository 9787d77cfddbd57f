"""The output heads whose backward the reference writes by hand, held to
it through ``autograd``: ``SoftmaxOutput`` (``mxnet_tpu/ops/nn.py:548-587``,
every option its backward reads), the regression heads (``:598-635``),
``MakeLoss`` (``:642-658``) and ``SVMOutput`` (``:822-853``).

Each case records the op on the same seeded input in both packages,
calls ``backward()`` on its output (whose head gradient these backwards
ignore) and compares the input's gradient at 1e-6.  Before the repair the
port's ``SoftmaxOutput`` computed the forward only, and its gradient was
all zeros.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu_torch import autograd, context, nd

TOL = 1e-6


def _grad_of(pkg_nd, pkg_autograd, op, x, label, **params):
    data = pkg_nd.array(x)
    data.attach_grad()
    with pkg_autograd.record():
        out = getattr(pkg_nd, op)(data, pkg_nd.array(label), **params)
    out.backward()
    return out.asnumpy(), data.grad.asnumpy()


def both(op, x, label, **params):
    want = _grad_of(jmx.nd, jmx.autograd, op, x, label, **params)
    with context.use("cpu"):
        got = _grad_of(nd, autograd, op, x, label, **params)
    return want, got


def _held(want, got):
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


RS = np.random.RandomState(18)
X = RS.randn(4, 5).astype(np.float32)
LABEL = np.array([0, 3, 1, 4], np.float32)
LABEL_IGNORED = np.array([0, -1, 1, -1], np.float32)
X_MULTI = RS.randn(2, 5, 3).astype(np.float32)
LABEL_MULTI = np.array([[0, 4, 2], [1, -1, 3]], np.float32)

SOFTMAX_CASES = {
    "plain": (X, LABEL, {}),
    "grad_scale": (X, LABEL, {"grad_scale": 0.25}),
    "use_ignore": (X, LABEL_IGNORED, {"use_ignore": True,
                                      "ignore_label": -1}),
    "use_ignore_valid": (X, LABEL_IGNORED, {"use_ignore": True,
                                            "ignore_label": -1,
                                            "normalization": "valid",
                                            "grad_scale": 2.0}),
    "valid": (X, LABEL, {"normalization": "valid"}),
    "smooth_alpha": (X, LABEL, {"smooth_alpha": 0.1}),
    "multi_output": (X_MULTI, LABEL_MULTI, {"multi_output": True}),
    "multi_output_ignore_valid": (X_MULTI, LABEL_MULTI, {
        "multi_output": True, "use_ignore": True, "ignore_label": -1,
        "normalization": "valid"}),
}


@pytest.mark.parametrize("case", sorted(SOFTMAX_CASES))
def test_softmax_output_gradient_matches_reference(case):
    x, label, params = SOFTMAX_CASES[case]
    want, got = both("SoftmaxOutput", x, label, **params)
    _held(want, got)
    assert np.abs(got[1]).max() > 0.01


def test_softmax_output_gradient_is_softmax_minus_one_hot():
    _, (out, grad) = both("SoftmaxOutput", X, LABEL)
    expect = out - np.eye(5, dtype=np.float32)[LABEL.astype(int)]
    np.testing.assert_allclose(grad, expect, rtol=TOL, atol=TOL)


Y = RS.randn(4, 5).astype(np.float32)


@pytest.mark.parametrize("op,params", [
    ("LinearRegressionOutput", {}),
    ("LinearRegressionOutput", {"grad_scale": 3.0}),
    ("MAERegressionOutput", {"grad_scale": 0.5}),
    ("LogisticRegressionOutput", {}),
    ("LogisticRegressionOutput", {"grad_scale": 2.0})])
def test_regression_heads_match_reference(op, params):
    want, got = both(op, X, Y, **params)
    _held(want, got)


@pytest.mark.parametrize("params", [{}, {"use_linear": True},
                                    {"margin": 0.5,
                                     "regularization_coefficient": 2.0}])
def test_svm_output_matches_reference(params):
    want, got = both("SVMOutput", X, LABEL, **params)
    _held(want, got)


@pytest.mark.parametrize("params", [{}, {"grad_scale": 0.5},
                                    {"normalization": "batch",
                                     "grad_scale": 2.0}])
def test_make_loss_matches_reference(params):
    def grad_of(pkg_nd, pkg_autograd):
        data = pkg_nd.array(X)
        data.attach_grad()
        with pkg_autograd.record():
            out = pkg_nd.MakeLoss(data * 3.0, **params)
        out.backward()
        return out.asnumpy(), data.grad.asnumpy()

    want = grad_of(jmx.nd, jmx.autograd)
    with context.use("cpu"):
        got = grad_of(nd, autograd)
    _held(want, got)
