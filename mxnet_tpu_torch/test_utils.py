"""Testing utilities: the port of ``mxnet_tpu/test_utils.py`` (``:18-164``).

The numeric oracles are numpy and central finite differences, as the
reference's: :func:`assert_almost_equal`, :func:`check_numeric_gradient`
and :func:`check_consistency`, which runs one function on each device of
``ctx_list`` and compares the results.  The devices are torch's: the
card and the CPU take the place of the reference's TPU and CPU
(``require_distinct=True`` asks for both and fails if the legs land on
one device type).  :func:`rand_ndarray` draws from numpy's global RNG,
so ``mx.random.seed`` repeats it; ``stype="row_sparse"`` / ``"csr"``
casts that draw, whose uniform values are never zero, as the
reference's does (``density`` is ignored there too).  :func:`download`
copies local paths and ``file://`` URLs only, as
``gluon.utils.download`` does: the port fetches nothing over a
network.
"""
from __future__ import annotations

import os
import pathlib

import numpy as np
import torch

from . import autograd
from . import ndarray as nd
from .context import cpu, current_context, gpu, use
from .ndarray import NDArray

__all__ = ["default_context", "assert_almost_equal", "almost_equal",
           "rand_ndarray", "rand_shape_2d", "rand_shape_nd",
           "check_numeric_gradient", "check_consistency", "same",
           "list_gpus", "download", "separable_images"]


def default_context():
    """The device entry points default to (:func:`context.current_context`:
    the card unless the caller asks for the CPU)."""
    return current_context()


def _host(a):
    if isinstance(a, NDArray):
        return a.asnumpy()
    if isinstance(a, torch.Tensor):
        t = a.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(a)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20, names=("a", "b")):
    """numpy's ``assert_allclose`` of two arrays (NDArrays, tensors or
    numpy), ``b`` cast to ``a``'s dtype."""
    a, b = _host(a), _host(b)
    np.testing.assert_allclose(
        a, b.astype(a.dtype) if a.dtype != b.dtype else b, rtol=rtol,
        atol=atol, err_msg="%s vs %s mismatch" % names)


def almost_equal(a, b, rtol=1e-5, atol=1e-20):
    try:
        assert_almost_equal(a, b, rtol, atol)
        return True
    except AssertionError:
        return False


def rand_ndarray(shape, stype="default", density=None, dtype=None, ctx=None):
    """Uniform [-1, 1) draws of ``shape`` from numpy's global RNG, as an
    NDArray of storage type ``stype`` on ``ctx``."""
    arr = np.random.uniform(-1, 1, size=shape).astype(dtype or np.float32)
    out = nd.array(arr, ctx=ctx, dtype=arr.dtype)
    return out if stype == "default" else out.tostype(stype)


def rand_shape_2d(dim0=10, dim1=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1))


def rand_shape_nd(num_dim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=num_dim))


def _eval_sum(fn, np_inputs, ctx):
    nds = [nd.array(x.astype(np.float32), ctx=ctx) for x in np_inputs]
    out = fn(*nds)
    return float(out.sum().asscalar() if out.size > 1 else out.asscalar())


def check_numeric_gradient(fn, inputs, eps=1e-3, rtol=1e-2, atol=1e-4,
                           ctx=None):
    """autograd's gradients of ``fn(*inputs).sum()`` against central finite
    differences of the numpy ``inputs`` (float64 recommended), on ``ctx``
    (reference: test_utils.py:792)."""
    ctx = current_context() if ctx is None else ctx
    nds = [nd.array(x.astype(np.float32), ctx=ctx) for x in inputs]
    for a in nds:
        a.attach_grad()
    with autograd.record():
        out = fn(*nds)
        loss = out.sum() if out.size > 1 else out
    loss.backward()
    analytic = [a.grad.asnumpy() for a in nds]
    for i, x in enumerate(inputs):
        numeric = np.zeros_like(x, dtype=np.float64)
        flat = x.reshape(-1)
        num_flat = numeric.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            fp = _eval_sum(fn, inputs, ctx)
            flat[j] = orig - eps
            fm = _eval_sum(fn, inputs, ctx)
            flat[j] = orig
            num_flat[j] = (fp - fm) / (2 * eps)
        np.testing.assert_allclose(
            analytic[i], numeric.astype(analytic[i].dtype), rtol=rtol,
            atol=atol, err_msg="gradient mismatch for input %d" % i)


def _leaves(out):
    """A leg's result as a list of host arrays (``fn`` returns one
    NDArray or a list / tuple of them)."""
    if isinstance(out, (list, tuple)):
        return [_host(o) for o in out]
    return [_host(out)]


def check_consistency(fn, inputs, ctx_list=None, rtol=1e-4, atol=1e-5,
                      require_distinct=False, scale_atol=False):
    """Run ``fn`` on ``inputs`` (numpy arrays, made NDArrays on each
    device as ``nd.array`` makes them: float32 unless an input is an
    NDArray or a tensor) under each device of ``ctx_list`` and compare
    every leg's results with the first's (reference:
    test_utils.py:1207).

    ``ctx_list`` defaults to ``[cpu()]``, or ``[gpu(0), cpu()]`` under
    ``require_distinct``, which also fails if the legs ran on one device
    type.  ``fn`` may return one NDArray or several; each is compared.
    ``scale_atol=True`` multiplies ``atol`` by each output's largest
    magnitude in the first leg (a tolerance relative to the output's
    scale).  Returns each leg's list of host arrays."""
    if ctx_list is None:
        ctx_list = [gpu(0), cpu()] if require_distinct else [cpu()]
    devices = [torch.device(c) for c in ctx_list]
    results = []
    for dev in devices:
        with use(dev):
            nds = [nd.array(x, ctx=dev) for x in inputs]
            results.append(_leaves(fn(*nds)))
    if require_distinct and len({d.type for d in devices}) < 2:
        raise RuntimeError(
            "check_consistency is degenerate: all %d legs ran on %r; a "
            "cross-device claim needs two device types (ctx_list=%r)"
            % (len(devices), devices[0].type if devices else None,
               ctx_list))
    for res in results[1:]:
        for want, got in zip(results[0], res):
            tol = atol
            if scale_atol and want.size:
                tol = atol * float(np.abs(want.astype(np.float64)).max())
            np.testing.assert_allclose(got, want, rtol=rtol, atol=tol)
    return results


def same(a, b):
    return np.array_equal(_host(a), _host(b))


def list_gpus():
    """Indices of the CUDA devices this process sees (reference:
    test_utils.py list_gpus)."""
    return list(range(torch.cuda.device_count())) \
        if torch.cuda.is_available() else []


def download(url, fname=None, dirname=None, overwrite=False):
    """Copy a local path or a ``file://`` URL to ``fname`` (the URL's last
    part by default) in ``dirname``; returns the file's name.  Any other
    scheme raises: the port fetches nothing over a network
    (``gluon.utils.download``)."""
    from .gluon.utils import download as _copy
    if "://" not in url:
        url = pathlib.Path(os.path.abspath(url)).as_uri()
    fname = fname or url.split("/")[-1]
    if dirname is not None:
        os.makedirs(dirname, exist_ok=True)
        fname = os.path.join(dirname, fname)
    return _copy(url, path=fname, overwrite=overwrite)


def separable_images(rng, n, nclass=4, size=12, channels=3, noise=0.4,
                     base=1.2):
    """Class-separable synthetic images: class c lights quadrant
    ((c//2)%2, c%2) with brightness base + 0.2*(c//4) over gaussian
    noise.  NHWC float32; labels float32 (reference: test_utils.py
    separable_images)."""
    y = (np.arange(n) % nclass).astype(np.float32)
    x = rng.randn(n, size, size, channels).astype(np.float32) * noise
    q = size // 2
    for i in range(n):
        c = int(y[i])
        r0, c0 = (c // 2) % 2 * q, c % 2 * q
        x[i, r0:r0 + q, c0:c0 + q] += base + 0.2 * (c // 4)
    return x, y
