"""The reference's operator sweep through both registries (forward).

Every case of ``tests/test_op_sweep.py``'s ``ALL_CASES`` (the reference's
declarative sweep, its deep cases merged) whose op the port registers
runs the same seeded numpy inputs through ``mxnet_tpu``'s op and
``mxnet_tpu_torch``'s, on the CPU.  Limits: float outputs within 1e-6 of
the reference's, relative to the larger of 1 and the output's largest
magnitude; integer outputs and index outputs exact, dtypes equal.  A
random op is held by its law (``tests/test_torch_random.py``): here its
outputs' shapes and dtypes only.  The even-numbered cases run here, the
odd ones in ``tests/test_torch_op_sweep_b.py`` (so ``--dist loadfile``
spreads them over two workers); the gradients are
``tests/test_torch_op_sweep_grad.py`` and ``..._grad_b.py``.

The registry test holds the reference's op names minus the port's to
exactly the names ROADMAP.md leaves to items A10 and A8.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg
from test_op_sweep import ALL_CASES

treg.load_all()
SEED = 0
FWD_TOL = 1e-6

# ops whose float32 outputs are indices: held exactly
INDEX_OPS = {"argmax", "argmin", "argmax_channel", "argsort", "topk",
             "_ravel_multi_index", "_unravel_index", "ravel_multi_index",
             "unravel_index"}
RANDOM_PREFIXES = ("_random_", "_sample_", "_shuffle")
# JAX runs here without x64: where the reference's 64-bit request lands
# on 32 bits, the port's 64-bit result is held at 32
_X64 = {np.dtype(np.float32): np.dtype(np.float64),
        np.dtype(np.int32): np.dtype(np.int64)}

PORTED = [(n, i, c) for n, i, c in ALL_CASES if n in set(treg.list_ops())]
HERE = PORTED[::2]

# the reference's ops the port leaves to later items (ROADMAP.md A10 / A8)
A10_CONTRIB = {
    "AdaptiveAvgPooling2D", "BilinearResize2D",
    "DeformableConvolution", "DeformablePSROIPooling",
    "IdentityAttachKLSparseReg", "PSROIPooling",
    "_contrib_AdaptiveAvgPooling2D", "_contrib_BilinearResize2D",
    "_contrib_DeformableConvolution", "_contrib_DeformablePSROIPooling",
    "_contrib_PSROIPooling", "_contrib_count_sketch",
    "_contrib_div_sqrt_dim", "_contrib_fft", "_contrib_ifft",
    "_contrib_quadratic", "count_sketch", "fft", "ifft", "khatri_rao",
    "quadratic"}
A10_LINALG = {p + n for p in ("_linalg_", "linalg_") for n in (
    "det", "extractdiag", "extracttrian", "gelqf", "gemm", "gemm2",
    "inverse", "makediag", "potrf", "potri", "slogdet", "sumlogdiag",
    "syevd", "syrk", "trmm", "trsm")}
A10_CONTROL_FLOW = {"_histogram", "_square_sum", "histogram", "square_sum"}
A10_IMAGE = {"_image_normalize", "_image_to_tensor"}
A8_FLASH = {"flash_attention", "_contrib_flash_attention"}
LEFT = (A10_CONTRIB | A10_LINALG | A10_CONTROL_FLOW | A10_IMAGE
        | A8_FLASH)
# ported by A10(c), sparse: held in tests/test_torch_sparse.py
SPARSE = {"_sparse_retain", "cast_storage", "sparse_retain",
          "_sparse_adagrad_update", "sparse_adagrad_update",
          "_contrib_SparseEmbedding", "SparseEmbedding", "_contrib_getnnz"}


def test_registry_leaves_exactly_the_a10_and_a8_names():
    assert len(LEFT) == 61
    assert set(jreg.list_ops()) - set(treg.list_ops()) == LEFT
    assert set(treg.list_ops()) <= set(jreg.list_ops())
    assert SPARSE <= set(treg.list_ops())
    for name in sorted(LEFT):
        with pytest.raises(KeyError, match="items 10"):
            treg.get(name)


def test_sparse_adagrad_update_names_item_10():
    """``_sparse_adagrad_update`` / ``sparse_adagrad_update`` (item 10(c)):
    the port's op against the reference's, wd, rescale and clip on."""
    rng = np.random.RandomState(SEED)
    w, g = rng.randn(4, 3).astype(np.float32), rng.randn(4, 3)
    h = rng.rand(4, 3).astype(np.float32)
    kw = dict(lr=0.05, epsilon=1e-7, wd=0.01, rescale_grad=0.5,
              clip_gradient=0.4)
    for name in ("_sparse_adagrad_update", "sparse_adagrad_update"):
        want = jreg.get(name).fn(jnp.asarray(w), jnp.asarray(g, jnp.float32),
                                 jnp.asarray(h), **kw)
        got = treg.get(name).fn(torch.from_numpy(w),
                                torch.from_numpy(g.astype(np.float32)),
                                torch.from_numpy(h), **kw)
        assert treg.get(name).mutates == {2: 1}
        for wa, ga in zip(want, got):
            held(name, np.asarray(wa), ga.numpy())


def run_both(name, case):
    """(reference outputs, port outputs) as lists of numpy arrays."""
    jop, top = jreg.get(name), treg.get(name)
    params = dict(case.params)
    np_in = case.inputs(np.random.RandomState(SEED))
    jparams, tparams = dict(params), dict(params)
    if jop.needs_train:
        jparams["_train"] = True
    if top.needs_train:
        tparams["_train"] = True
    if not np_in and "ctx" in top.fn_params:
        tparams["ctx"] = "cpu"
    jout = jop.fn(*[jnp.asarray(x) for x in np_in], **jparams)
    tout = top.fn(*[torch.from_numpy(np.array(x)) for x in np_in],
                  **tparams)
    jout = list(jout) if isinstance(jout, (tuple, list)) else [jout]
    tout = list(tout) if isinstance(tout, (tuple, list)) else [tout]
    n = jop.n_outputs(params)
    return ([np.asarray(o) for o in jout[:n]],
            [o.detach().numpy() for o in tout[:n]])


def check_case(name, case):
    want, got = run_both(name, case)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        held(name, w, g)


def held(name, want, got):
    """Port output ``got`` against the reference's ``want``."""
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert got.dtype == want.dtype or _X64.get(want.dtype) == got.dtype, \
        (name, got.dtype, want.dtype)
    got = got.astype(want.dtype)
    if name.startswith(RANDOM_PREFIXES):
        return
    if name in INDEX_OPS or not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    scale = max(1.0, float(np.nanmax(np.abs(want.astype(np.float64)),
                                     initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=FWD_TOL,
                               atol=FWD_TOL * scale, err_msg=name)


@pytest.mark.parametrize("name,i,case", HERE,
                         ids=["%s-%d" % (n, i) for n, i, _ in HERE])
def test_forward_matches_reference(name, i, case):
    check_case(name, case)
