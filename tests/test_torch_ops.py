"""mxnet_tpu_torch.ops: the fused LayerNorm against the reference's Pallas
kernel, and the port's import hygiene.

- On the CPU the port's wrapper runs its plain version; it is held to
  ``mxnet_tpu.ops.fused_optimizer.fused_layer_norm``, which on the CPU
  runs the Pallas kernel in interpret mode.  Tolerance 1e-5 (f32): the
  two sum each row in another order, nothing else differs.
- On a CUDA device (``cuda`` marker; skipped without one) the CUDA kernel
  is held to the plain version on the same inputs.
- The port imports neither ``jax`` nor anything of ``mxnet_tpu``.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import fused_optimizer as jax_fused
from mxnet_tpu_torch.base import MXNetError, resolve_device
from mxnet_tpu_torch.ops import fused_optimizer as F

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

LN_TOL = 1e-5

# (leading shape, d): the slice's widths, the small test width, and
# ragged rows / a width that is no multiple of 32
LN_SHAPES = [((4, 16), 32), ((3, 7), 32), ((1, 1024), 128), ((8, 1), 128),
             ((37,), 96), ((2, 5, 3), 160)]


def _ln_inputs(lead, d, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*lead, d) * 3 + 1).astype(np.float32)
    s = rng.randn(d).astype(np.float32)
    b = rng.randn(d).astype(np.float32)
    return x, s, b


@pytest.mark.parametrize("lead,d", LN_SHAPES)
def test_layer_norm_matches_pallas_reference(lead, d):
    x, s, b = _ln_inputs(lead, d, seed=d + len(lead))
    want = np.asarray(jax_fused.fused_layer_norm(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    before = F.launch_counts()["fused_layer_norm"]
    got = F.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                             torch.from_numpy(b)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=LN_TOL, atol=LN_TOL)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert F.launch_counts()["fused_layer_norm"] == before


def test_transformer_layer_norm_routes_through_the_fused_wrapper():
    from mxnet_tpu_torch.transformer import layers as L
    x, s, b = _ln_inputs((6,), 32, seed=3)
    args = [torch.from_numpy(a) for a in (x, s, b)]
    assert torch.equal(L.layer_norm(*args), F.fused_layer_norm(*args))


def test_device_rule_cpu_only_when_asked(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(MXNetError, match="no CUDA device"):
            resolve_device(dev)


@pytest.mark.cuda
def test_fused_ln_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for lead, d in LN_SHAPES:
        x, s, b = (torch.from_numpy(a).cuda()
                   for a in _ln_inputs(lead, d, seed=d))
        before = F.launch_counts()["fused_layer_norm"]
        got = F.fused_layer_norm(x, s, b)
        torch.cuda.synchronize()
        assert F.launch_counts()["fused_layer_norm"] == before + 1
        want = F.layer_norm_reference(x, s, b)
        torch.testing.assert_close(got, want, rtol=LN_TOL, atol=LN_TOL)


# -- import hygiene ------------------------------------------------------------
def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "mxnet_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "mxnet_tpu")


def test_port_sources_import_no_jax_and_no_reference():
    bad = []
    files = _port_files()
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += ["%s: %s" % (os.path.relpath(path, REPO), n)
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib, mxnet_tpu_torch\n"
        "for m in pkgutil.walk_packages(mxnet_tpu_torch.__path__, "
        "'mxnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mxnet_tpu'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
