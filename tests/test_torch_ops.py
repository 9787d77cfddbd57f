"""mxnet_tpu_torch.ops: the fused LayerNorm and the fused optimizer updates
(SGD, SGD+momentum, Adam) against the reference's Pallas kernels, the
Xavier draw, the optimizer registry, and the port's import hygiene.

- On the CPU the port's wrapper runs its plain version; it is held to
  ``mxnet_tpu.ops.fused_optimizer.fused_layer_norm``, which on the CPU
  runs the Pallas kernel in interpret mode.  Tolerance 1e-5 (f32): the
  two sum each row in another order, nothing else differs.  The
  optimizer updates are held the same way at 1e-6 (see OPT_TOL).
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


def test_context_maps_to_torch_devices(monkeypatch):
    from mxnet_tpu_torch import context
    assert context.cpu() == context.cpu(3) == torch.device("cpu")
    with context.use(context.cpu()):
        assert context.current_context() == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (context.gpu, context.current_context):
        with pytest.raises(MXNetError, match="no CUDA device"):
            call()
    assert context.num_gpus() == 0


@pytest.mark.parametrize("kind,args", [
    ("FactorScheduler", (3, 0.5)), ("MultiFactorScheduler", ([2, 5], 0.1)),
    ("PolyScheduler", (8,)), ("CosineScheduler", (8, 0.1, 0.01, 2))])
def test_lr_schedulers_match_reference(kind, args):
    from mxnet_tpu import lr_scheduler as jsched
    from mxnet_tpu_torch import lr_scheduler as tsched
    js, ts = getattr(jsched, kind)(*args), getattr(tsched, kind)(*args)
    got = [ts(t) for t in range(12)]
    assert got == [js(t) for t in range(12)]
    assert len(set(got)) > 1


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


# -- fused optimizer updates (B1-B3) -------------------------------------------
# Tolerance 1e-6 absolute (f32): the port's plain version and the Pallas
# kernel in interpret mode compute one expression in one order; only the
# scalar constants' rounding path (python double vs traced f32) differs.
OPT_TOL = 1e-6
OPT_SIZES = [1, 129, 70001]
# (clip_gradient, wd, rescale_grad, inv_scale, ok)
OPT_CASES = [(None, 0.0, 1.0, 1.0, 1.0), (0.5, 1e-4, 1.0, 1.0, 1.0),
             (None, 1e-4, 0.25, 1.0, 1.0), (0.3, 0.0, 1.0, 1.0 / 1024, 1.0),
             (0.5, 1e-4, 0.5, 0.5, 0.0)]
OPT_KINDS = ["sgd", "sgd_momentum", "adam"]
# each kind's wrapper (its launch counter) and the operands it updates
WRAPPER = {"sgd": "fused_sgd", "sgd_momentum": "fused_sgd_momentum",
           "adam": "fused_adam"}
IN_PLACE = {"sgd": (0,), "sgd_momentum": (0, 2), "adam": (0, 2, 3)}


def _opt_inputs(p, seed, zero=False):
    rng = np.random.RandomState(seed)
    w, g, m = (rng.randn(p).astype(np.float32) for _ in range(3))
    v = np.abs(rng.randn(p)).astype(np.float32)
    if zero:
        w, g, m, v = (np.zeros(p, np.float32) for _ in range(4))
    return w, g, m, v


def _run_both(kind, arrays, lr, case):
    """(reference outputs, port outputs), each a tuple of numpy arrays."""
    clip, wd, rescale, inv, ok = case
    kw = dict(wd=wd, rescale_grad=rescale, clip_gradient=clip,
              inv_scale=inv, ok=ok)
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a.copy()) for a in arrays]
    if kind == "sgd":
        want = (jax_fused.fused_sgd(j[0], j[1], lr, interpret=True, **kw),)
        got = (F.fused_sgd(t[0], t[1], lr, **kw),)
    elif kind == "sgd_momentum":
        want = jax_fused.fused_sgd_momentum(j[0], j[1], j[2], lr,
                                            momentum=0.9, interpret=True,
                                            **kw)
        got = F.fused_sgd_momentum(t[0], t[1], t[2], lr, momentum=0.9,
                                   **kw)
    else:
        want = jax_fused.fused_adam(*j, lr, beta1=0.9, beta2=0.999,
                                    epsilon=1e-8, interpret=True, **kw)
        got = F.fused_adam(*t, lr, beta1=0.9, beta2=0.999, epsilon=1e-8,
                           **kw)
    # the port updates in place: it returns the w, m, v tensors it got
    assert all(a is t[i] for a, i in zip(got, IN_PLACE[kind]))
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


@pytest.mark.parametrize("case", OPT_CASES,
                         ids=["plain", "clip_wd", "rescale", "inv_scale",
                              "skip"])
@pytest.mark.parametrize("p", OPT_SIZES)
@pytest.mark.parametrize("kind", OPT_KINDS)
def test_fused_optimizer_matches_pallas_reference(kind, p, case):
    arrays = _opt_inputs(p, seed=p % 97 + len(kind))
    lr = 0.05 if kind != "adam" else 0.0031
    before = F.launch_counts()[WRAPPER[kind]]
    want, got = _run_both(kind, arrays, lr, case)
    for a, b in zip(got, want):
        assert a.shape == (p,) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=OPT_TOL)
    if case[-1] == 0.0:      # ok = 0: a bitwise no-op in both packages
        for a, b, i in zip(got, want, IN_PLACE[kind]):
            assert np.array_equal(a, arrays[i])
            assert np.array_equal(b, arrays[i])
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert F.launch_counts()[WRAPPER[kind]] == before


@pytest.mark.parametrize("kind", OPT_KINDS)
def test_fused_optimizer_zero_state_stays_zero(kind):
    arrays = _opt_inputs(257, seed=0, zero=True)
    _, got = _run_both(kind, arrays, 0.1, (0.5, 1e-4, 1.0, 1.0, 1.0))
    assert all(not a.any() for a in got)


def test_fused_optimizer_update_resolves_mults_and_adam_rate():
    """``fused_optimizer_update`` against the reference's, through each
    package's own SGD / Adam: lr_mult / wd_mult of a group index and the
    host-side bias-corrected Adam rate at t = 3."""
    import mxnet_tpu.optimizer as jopt
    from mxnet_tpu_torch import optimizer as topt
    w, g, m, v = _opt_inputs(1000, seed=7)
    for name, kw, t in (("sgd", {"momentum": 0.9, "wd": 1e-3}, 1),
                        ("adam", {"wd": 1e-3, "clip_gradient": 0.2}, 3)):
        jo, to = jopt.create(name, **kw), topt.create(name, **kw)
        for o in (jo, to):
            o.lr_mult[0], o.wd_mult[0] = 0.5, 2.0
        js = jnp.asarray(m) if name == "sgd" else (jnp.asarray(m),
                                                   jnp.asarray(v))
        ts = torch.from_numpy(m.copy()) if name == "sgd" else (
            torch.from_numpy(m.copy()), torch.from_numpy(v.copy()))
        jw, _ = jax_fused.fused_optimizer_update(
            jo, 0, jnp.asarray(w), jnp.asarray(g), js, jnp.float32(0.01),
            jnp.int32(t), interpret=True)
        tw, _ = F.fused_optimizer_update(to, 0, torch.from_numpy(w.copy()),
                                         torch.from_numpy(g), ts, 0.01, t)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                                   atol=OPT_TOL)


def test_xavier_draw_bitwise_equal_to_reference():
    import mxnet_tpu.initializer as jinit
    from mxnet_tpu import nd
    from mxnet_tpu_torch import initializer as tinit
    shape = (64, 32, 3, 3)
    np.random.seed(123)
    ref = nd.zeros(shape)
    jinit.Xavier()(jinit.InitDesc("conv0_weight"), ref)
    got = np.empty(shape, np.float32)
    tinit.Xavier()(tinit.InitDesc("conv0_weight"), got,
                   np.random.RandomState(123))
    assert np.array_equal(got, ref.asnumpy())
    # without rng= the draw comes from numpy's global RNG, as the
    # reference's does: the same seed gives the same bits
    np.random.seed(123)
    again = np.empty(shape, np.float32)
    tinit.Xavier()(tinit.InitDesc("conv0_weight"), again)
    assert np.array_equal(again, ref.asnumpy())


def test_optimizer_registry_names_the_roadmap_item():
    from mxnet_tpu_torch import optimizer as topt
    assert type(topt.create("SGD", momentum=0.9)).__name__ == "SGD"
    # every optimizer of the reference is ported: none names an item
    assert type(topt.create("nag", momentum=0.9)).__name__ == "NAG"
    # multi_precision is ported: a bf16 weight gets an f32 master
    mp = topt.create("sgd", multi_precision=True, momentum=0.9)
    master, mom = mp.create_state_multi_precision(
        0, torch.zeros(3, dtype=torch.bfloat16))
    assert master.dtype == torch.float32 and mom.dtype == torch.float32
    with pytest.raises(MXNetError, match="Cannot find"):
        topt.create("no_such_optimizer")


@pytest.mark.cuda
def test_fused_optimizer_kernels_match_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for kind in OPT_KINDS:
        for p in OPT_SIZES:
            for case in OPT_CASES:
                clip, wd, rescale, inv, ok = case
                arrays = [torch.from_numpy(a).cuda()
                          for a in _opt_inputs(p, seed=p)]
                s = torch.tensor([0.01, inv, ok], device="cuda")
                kw = dict(wd=wd, rescale_grad=rescale, clip_gradient=clip)
                ckw = dict(kw, inv_scale=inv, ok=ok)
                work = [a.clone() for a in arrays]
                before = F.launch_counts()[WRAPPER[kind]]
                if kind == "sgd":
                    want = (F.fused_sgd_reference(*arrays[:2], s, **kw),)
                    got = (F.fused_sgd(*work[:2], 0.01, **ckw),)
                elif kind == "sgd_momentum":
                    want = F.fused_sgd_momentum_reference(
                        *arrays[:3], s, momentum=0.9, **kw)
                    got = F.fused_sgd_momentum(*work[:3], 0.01,
                                               momentum=0.9, **ckw)
                else:
                    want = F.fused_adam_reference(
                        *arrays, s, beta1=0.9, beta2=0.999, epsilon=1e-8,
                        **kw)
                    got = F.fused_adam(*work, 0.01, beta1=0.9, beta2=0.999,
                                       epsilon=1e-8, **ckw)
                torch.cuda.synchronize()
                assert F.launch_counts()[WRAPPER[kind]] == before + 1
                for a, b in zip(got, want):
                    torch.testing.assert_close(a, b, rtol=OPT_TOL,
                                               atol=OPT_TOL)


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


def _precision_writes(tree):
    """Assignments to ``torch.backends.*.allow_tf32`` and calls of
    ``torch.set_float32_matmul_precision`` in one module's AST."""
    found = []
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Attribute) \
                        and sub.attr == "allow_tf32" \
                        and "backends" in ast.unparse(sub.value):
                    found.append("%d: %s" % (node.lineno, ast.unparse(sub)))
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "set_float32_matmul_precision":
            found.append("%d: %s" % (node.lineno, ast.unparse(node)))
    return found


def test_port_writes_no_process_wide_precision_flag():
    """No module of the port changes torch's float32 precision for the
    whole process (a runner that did so once slowed every training step
    after it in the same process)."""
    bad = []
    for path in _port_files():
        if not path.startswith(os.path.join(REPO, "mxnet_tpu_torch")):
            continue
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        bad += ["%s:%s" % (os.path.relpath(path, REPO), w)
                for w in _precision_writes(tree)]
    assert not bad, bad
    # the walk sees both spellings
    probe = ast.parse("import torch\n"
                      "torch.backends.cudnn.allow_tf32 = False\n"
                      "torch.set_float32_matmul_precision('high')\n")
    assert len(_precision_writes(probe)) == 2


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
