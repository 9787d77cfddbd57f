"""B8 ``qmm_requant``'s two designs on the card and what routes a call
between them, held on the CPU: the choice of design
(``ops.pallas_kernels.qmm_design``), the forced design of
``_qmm_requant``, the per-design launch counters, the build's hash of the
shared Hopper header, the ablation tool's edits, and the plain version
against the reference's Pallas kernel (interpret mode) at the wgmma
design's tile edges.

Tolerance against the reference: at most one code apart on at most a
1e-3 share of the outputs, as ``tests/test_torch_quantization.py`` holds
B8: the reference's interpret-mode run on the CPU contracts the
epilogue's multiply-add into an FMA, which can move a value across a
rounding tie; the port's plain version and both CUDA designs round twice
and agree bitwise (the ``cuda`` test below, and ``chip_smoke.py`` phase
10).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as jpk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import build
from mxnet_tpu_torch.ops import pallas_kernels as pk
from mxnet_tpu_torch.tools import qmm_ablate

TIE_SHARE = 1e-3
COUNTERS = ("qmm_requant", "qmm_requant/wgmma", "qmm_requant/mma")
PATH = [shape for stage in qmm_ablate.path_stages(256) for shape in stage]
# the wgmma design's own edges, (M, K, N, ldx), as chip_smoke.py's
# QMM_EDGES at a CPU size: M not a multiple of 128, N = 200 and 17, K = 48
# and 208 (a K tail inside a swizzle row), a row-strided x
EDGES = [(130, 256, 64, 256), (1, 64, 64, 64), (70, 128, 200, 128),
         (50, 256, 17, 256), (33, 48, 128, 48), (51, 208, 200, 208),
         (40, 256, 128, 272)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _counts():
    return {k: pk.launch_counts()[k] for k in COUNTERS}


def _inputs(m, k, n, ldx, seed):
    rng = np.random.RandomState(seed)
    xs = rng.randint(-127, 128, (m, ldx)).astype(np.int8)
    w = rng.randint(-127, 128, (n, k)).astype(np.int8)
    bias = (rng.randn(n) * 10).astype(np.float32)
    scale = 60.0 / (np.sqrt(k) * 127 * 127 / 3)
    return xs, w, bias, scale


# -- the choice of design -------------------------------------------------------
def test_path_has_sixteen_launches_in_four_stages():
    stages = qmm_ablate.path_stages(256)
    assert [len(s) for s in stages] == [3, 4, 6, 3]
    assert PATH[0] == (802816, 64, 64) and PATH[-1] == (12544, 2048, 512)


@pytest.mark.parametrize("m,k,n", PATH)
def test_design_wgmma_takes_every_path_shape(m, k, n):
    assert pk.qmm_design(k, k) == "wgmma"


@pytest.mark.parametrize("m,k,n,ldx", EDGES)
def test_design_wgmma_takes_its_edges(m, k, n, ldx):
    assert pk.qmm_design(k, ldx) == "wgmma"


@pytest.mark.parametrize("k,ldx,aligned", [
    (70, 70, True), (520, 520, True), (8, 8, True),   # QMM_RAGGED's K
    (256, 256, False), (64, 64, False),               # an unaligned pointer
    (256, 264, True), (64, 72, True),                 # ldx % 16 != 0
    (0, 0, True)])
def test_design_mma_takes_the_rest(k, ldx, aligned):
    assert pk.qmm_design(k, ldx, aligned) == "mma"


def test_design_rule_is_what_a_tma_map_describes():
    for k in range(1, 1100):
        for pad in (0, 8, 16):
            want = "wgmma" if k % 16 == 0 and pad != 8 else "mma"
            assert pk.qmm_design(k, k + pad) == want, (k, pad)


# -- forced designs, counters ------------------------------------------------------
def test_counters_exist_and_reset_to_zero():
    pk.reset_launch_counts()
    assert _counts() == dict.fromkeys(COUNTERS, 0)


@pytest.mark.parametrize("design", [None, "wgmma", "mma"])
def test_forced_design_on_the_cpu_is_the_plain_version(design):
    xs, w, bias, scale = _inputs(70, 128, 200, 144, 1)
    x = _t(xs)[:, :128]
    before = _counts()
    want = pk.qmm_requant_reference(x, _t(w), _t(bias), scale)
    got = pk._qmm_requant(x, _t(w), _t(bias), scale, design=design)
    assert torch.equal(got, want)
    assert _counts() == before        # plain on the CPU: no launch


def test_plain_version_reads_a_row_strided_view():
    xs, w, bias, scale = _inputs(40, 256, 128, 272, 2)
    view = _t(xs)[:, :256]
    assert view.stride(0) == 272
    assert torch.equal(pk.qmm_requant(view, _t(w), _t(bias), scale),
                       pk.qmm_requant(view.contiguous(), _t(w), _t(bias),
                                      scale))


# -- the plain version against the reference at the wgmma design's edges ------
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m,k,n,ldx", EDGES)
def test_plain_matches_pallas_reference_at_the_edges(m, k, n, ldx, relu):
    xs, w, bias, scale = _inputs(m, k, n, ldx, m + k + n)
    x = xs[:, :k]
    want = np.asarray(jpk.qmm_requant(jnp.asarray(x), jnp.asarray(w.T),
                                      jnp.asarray(bias), scale, relu=relu,
                                      interpret=True))
    got = pk.qmm_requant(_t(xs)[:, :k], _t(w), _t(bias), scale, relu=relu)
    assert got.dtype == torch.int8 and tuple(got.shape) == (m, n)
    diff = got.numpy().astype(np.int32) - want
    assert np.abs(diff).max(initial=0) <= 1
    assert (diff != 0).mean() <= TIE_SHARE, (diff != 0).sum()


# -- the build: the shared header is part of every library's hash -------------
def test_build_hash_follows_the_shared_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "sm90.cuh"\n')
    (csrc / "sm90.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "_CSRC", str(csrc))
    first = build._job("k")[1]
    assert build._job("k")[1] == first
    (csrc / "sm90.cuh").write_text("// two\n")
    assert build._job("k")[1] != first
    # an emitted source too, since ablation variants include the header
    emitted = build._job("e", '#include "sm90.cuh"\n')[1]
    (csrc / "sm90.cuh").write_text("// three\n")
    assert build._job("e", '#include "sm90.cuh"\n')[1] != emitted


def test_build_finds_the_header_from_the_build_directory(tmp_path,
                                                         monkeypatch):
    """nvcc gets ``-I csrc``, so a source written into the build directory
    (``load_source``: the ablation variants) finds ``sm90.cuh``."""
    seen = []

    class Proc:
        def __init__(self, cmd, **kw):
            seen.append(cmd)

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", Proc)
    build._start("qmm_ablate_full", qmm_ablate.variant_source("full"))
    cmd = seen[0]
    assert cmd[cmd.index("-I") + 1] == build._CSRC
    written = list(tmp_path.glob("qmm_ablate_full-*.cu"))
    assert len(written) == 1 and cmd[-1] == str(written[0])


def test_every_wgmma_kernel_includes_the_shared_header():
    for name in ("qmm_wgmma", "conv3x3_wgmma"):
        with open(build.source_path(name), encoding="utf-8") as f:
            src = f.read()
        assert '#include "sm90.cuh"' in src
        assert "mbar_init(uint32_t" not in src   # not a second copy
    assert "qmm_wgmma" in build.KERNEL_SOURCES


# -- the ablation tool ------------------------------------------------------------
@pytest.mark.parametrize("variant", sorted(qmm_ablate.CUTS))
def test_ablation_edits_apply_to_the_kernel_source(variant):
    """Each cut of ``tools/qmm_ablate.py`` finds its text in
    ``csrc/qmm_wgmma.cu`` exactly once."""
    with open(build.source_path("qmm_wgmma"), encoding="utf-8") as f:
        src = f.read()
    cut = qmm_ablate.variant_source(variant)
    assert (cut == src) == (variant == "full")
    assert "mxtt_qmm_wgmma" in cut


def test_ablation_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        qmm_ablate.main(["--batch", "1", "--iters", "1"])


# -- on the card ---------------------------------------------------------------
@pytest.mark.cuda
def test_both_designs_match_plain_on_cuda():
    """Each design against the plain version on the card, bitwise, relu on
    and off: the wgmma design at its edges and a path-sized shape, the
    mma.sync design at QMM_RAGGED's shapes and the same edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cases = [(e, ("wgmma", "mma")) for e in EDGES + [(4096, 256, 64, 256)]]
    cases += [((m, k, n, k), ("mma",)) for m, k, n in
              [(130, 70, 40), (600, 520, 300), (1, 8, 8)]]
    for (m, k, n, ldx), designs in cases:
        xs, w, bias, scale = _inputs(m, k, n, ldx, 3)
        x = _t(xs).cuda()[:, :k]
        w, bias = _t(w).cuda(), _t(bias).cuda()
        for relu in (True, False):
            want = pk.qmm_requant_reference(x, w, bias, scale, relu=relu)
            for design in designs:
                before = pk.launch_counts()["qmm_requant/" + design]
                got = pk._qmm_requant(x, w, bias, scale, relu, design=design)
                torch.cuda.synchronize()
                assert torch.equal(got, want), ((m, k, n, ldx), design)
                assert pk.launch_counts()["qmm_requant/" + design] \
                    == before + 1
