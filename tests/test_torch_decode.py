"""mxnet_tpu_torch.transformer: the decode slice held against mxnet_tpu.

Both packages get the same seeded parameters (``init_params``, bitwise
equal by contract) and the same token inputs.  The JAX side runs its
Pallas LayerNorm in interpret mode (``MXTPU_FUSED_LAYERNORM=1``), as
``tests/test_fusion.py`` does; the port runs on the CPU, where its
kernel wrapper takes the plain version.

Tolerances (float32): logits 1e-4 absolute — the two frameworks sum
matmuls and softmaxes in different orders over up to ``seq_len`` keys
and ``d_ff`` features, nothing else differs.  Greedy tokens are held
equal wherever the reference's top-2 logit gap exceeds 1e-3; each decode
step is teacher-forced with the reference's token so a near-tie cannot
cascade.  Inside the port, the cached decode equals the no-cache
reference exactly (the reference's own contract, tests/test_decode.py).
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.serving.decode import DecodeRunner as JaxRunner
from mxnet_tpu.transformer import TransformerLMConfig as JaxConfig
from mxnet_tpu.transformer.decode import DecodeProgram as JaxProgram
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel.mesh import MeshPlan
from mxnet_tpu_torch.serving.decode import DecodeRunner, PagePool
from mxnet_tpu_torch.transformer import (DecodeProgram, TransformerLMConfig,
                                         from_jax_params)

LOGIT_TOL = 1e-4
TIE_GAP = 1e-3

# the small parity config and its bucket ladder
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           seq_len=64)
BUCKETS = (8, 16, 32)


@pytest.fixture(scope="module")
def pair():
    """(JAX runner with the Pallas LN, port runner on the CPU) over the
    same parameters, both with 2 slots and the same page pool size."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXTPU_FUSED_LAYERNORM", "1")
        jprog = JaxProgram(JaxConfig(**CFG), page_size=8)
        params = jprog.program.init_params(0)
        jr = JaxRunner(jprog, params, slots=2, prefill_buckets=BUCKETS,
                       warmup=False)
        prog = DecodeProgram(TransformerLMConfig(**CFG), page_size=8)
        tr = DecodeRunner(prog, from_jax_params(params, "cpu"), slots=2,
                          prefill_buckets=BUCKETS, warmup=False,
                          device="cpu")
        yield jr, tr


@pytest.mark.parametrize("cfg", [
    CFG, dict(vocab_size=256, d_model=128, n_heads=8, n_layers=4,
              d_ff=512, seq_len=1024)])
def test_init_params_bitwise_equal_to_reference(cfg):
    want = JaxProgram(JaxConfig(**cfg)).program.init_params(0)
    prog = DecodeProgram(TransformerLMConfig(**cfg))
    got = prog.program.init_params(0)
    assert list(got) == list(want) == prog.program.param_names
    for name in want:
        assert got[name].dtype == np.float32
        assert np.array_equal(got[name], want[name]), name
    tensors = from_jax_params(want, "cpu")
    assert all(torch.equal(tensors[n], torch.from_numpy(want[n]))
               for n in want)


def _top2_gap(row):
    top = np.sort(row)[-2:]
    return float(top[1] - top[0])


def test_prefill_and_teacher_forced_decode_match_reference(pair):
    """Two sequences (prompts of 5 and 13 tokens, buckets 8 and 16)
    prefilled into their pages, then 8 decode steps with both slots
    active, every step fed the reference's greedy tokens."""
    jr, tr = pair
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, CFG["vocab_size"], size=n).astype(np.int32)
               for n in (5, 13)]
    steps = 8
    pt = np.zeros((2, jr.pages_per_seq), np.int32)
    lengths = np.zeros(2, np.int32)
    toks = np.zeros(2, np.int32)
    leases = []
    for slot, prompt in enumerate(prompts):
        need = jr.pool.pages_for(prompt.size + steps + 1)
        pages = jr.pool.alloc(need)
        assert tr.pool.alloc(need) == pages        # same deterministic pool
        leases.append(pages)
        jl = jr.prefill(prompt, pages)
        tl = tr.prefill(prompt, pages)
        assert tl.shape == jl.shape == (CFG["vocab_size"],)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_TOL)
        if _top2_gap(jl) > TIE_GAP:
            assert int(tl.argmax()) == int(jl.argmax())
        pt[slot, :len(pages)] = pages
        lengths[slot] = prompt.size
        toks[slot] = int(jl.argmax())
    checked = 0
    for _ in range(steps):
        jl = jr.decode_step(pt, lengths, toks)
        tl = tr.decode_step(pt, lengths, toks)
        assert tl.shape == jl.shape == (2, CFG["vocab_size"])
        assert np.isfinite(tl).all()
        np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_TOL)
        for slot in range(2):
            if _top2_gap(jl[slot]) > TIE_GAP:
                assert int(tl[slot].argmax()) == int(jl[slot].argmax())
                checked += 1
        toks = jl.argmax(axis=1).astype(np.int32)   # teacher forcing
        lengths += 1
    assert checked >= steps    # the tie rule did not excuse most tokens
    for pages in leases:
        jr.pool.free(pages)
        tr.pool.free(pages)


def test_reference_decode_matches_reference_package(pair):
    """The no-cache oracle of both packages, greedy, 6 tokens, across
    the bucket ladder (prompt lengths 3..20)."""
    jr, tr = pair
    rng = np.random.RandomState(5)
    for n in (3, 9, 20):
        prompt = rng.randint(1, CFG["vocab_size"], size=n).astype(np.int32)
        seq = list(prompt)
        for _ in range(6):
            jl = jr.prefill(np.asarray(seq, np.int32), np.zeros(0, np.int32))
            tl = tr.prefill(np.asarray(seq, np.int32), np.zeros(0, np.int32))
            np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_TOL)
            seq.append(int(jl.argmax()))


# -- port-internal contracts (ports of tests/test_decode.py) -----------------
SMALL = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=2, d_ff=32,
             seq_len=32)


def _runner(slots=2, buckets=(8, 16, 32), warmup=True, page_size=8):
    prog = DecodeProgram(TransformerLMConfig(**SMALL), page_size=page_size)
    return DecodeRunner(prog, prog.program.init_params(0), slots=slots,
                        prefill_buckets=buckets, warmup=warmup,
                        device="cpu")


@pytest.fixture(scope="module")
def runner():
    return _runner()


def test_cached_generate_matches_reference_exact(runner):
    rng = np.random.RandomState(0)
    for n in (1, 3, 7, 8, 9, 15, 20):
        prompt = rng.randint(1, SMALL["vocab_size"], size=n).astype(np.int32)
        cached = runner.generate(prompt, 6)
        ref = runner.reference_decode(prompt, 6)
        assert np.array_equal(cached, ref), \
            "paged decode diverged at prompt len %d: %r vs %r" \
            % (n, cached, ref)
    assert runner.pool.pages_in_use == 0


def test_eos_stops_generation(runner):
    prompt = np.arange(1, 6, dtype=np.int32)
    free_run = runner.reference_decode(prompt, 8)
    eos = int(free_run[-1])
    stop = int(np.argmax(free_run == eos)) + 1
    cached = runner.generate(prompt, 8, eos_token=eos)
    ref = runner.reference_decode(prompt, 8, eos_token=eos)
    assert np.array_equal(cached, ref)
    assert cached[-1] == eos and len(cached) == stop
    assert np.array_equal(cached, free_run[:stop])


def test_dispatch_signatures_are_the_recompile_contract(runner):
    """Warmup covers every bucket and the slot batch; a decode batch of
    another width is a new signature and shows as a recompile."""
    assert runner.warmed_up
    assert runner.jit_cache_keys() == {
        ("prefill", (1, 8)), ("prefill", (1, 16)), ("prefill", (1, 32)),
        ("decode", (2,))}
    r = _runner()
    r.generate(np.array([3, 4, 5], np.int32), 4)
    assert r.recompiles_since_warmup() == 0
    r.decode_step(np.zeros((3, r.pages_per_seq), np.int32),
                  np.zeros(3, np.int32), np.zeros(3, np.int32))
    assert r.recompiles_since_warmup() == 1


def test_decode_program_rejects_bad_geometry():
    cfg = TransformerLMConfig(**SMALL)
    with pytest.raises(ValueError):   # batch is the host's concern
        DecodeProgram(cfg, plan=MeshPlan(data=2))
    with pytest.raises(ValueError):   # page_size must divide seq_len
        DecodeProgram(cfg, page_size=5)
    with pytest.raises(MXNetError):   # buckets must be page multiples
        _runner(buckets=(6,), warmup=False)
    with pytest.raises(MXNetError):   # page 0 is scratch: >= 2 pages
        PagePool(1, 8, 1024)
    with pytest.raises(ValueError, match="n_heads"):
        DecodeProgram(cfg, plan=MeshPlan(data=1, model=4))  # 2 heads
    with pytest.raises(NotImplementedError, match="int8"):
        DecodeProgram(cfg, kv_dtype="int8")


def test_geometry_matches_reference():
    jprog = JaxProgram(JaxConfig(**CFG), page_size=8)
    prog = DecodeProgram(TransformerLMConfig(**CFG), page_size=8)
    assert prog.bytes_per_page() == jprog.bytes_per_page()
    assert prog.cache_shape(9) == jprog.cache_shape(9)
    assert prog.pages_per_seq == jprog.pages_per_seq
    assert prog.describe() == dict(jprog.describe(),
                                   plan=prog.plan.describe())
