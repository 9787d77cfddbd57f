"""mxnet_tpu_torch.serving: the port's serving contracts on the CPU.

Ports of the host-side contracts of tests/test_serving_decode.py —
PagePool determinism, a byte-identical continuous-batching schedule that
is token-exact against the sequential reference, and page reclamation
under a chaos step fault — plus the fleet's admission cap and breaker,
and ``POST /decode`` (and the other routes) through the port's HTTP
``Server``.  The port's served tokens are also held against the JAX
package's sequential reference on the same parameters.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from mxnet_tpu.serving.decode import DecodeRunner as JaxRunner
from mxnet_tpu.transformer import TransformerLMConfig as JaxConfig
from mxnet_tpu.transformer.decode import DecodeProgram as JaxProgram
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import chaos
from mxnet_tpu_torch.resilience.chaos import ChaosError
from mxnet_tpu_torch.serving import (CircuitBreaker, DecodeBatcher,
                                     DecodeRunner, ModelFleet, NoPagesFree,
                                     PagePool, RequestShed, Server)
from mxnet_tpu_torch.transformer import (DecodeProgram, TransformerLMConfig,
                                         from_jax_params)

CFG = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=2, d_ff=32,
           seq_len=32)


def _runner(slots=2, warmup=True):
    prog = DecodeProgram(TransformerLMConfig(**CFG), page_size=8)
    return DecodeRunner(prog, prog.program.init_params(0), slots=slots,
                        prefill_buckets=(8, 16, 32), warmup=warmup,
                        device="cpu")


@pytest.fixture(scope="module")
def runner():
    return _runner()


def _fresh_pool(runner):
    runner.pool = PagePool(1 + runner.slots * runner.pages_per_seq,
                           runner.page_size, runner.pool.bytes_per_page)


# -- PagePool ---------------------------------------------------------------
def test_page_pool_ascending_alloc_and_scratch_reserved():
    pool = PagePool(9, 8, 1024)
    assert pool.available == 8
    a = pool.alloc(3)
    b = pool.alloc(2)
    assert a == [1, 2, 3] and b == [4, 5]
    assert pool.pages_in_use == 5
    d = pool.describe()
    assert d["n_pages"] == 9 and d["available"] == 3
    assert d["pages_in_use"] == 5 and d["bytes_per_page"] == 1024


def test_page_pool_lifo_recycle_double_free_and_exhaustion():
    pool = PagePool(9, 8, 1024)
    a = pool.alloc(3)
    pool.free(a)
    assert pool.alloc(3) == a
    assert pool.pages_for(8) == 1 and pool.pages_for(9) == 2
    pool.free(a)
    with pytest.raises(MXNetError):
        pool.free(a)                     # already on the free list
    with pytest.raises(MXNetError):
        pool.free([0])                   # the scratch page, never leased
    pool.alloc(8)
    with pytest.raises(NoPagesFree):
        pool.alloc(1)
    assert pool.available == 0 and pool.pages_in_use == 8


# -- continuous-batching determinism ----------------------------------------
# (prompt_len, max_new, tier, deadline_ms): the two bronze requests with a
# 1ms deadline always shed at admission under the pinned 5ms/token hint
_BURST = [(5, 6, "gold", None), (11, 6, "silver", None),
          (3, 6, "bronze", 1), (8, 6, "gold", 60000),
          (16, 6, "bronze", 1), (24, 6, "silver", None),
          (7, 6, "bronze", None)]


def _burst_prompts():
    rng = np.random.RandomState(7)
    return [rng.randint(1, CFG["vocab_size"], size=n).astype(np.int32)
            for n, _, _, _ in _BURST]


def _run_burst(runner, prompts):
    _fresh_pool(runner)
    batcher = DecodeBatcher(runner, max_queue=32,
                            token_time_hint_ms=5.0, paused=True)
    futs, shed = {}, []
    for i, ((_, max_new, tier, deadline), prompt) in enumerate(
            zip(_BURST, prompts)):
        try:
            futs[i] = batcher.submit(prompt, max_new_tokens=max_new,
                                     tier=tier, deadline_ms=deadline)
        except RequestShed as e:
            assert e.shed_at == "admit"
            shed.append(i)
    batcher.release()
    outs = {i: np.asarray(f.result(60.0), np.int32)
            for i, f in futs.items()}
    batcher.drain(timeout=60.0)
    return outs, tuple(shed), batcher.schedule_events(), batcher.stats


def test_continuous_batching_schedule_is_byte_identical(runner):
    prompts = _burst_prompts()
    refs = {i: runner.reference_decode(p, _BURST[i][1])
            for i, p in enumerate(prompts)}
    out1, shed1, ev1, st1 = _run_burst(runner, prompts)
    out2, shed2, ev2, st2 = _run_burst(runner, prompts)
    assert ev1 == ev2, "schedule diverged across identical reruns"
    assert shed1 == shed2 == (2, 4)
    assert set(out1) == set(out2) == {0, 1, 3, 5, 6}
    for i in out1:
        assert np.array_equal(out1[i], out2[i])
        assert np.array_equal(out1[i], refs[i]), \
            "request %d diverged from the sequential reference" % i
    assert {e for e, _, _ in ev1} == {"join", "leave", "shed-admit"}
    assert sum(1 for e, _, _ in ev1 if e == "join") == 5
    for st in (st1, st2):
        assert st._shed_by_tier == {"bronze": 2}
        assert st.sequences_done_total == 5
    assert runner.pool.pages_in_use == 0
    assert runner.recompiles_since_warmup() == 0


def test_chaos_step_fault_reclaims_every_page(runner):
    prompts = _burst_prompts()[:4]
    refs = [runner.reference_decode(p, 6) for p in prompts]
    _fresh_pool(runner)
    batcher = DecodeBatcher(runner, max_queue=32,
                            token_time_hint_ms=5.0, paused=True)
    chaos.install([chaos.Fault("serving.batch", 2, "raise")])
    try:
        futs = [batcher.submit(p, max_new_tokens=6) for p in prompts]
        batcher.release()
        failed, served = [], []
        for i, f in enumerate(futs):
            try:
                out = np.asarray(f.result(60.0), np.int32)
            except ChaosError:
                failed.append(i)
            else:
                served.append(i)
                assert np.array_equal(out, refs[i])
        assert failed == [0, 1] and served == [2, 3]
        assert len(chaos.triggered()) == 1
        out = np.asarray(batcher.decode(prompts[0], max_new_tokens=6,
                                        timeout=60.0), np.int32)
        assert np.array_equal(out, refs[0])
    finally:
        chaos.uninstall()
    batcher.drain(timeout=60.0)
    assert runner.pool.pages_in_use == 0, \
        "%d KV pages leaked across the fault" % runner.pool.pages_in_use


# -- fleet ------------------------------------------------------------------
def test_fleet_decode_admission_cap():
    r = _runner(warmup=False)
    adm = r.admission_hbm_bytes()
    assert adm > r.pool.n_pages * r.pool.bytes_per_page
    tight = ModelFleet(hbm_cap_bytes=adm - 1)
    with pytest.raises(MXNetError, match="over cap"):
        tight.register_decode("lm", r)
    fleet = ModelFleet(hbm_cap_bytes=adm + 1)
    entry = fleet.register_decode("lm", r)
    assert entry.hbm_bytes == adm == fleet.modeled_hbm_total()
    with pytest.raises(MXNetError, match="already registered"):
        fleet.register_decode("lm", r)
    entry.batcher.force_drain()


def test_circuit_breaker_trips_and_recovers():
    from mxnet_tpu_torch.resilience.backoff import BackoffPolicy
    br = CircuitBreaker(failure_threshold=2, policy=BackoffPolicy(
        base_s=0.01, factor=1.0, max_delay_s=0.01, jitter=0.0))
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open" and not br.allow()
    threading.Event().wait(0.03)
    assert br.state == "half_open" and br.allow()
    br.record_success()
    assert br.state == "closed"


# -- HTTP -------------------------------------------------------------------
def _post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class _EchoRunner:
    """A fixed-shape runner stand-in: doubles each example."""
    example_shape = (3,)
    buckets = (1, 4)
    max_batch = 4
    warmed_up = True

    def bucket_for(self, n):
        return 1 if n <= 1 else 4

    def forward_batch(self, x):
        return 2.0 * x

    def recompiles_since_warmup(self):
        return 0

    def modeled_peak_hbm(self):
        return 1 << 20


def test_http_decode_round_trip_matches_reference_package():
    """Concurrent POST /decode against the port's Server; every answer is
    the port's sequential reference and the JAX package's."""
    jprog = JaxProgram(JaxConfig(**CFG), page_size=8)
    params = jprog.program.init_params(0)
    jr = JaxRunner(jprog, params, slots=2, prefill_buckets=(8, 16, 32),
                   warmup=False)
    prog = DecodeProgram(TransformerLMConfig(**CFG), page_size=8)
    r = DecodeRunner(prog, from_jax_params(params, "cpu"), slots=2,
                     prefill_buckets=(8, 16, 32), device="cpu")
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, CFG["vocab_size"], size=n).tolist()
               for n in (2, 9, 17, 4)]
    refs = [r.reference_decode(p, 5).tolist() for p in prompts]
    assert refs == [jr.reference_decode(p, 5).tolist() for p in prompts]

    fleet = ModelFleet()
    fleet.register_decode("lm", r, max_queue=16)
    fleet.register("echo", _EchoRunner())
    srv = Server(fleet, port=0)
    host, port = srv.start()
    base = "http://%s:%d" % (host, port)
    try:
        results = [None] * len(prompts)

        def fire(i):
            results[i] = _post(base + "/decode", {
                "prompt": prompts[i], "model": "lm", "max_new_tokens": 5,
                "tier": ("gold", "silver", "bronze")[i % 3]})

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for (code, body), ref in zip(results, refs):
            assert code == 200, body
            assert body == {"tokens": ref, "model": "lm"}

        code, body = _post(base + "/predict", {"data": [1, 2, 3],
                                               "model": "echo"})
        assert code == 200 and body["outputs"] == [2.0, 4.0, 6.0]
        assert _post(base + "/decode", {"prompt": [1, 2],
                                        "model": "echo"})[0] == 400
        assert _post(base + "/decode", {"prompt": []})[0] == 400
        assert _post(base + "/decode", {"prompt": [1],
                                        "model": "nope"})[0] == 404
        for path in ("/healthz", "/livez", "/readyz"):
            assert _get(base + path)[0] == 200, path
        code, raw = _get(base + "/stats")
        stats = json.loads(raw)
        assert code == 200 and stats["recompiles"] == 0
        assert stats["models"]["lm"]["decode"]["sequences_done_total"] == 4
        code, raw = _get(base + "/metrics")
        assert code == 200
        line = 'mxtpu_decode_tokens_total{model="lm"} %d' \
            % stats["models"]["lm"]["decode"]["tokens_total"]
        assert line.encode() in raw
    finally:
        assert srv.drain(timeout=30)
    assert r.pool.pages_in_use == 0
