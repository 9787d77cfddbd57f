"""KV-cache autoregressive serving: paged allocation, prefill/decode
split, and continuous batching.

The port of ``mxnet_tpu/serving/decode.py``.  Three layers over
:class:`~mxnet_tpu_torch.transformer.decode.DecodeProgram`:

- :class:`PagePool` — the host-side page allocator for the device KV
  pools: fixed ``page_size``-token blocks, allocated ascending and
  recycled LIFO (deterministic), with page 0 reserved as the device
  scratch page (idle slots and overruns land there by construction).
  Admission control counts *pages*, not worst-case sequences.
- :class:`DecodeRunner` — a TransformerLM behind the two-phase ladder:
  prefill runs once per length bucket (page multiples, warmed at load),
  decode runs on the fixed slot batch.  PyTorch runs eagerly, so there is
  no compile cache behind the reference's recompile contract; the runner
  keys it on the ``(phase, input shape)`` signatures it dispatches, so a
  prompt outside the warmed bucket ladder still shows as a recompile.
- :class:`DecodeBatcher` — **continuous batching**: one worker owns a
  fixed set of decode slots; sequences join the running batch the step
  a slot and enough pages free up, leave the step they finish, and the
  SLO-tier/shed/deadline arithmetic runs on **tokens-remaining** —
  modeled completion = (slot wait + queue-ahead amortized over slots +
  the request's own token budget) × the EWMA-or-pinned per-token step
  time.  Shed decisions are deterministic under a pinned
  ``token_time_hint_ms`` and sequential submission
  (:meth:`DecodeBatcher.schedule_events` replays byte-identical).

Device calls: the runner's entry points run on its ``device`` (CUDA
unless the caller asks for ``"cpu"``), launching on the calling thread's
current stream; ``.cpu().numpy()`` of the logits is the sync point.

Locking: ``_cond`` guards the queue, the slot table, the page pool
bookkeeping and the schedule log; ``_runner_lock`` is held only around
the device call; they never nest.  The runner's own ``_lock`` guards the
cache pools.  All timing is ``time.monotonic()``.  Chaos probe: the
worker fires the registered ``serving.batch`` site once per decode step
— an injected raise fails every active sequence *and frees its pages*.
"""
from __future__ import annotations

import bisect
import math
import threading
import time
from collections import deque

import numpy as _np
import torch

from ..base import MXNetError, resolve_device
from .batcher import (DEFAULT_TIER, Draining, RequestShed, ServerBusy,
                      tier_name, tier_rank)
from .stats import _WINDOW, ServingStats, percentile

__all__ = ["PagePool", "NoPagesFree", "DecodeRunner", "DecodeBatcher",
           "DecodeStats"]


class NoPagesFree(MXNetError):
    """The page pool cannot cover a sequence's token budget right now —
    the decode tier's ServerBusy analogue (HTTP 429 at the /decode
    surface; queued requests simply wait for reclaimed pages)."""


class PagePool:
    """Host-side allocator over a device KV pool of ``n_pages`` blocks.

    Page 0 is the reserved scratch page (never handed out): idle batch
    slots carry all-zero page tables and sequence overruns write/read
    scratch, so a bookkeeping bug can corrupt garbage but never a live
    sequence.  Allocation is ascending-first with LIFO recycling —
    byte-identical page assignments across seeded reruns.

    NOT internally locked: the owner serializes access (the
    DecodeBatcher under its ``_cond``, a standalone DecodeRunner under
    its ``_lock``) — one pool must not be shared between both uses.
    """

    def __init__(self, n_pages, page_size, bytes_per_page):
        n_pages = int(n_pages)
        if n_pages < 2:
            raise MXNetError("PagePool needs >= 2 pages (page 0 is "
                             "scratch), got %d" % n_pages)
        self.n_pages = n_pages
        self.page_size = int(page_size)
        self.bytes_per_page = int(bytes_per_page)
        # descending so .pop() hands out ascending ids; freed pages are
        # pushed back on top (LIFO) — both deterministic
        self._free = list(range(n_pages - 1, 0, -1))
        self._leased = 0

    @property
    def available(self):
        return len(self._free)

    @property
    def pages_in_use(self):
        return self._leased

    def pages_for(self, n_tokens):
        return -(-int(n_tokens) // self.page_size)

    def alloc(self, n):
        """Lease ``n`` pages; raises :class:`NoPagesFree` when the pool
        cannot cover them (callers check :attr:`available` first on the
        admission path — the raise is the belt-and-braces error)."""
        n = int(n)
        if n > len(self._free):
            raise NoPagesFree(
                "%d pages requested, %d free (of %d; %d leased)"
                % (n, len(self._free), self.n_pages - 1, self._leased))
        pages = [self._free.pop() for _ in range(n)]
        self._leased += n
        return pages

    def free(self, pages):
        """Return a lease.  Double-frees raise — a page on two
        sequences' tables is exactly the corruption the scratch-page
        design exists to rule out."""
        for p in pages:
            if p <= 0 or p >= self.n_pages or p in self._free:
                raise MXNetError("bad page free: %r (free list %d/%d)"
                                 % (p, len(self._free), self.n_pages))
        self._free.extend(reversed(pages))
        self._leased -= len(pages)

    def describe(self):
        return {"n_pages": self.n_pages, "page_size": self.page_size,
                "bytes_per_page": self.bytes_per_page,
                "available": self.available,
                "pages_in_use": self.pages_in_use}


def _default_prefill_buckets(page_size, seq_len):
    """Doubling ladder of page multiples up to the context length."""
    out, b = [], page_size
    while b < seq_len:
        out.append(b)
        b *= 2
    out.append(seq_len)
    return tuple(sorted(set(out)))


class DecodeRunner:
    """A TransformerLM behind the prefill/decode ladder and a paged KV
    pool, on one device.

    Parameters
    ----------
    program : DecodeProgram (or a TransformerLMConfig, wrapped with the
        collapsed single-device plan)
    params : dict name -> float32 array or tensor (``MeshProgram``
        parameter layout — what ``init_params`` / ``from_jax_params``
        give); moved to ``device``.
    n_pages : KV pool size in pages, scratch included (default: every
        slot can hold one full-context sequence).
    prefill_buckets : prompt length ladder (page multiples, each warmed
        at load); default doubling page multiples up to seq_len.
    slots : the fixed decode batch width — continuous batching joins and
        leaves within these slots.
    device : where the runner computes — ``None`` is CUDA (raises when
        no CUDA device is present), ``"cpu"`` runs the plain versions of
        the kernels on the host.
    """

    def __init__(self, program, params, n_pages=None, prefill_buckets=None,
                 slots=4, warmup=True, provenance=None, device=None):
        from ..transformer.decode import DecodeProgram
        if not isinstance(program, DecodeProgram):
            program = DecodeProgram(program)
        self.device = resolve_device(device)
        if torch.get_float32_matmul_precision() != "highest":
            # the runner is held to the reference in full float32; it
            # reads the process's setting and never changes it
            raise MXNetError(
                "DecodeRunner needs float32 matmuls at full precision: "
                "torch.get_float32_matmul_precision() is %r, not 'highest'"
                % torch.get_float32_matmul_precision())
        self.program = program
        self.page_size = program.page_size
        self.pages_per_seq = program.pages_per_seq
        self.slots = int(slots)
        if self.slots < 1:
            raise MXNetError("DecodeRunner needs >= 1 slot")
        if n_pages is None:
            n_pages = 1 + self.slots * self.pages_per_seq
        if prefill_buckets is None:
            prefill_buckets = _default_prefill_buckets(
                self.page_size, program.cfg.seq_len)
        self.buckets = tuple(sorted(int(b) for b in set(prefill_buckets)))
        for b in self.buckets:
            if b % self.page_size or b > program.cfg.seq_len or b < 1:
                raise MXNetError(
                    "prefill buckets must be page multiples within "
                    "seq_len %d, got %r"
                    % (program.cfg.seq_len, self.buckets))
        self.pool = PagePool(n_pages, self.page_size,
                             program.bytes_per_page())
        self.provenance = dict(provenance) if provenance else None
        self.example_shape = None   # prompts are variable-length tokens
        names = program.program.param_names
        missing = [n for n in names if n not in params]
        if missing:
            raise MXNetError("params missing %r (MeshProgram layout)"
                             % (missing[:3],))
        self._params = {}
        for n in names:
            v = params[n]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(_np.array(v, _np.float32))
            self._params[n] = v.to(self.device, torch.float32)
        self._param_bytes = int(sum(4 * v.numel()
                                    for v in self._params.values()))
        # _lock guards the cache pools (updated in place by every call)
        # and serializes device dispatch
        self._lock = threading.Lock()
        # zeros, never empty: decode reads every page of a table, scratch
        # included, and 0 x NaN from uninitialised memory would be NaN
        self._ck = torch.zeros(program.global_cache_shape(n_pages),
                               dtype=torch.float32, device=self.device)
        self._cv = torch.zeros_like(self._ck)
        # the (phase, input shape) signatures dispatched so far — the
        # recompile contract's key set (module docstring)
        self._keys = set()
        self._keys_lock = threading.Lock()
        self._warm_keys = frozenset()
        self.warmed_up = False
        if warmup:
            self.warmup()

    # -- bucket arithmetic -------------------------------------------------
    @property
    def max_batch(self):
        return self.slots

    def bucket_for(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        raise MXNetError("prompt of %d tokens exceeds the largest "
                         "prefill bucket %d" % (n, self.buckets[-1]))

    # -- modeled admission bound -------------------------------------------
    def admission_hbm_bytes(self):
        """Pages-based modeled device memory this runner pins: weights +
        the KV page pool + one decode step's working set."""
        cfg = self.program.cfg
        t_max = self.pages_per_seq * self.page_size
        # per-slot decode working set: the gathered K+V run, the
        # attention scores, a few hidden-width residents and the
        # full-vocab logits row — all f32
        step = self.slots * 4 * (
            2 * t_max * cfg.n_heads * cfg.head_dim
            + cfg.n_heads * t_max
            + 4 * cfg.d_model + cfg.d_ff + cfg.vocab_size)
        return self._param_bytes + self.cache_bytes() + step

    def modeled_peak_hbm(self):
        return self.admission_hbm_bytes()

    def cache_bytes(self):
        return self.pool.n_pages * self.pool.bytes_per_page

    # -- execution ---------------------------------------------------------
    def _pad_prompt(self, prompt):
        prompt = _np.asarray(prompt, _np.int32).ravel()
        if prompt.size < 1:
            raise MXNetError("empty prompt")
        bucket = self.bucket_for(prompt.size)
        toks = _np.zeros(bucket, _np.int64)
        toks[:prompt.size] = prompt
        return toks, prompt.size

    def _ids(self, a):
        return torch.from_numpy(_np.asarray(a, _np.int64)).to(self.device)

    def _dispatched(self, phase, shape):
        with self._keys_lock:
            self._keys.add((phase, tuple(int(s) for s in shape)))

    def prefill(self, prompt, page_row):
        """Run one prompt through its length bucket, writing K/V into
        ``page_row``'s pages; returns the next-token logits ``(V,)`` as
        numpy.  ``page_row`` is the sequence's page list (padded with
        zeros to ``pages_per_seq``)."""
        toks, length = self._pad_prompt(prompt)
        pr = _np.asarray(page_row, _np.int64).ravel()
        row = _np.zeros(self.pages_per_seq, _np.int64)
        row[:pr.size] = pr
        with self._lock, torch.no_grad():
            self._dispatched("prefill", (1, toks.size))
            logits, self._ck, self._cv = self.program.prefill_replica(
                self._params, self._ck, self._cv, self._ids(row[None]),
                self._ids(toks[None]), self._ids([length]))
            return logits[0].cpu().numpy()

    def decode_step(self, page_tables, lengths, tokens):
        """One token step over the full slot batch: ``page_tables
        (slots, pages_per_seq)``, ``lengths (slots,)``, ``tokens
        (slots,)`` int (idle slots all-zero).  Returns the next-token
        logits ``(slots, V)`` as numpy."""
        with self._lock, torch.no_grad():
            self._dispatched("decode", _np.shape(tokens))
            logits, self._ck, self._cv = self.program.decode_replica(
                self._params, self._ck, self._cv, self._ids(page_tables),
                self._ids(lengths), self._ids(tokens))
            return logits.cpu().numpy()

    # -- convenience decodes -----------------------------------------------
    def generate(self, prompt, max_new_tokens, eos_token=None):
        """Standalone greedy decode of ONE prompt through the paged
        cache (allocates from the pool, frees on return).  Not for use
        concurrently with a DecodeBatcher over the same runner — the
        pool has one owner."""
        prompt = _np.asarray(prompt, _np.int32).ravel()
        t_max = self.pages_per_seq * self.page_size
        if prompt.size + max_new_tokens > t_max:
            raise MXNetError(
                "prompt %d + max_new %d exceeds the context length %d"
                % (prompt.size, max_new_tokens, t_max))
        need = self.pool.pages_for(prompt.size + max_new_tokens)
        with self._lock:
            pages = self.pool.alloc(min(need, self.pages_per_seq))
        try:
            row = _np.zeros(self.pages_per_seq, _np.int32)
            row[:len(pages)] = pages
            logits = self.prefill(prompt, pages)
            out = [int(logits.argmax())]
            pt = _np.zeros((self.slots, self.pages_per_seq), _np.int32)
            lengths = _np.zeros(self.slots, _np.int32)
            toks = _np.zeros(self.slots, _np.int32)
            pt[0] = row
            lengths[0] = prompt.size
            toks[0] = out[-1]
            while len(out) < max_new_tokens and \
                    (eos_token is None or out[-1] != eos_token):
                step = self.decode_step(pt, lengths, toks)
                out.append(int(step[0].argmax()))
                lengths[0] += 1
                toks[0] = out[-1]
            return _np.asarray(out, _np.int32)
        finally:
            with self._lock:
                self.pool.free(pages)

    def reference_decode(self, prompt, max_new_tokens, eos_token=None):
        """Sequential NO-cache greedy reference: re-prefills the whole
        growing sequence every step through scratch pages only (zero
        table).  O(T^2) and slow on purpose — the numerics oracle the
        continuous-batching checks compare against."""
        seq = list(_np.asarray(prompt, _np.int32).ravel())
        out = []
        while len(out) < max_new_tokens and \
                (eos_token is None or not out or out[-1] != eos_token):
            logits = self.prefill(_np.asarray(seq, _np.int32),
                                  _np.zeros(0, _np.int32))
            nxt = int(logits.argmax())
            out.append(nxt)
            seq.append(nxt)
            if eos_token is not None and nxt == eos_token:
                break
        return _np.asarray(out, _np.int32)

    # -- warmup & the recompile contract -----------------------------------
    def warmup(self):
        """Run the whole ladder now: one scratch prefill per length
        bucket plus one idle decode step, then snapshot the dispatched
        signatures as the baseline."""
        for b in self.buckets:
            self.prefill(_np.zeros(b, _np.int32), _np.zeros(0, _np.int32))
        self.decode_step(
            _np.zeros((self.slots, self.pages_per_seq), _np.int32),
            _np.zeros(self.slots, _np.int32),
            _np.zeros(self.slots, _np.int32))
        self._warm_keys = frozenset(self.jit_cache_keys())
        self.warmed_up = True
        return self._warm_keys

    def jit_cache_keys(self):
        """{(phase, input shape)} over every dispatch so far — the
        steady-state proof surface (the name is the reference's)."""
        with self._keys_lock:
            return set(self._keys)

    def recompiles_since_warmup(self):
        return len(self.jit_cache_keys() - self._warm_keys)

    def __repr__(self):
        return ("<DecodeRunner slots=%d prefill_buckets=%s pages=%d "
                "page_size=%d kv_dtype=%s device=%s>"
                % (self.slots, list(self.buckets), self.pool.n_pages,
                   self.page_size, self.program.kv_dtype, self.device))


class DecodeStats(ServingStats):
    """ServingStats plus the token-level decode surface: per-token step
    latency percentiles (overall and per tier), token/step/prefill
    totals, and page-pool occupancy — what the telemetry collector and
    the decode bench serialize."""

    def __init__(self, buckets=()):
        super().__init__(buckets)
        self.tokens_total = 0
        self.steps_total = 0
        self.prefills_total = 0
        self.sequences_done_total = 0
        self._token_ms = deque(maxlen=_WINDOW)
        self._tier_token_ms = {}

    def on_prefill(self, bucket, ms):
        with self._lock:
            self.prefills_total += 1
            self._lat_ms.setdefault(int(bucket),
                                    deque(maxlen=_WINDOW)).append(ms)

    def on_step(self, n_active, step_ms, tiers=()):
        """One decode step: every active sequence got one token at
        ``step_ms`` per-token latency."""
        with self._lock:
            self.steps_total += 1
            self.tokens_total += n_active
            if n_active:
                self._token_ms.append(step_ms)
                for t in tiers:
                    self._tier_token_ms.setdefault(
                        str(t), deque(maxlen=_WINDOW)).append(step_ms)

    def on_sequence_done(self):
        with self._lock:
            self.sequences_done_total += 1

    def token_latency_ms(self, tier=None):
        """(p50, p99) per-token step latency, overall or for one tier."""
        with self._lock:
            if tier is None:
                samples = list(self._token_ms)
            else:
                samples = list(self._tier_token_ms.get(str(tier), ()))
        return percentile(samples, 50), percentile(samples, 99)

    def as_dict(self):
        out = super().as_dict()
        p50, p99 = self.token_latency_ms()
        with self._lock:
            tiers = {}
            for t in sorted(self._tier_token_ms):
                s = list(self._tier_token_ms[t])
                tiers[t] = {"count": len(s),
                            "p50_ms": round(percentile(s, 50), 3),
                            "p99_ms": round(percentile(s, 99), 3)}
            out["decode"] = {
                "tokens_total": self.tokens_total,
                "steps_total": self.steps_total,
                "prefills_total": self.prefills_total,
                "sequences_done_total": self.sequences_done_total,
                "token_p50_ms": round(p50, 3),
                "token_p99_ms": round(p99, 3),
                "tiers": tiers,
            }
        return out


class _DecodeRequest:
    """One sequence in flight: prompt, token budget, SLO coordinates,
    the accumulated greedy tokens and a tiny future.  Orders by
    (tier rank, absolute deadline, arrival) — the ``_Pending`` key."""

    __slots__ = ("prompt", "max_new", "tier_rank", "deadline_ms",
                 "t_deadline", "seq", "t_submit", "on_token", "tokens",
                 "slot", "pages", "cached_len", "_event", "_result",
                 "_exc")

    def __init__(self, prompt, max_new, tier_rank=0, deadline_ms=None,
                 seq=0, on_token=None):
        self.prompt = prompt
        self.max_new = int(max_new)
        self.tier_rank = tier_rank
        self.deadline_ms = deadline_ms
        self.t_submit = time.monotonic()
        self.t_deadline = (self.t_submit + deadline_ms / 1000.0
                           if deadline_ms is not None else None)
        self.seq = seq
        self.on_token = on_token
        self.tokens = []
        self.slot = None
        self.pages = None
        self.cached_len = 0
        self._event = threading.Event()
        self._result = None
        self._exc = None

    @property
    def tier(self):
        return tier_name(self.tier_rank)

    @property
    def tokens_left(self):
        return self.max_new - len(self.tokens)

    def _key(self):
        return (self.tier_rank,
                self.t_deadline if self.t_deadline is not None
                else float("inf"),
                self.seq)

    def __lt__(self, other):
        return self._key() < other._key()

    def set_result(self, value):
        self._result = value
        self._event.set()

    def set_exception(self, exc):
        self._exc = exc
        self._event.set()

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("sequence not decoded within %ss" % timeout)
        if self._exc is not None:
            raise self._exc
        return self._result


class DecodeBatcher:
    """Continuous batching over one :class:`DecodeRunner`.

    One worker thread owns the slot table.  Each iteration it: sweeps
    hopeless queued requests (tokens-remaining arithmetic, below),
    joins queued sequences into free slots while the page pool covers
    their full token budget (strict priority order — a head that does
    not fit blocks lower tiers, deterministically), prefills joiners
    (their first token comes from prefill), runs ONE decode step for
    the active set, appends each slot's greedy token, and retires
    finished sequences — freeing their pages the same step
    (:meth:`schedule_events` logs every join/leave/shed with its step
    ordinal; the determinism tests replay it byte-identical).

    Tokens-remaining admission arithmetic (docs/serving.md):

    - per-token time ``est`` = ``token_time_hint_ms`` when pinned, else
      the EWMA of measured step times (optimistic 0 before any signal);
    - modeled completion of a request at queue ``position`` =
      ``(slot_wait + ahead_tokens // slots + max_new) * est`` where
      ``slot_wait`` is 0 with a free slot else the smallest
      tokens-remaining among active sequences, and ``ahead_tokens`` is
      the summed token budget queued ahead of it;
    - a request whose modeled completion exceeds ``deadline_ms`` is
      shed at admission (``shed_at="admit"``), evicted by rank under a
      full queue (``"evict"``), or swept from the queue when it becomes
      hopeless (``"sweep"``) — the Batcher ladder, in tokens.  Active
      sequences are never shed: once a slot is granted it runs to
      completion (pages stay leased a bounded time by construction).

    ``paused=True`` holds the worker until :meth:`release` — the
    determinism tests submit a whole seeded burst sequentially first,
    so arrival order (and with a pinned hint, every shed decision) is
    reproducible bit-for-bit.
    """

    def __init__(self, runner, max_queue=64, token_time_hint_ms=None,
                 stats=None, model=None, eos_token=None,
                 on_step_success=None, on_step_error=None, paused=False):
        self.runner = runner
        self.max_queue = int(max_queue)
        self.model = model
        self.eos_token = eos_token
        self.token_time_hint_ms = token_time_hint_ms
        self.stats = stats if stats is not None else \
            DecodeStats(runner.buckets)
        self.on_step_success = on_step_success
        self.on_step_error = on_step_error
        self._est_token_ewma_ms = None
        # _cond guards _queue/_slots/_seq/_step_no/_schedule and the
        # runner's page pool bookkeeping; never held across device calls
        self._cond = threading.Condition()
        self._queue = []           # sorted by _DecodeRequest._key()
        self._slots = [None] * runner.slots
        self._seq = 0
        self._step_no = 0
        self._schedule = []
        self._paused = bool(paused)
        # held only around runner calls (prefill + the decode step); the
        # stalled() probe reads _step_started bare, single-writer
        self._runner_lock = threading.Lock()
        self._step_started = None
        self._draining = threading.Event()
        self._drained = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="mxtpu-decode-batcher",
                                        daemon=True)
        self._thread.start()

    # -- tokens-remaining admission arithmetic ------------------------------
    @property
    def est_token_ms(self):
        if self.token_time_hint_ms is not None:
            return float(self.token_time_hint_ms)
        return self._est_token_ewma_ms

    def _modeled_completion_ms_locked(self, req, position):
        """Modeled time to FINISH a request at queue ``position`` (class
        docstring arithmetic); 0.0 with no per-token signal yet."""
        est = self.est_token_ms
        if est is None:
            return 0.0
        active = [r for r in self._slots if r is not None]
        if len(active) < len(self._slots):
            slot_wait = 0
        else:
            slot_wait = min(r.tokens_left for r in active)
        ahead = sum(r.max_new for r in self._queue[:position])
        return (slot_wait + ahead // len(self._slots)
                + req.max_new) * est

    def modeled_wait_ms(self):
        """Modeled wait-to-first-token a request submitted now at the
        lowest priority would see (the /stats + Retry-After surface)."""
        with self._cond:
            est = self.est_token_ms
            if est is None:
                return 0.0
            active = [r for r in self._slots if r is not None]
            slot_wait = 0 if len(active) < len(self._slots) \
                else min(r.tokens_left for r in active)
            ahead = sum(r.max_new for r in self._queue)
            return (slot_wait + ahead // len(self._slots)) * est

    def _retry_after_s(self, wait_ms):
        return max(1.0, math.ceil(wait_ms / 1000.0))

    # -- client side -------------------------------------------------------
    @property
    def queue_depth(self):
        with self._cond:
            return len(self._queue)

    @property
    def active_sequences(self):
        with self._cond:
            return sum(1 for r in self._slots if r is not None)

    @property
    def draining(self):
        return self._draining.is_set()

    def stalled(self, threshold_s):
        started = self._step_started
        return started is not None and \
            time.monotonic() - started > float(threshold_s)

    def submit(self, prompt, max_new_tokens=16, tier=DEFAULT_TIER,
               deadline_ms=None, on_token=None):
        """Enqueue one prompt; returns a future-like whose ``result()``
        is the ``(n,)`` int32 array of greedily decoded tokens.

        ``max_new_tokens`` is the token budget the page allocation (and
        the tokens-remaining arithmetic) covers — generation stops
        there or at ``eos_token``.  ``on_token(token_id)`` streams each
        token as it lands (called outside every lock).  Sheds/rejects
        exactly like :class:`~mxnet_tpu_torch.serving.batcher.Batcher`:
        :class:`RequestShed` / :class:`ServerBusy` / :class:`Draining`,
        never blocking the caller."""
        rank = tier_rank(tier)
        if deadline_ms is not None and deadline_ms <= 0:
            raise MXNetError("deadline_ms must be positive, got %r"
                             % (deadline_ms,))
        prompt = _np.asarray(prompt, _np.int32).ravel()
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise MXNetError("max_new_tokens must be >= 1, got %r"
                             % (max_new_tokens,))
        if prompt.size + max_new > self.runner.pages_per_seq \
                * self.runner.page_size:
            raise MXNetError(
                "prompt %d + max_new %d exceeds the context length %d"
                % (prompt.size, max_new,
                   self.runner.pages_per_seq * self.runner.page_size))
        self.runner.bucket_for(prompt.size)   # raises on over-long prompt
        victim = None
        with self._cond:
            if self._draining.is_set():
                raise Draining("decode server is draining; "
                               "request rejected")
            req = _DecodeRequest(prompt, max_new, rank, deadline_ms,
                                 self._seq, on_token)
            self._seq += 1
            position = bisect.bisect_left(self._queue, req)
            if deadline_ms is not None:
                done_ms = self._modeled_completion_ms_locked(req, position)
                if done_ms > deadline_ms:
                    self.stats.on_shed(req.tier)
                    self._schedule.append(
                        ("shed-admit", req.seq, self._step_no))
                    raise RequestShed(
                        "modeled completion %.0fms exceeds deadline "
                        "%.0fms (tier=%s, %d tokens, depth=%d); shed at "
                        "admission" % (done_ms, deadline_ms, req.tier,
                                       max_new, len(self._queue)),
                        tier=req.tier,
                        retry_after_s=self._retry_after_s(done_ms),
                        shed_at="admit")
            if len(self._queue) >= self.max_queue:
                if self._queue and req < self._queue[-1]:
                    victim = self._queue.pop()
                    self.stats.on_dequeue(1)
                    self.stats.on_shed(victim.tier)
                    self._schedule.append(
                        ("shed-evict", victim.seq, self._step_no))
                else:
                    self.stats.on_reject()
                    raise ServerBusy(
                        "decode queue full (%d deep); retry later"
                        % self.max_queue) from None
            bisect.insort(self._queue, req)
            self._cond.notify_all()
        if victim is not None:
            victim.set_exception(RequestShed(
                "evicted by a higher-tier arrival under a full queue "
                "(tier=%s)" % victim.tier, tier=victim.tier,
                retry_after_s=self._retry_after_s(self.modeled_wait_ms()),
                shed_at="evict"))
        self.stats.on_submit()
        return req

    def decode(self, prompt, max_new_tokens=16, timeout=60.0,
               tier=DEFAULT_TIER, deadline_ms=None):
        """Blocking convenience: submit + wait for the decoded tokens."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           tier=tier, deadline_ms=deadline_ms
                           ).result(timeout)

    def release(self):
        """Start a ``paused=True`` batcher's worker."""
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def schedule_events(self):
        """The deterministic continuous-batching schedule: a tuple of
        ``(event, request_seq, step_ordinal)`` rows over joins, leaves
        and sheds — what the determinism tests compare byte-identical
        across seeded reruns."""
        with self._cond:
            return tuple(self._schedule)

    # -- worker side -------------------------------------------------------
    def _sweep_hopeless_locked(self):
        if not self._queue:
            return []
        now = time.monotonic()
        shed, keep = [], []
        for pos, req in enumerate(self._queue):
            if req.t_deadline is not None and \
                    now + self._modeled_completion_ms_locked(req, pos) \
                    / 1000.0 > req.t_deadline:
                shed.append(req)
                self._schedule.append(("shed-sweep", req.seq,
                                       self._step_no))
            else:
                keep.append(req)
        if shed:
            self._queue = keep
            self.stats.on_dequeue(len(shed))
            for req in shed:
                self.stats.on_shed(req.tier, swept=True)
        return shed

    def _join_locked(self):
        """Admit queued sequences into free slots in strict priority
        order while the pool covers their FULL token budget; returns the
        joiners (prefill happens outside the lock).  A head that does
        not fit stops admission — no lower-tier bypass, so the schedule
        stays deterministic (class docstring)."""
        pool = self.runner.pool
        joins = []
        while self._queue:
            free = [i for i, r in enumerate(self._slots) if r is None]
            if not free:
                break
            req = self._queue[0]
            need = pool.pages_for(req.prompt.size + req.max_new)
            if need > pool.available:
                break
            self._queue.pop(0)
            self.stats.on_dequeue(1)
            req.pages = pool.alloc(need)
            req.slot = free[0]
            self._slots[req.slot] = req
            self._schedule.append(("join", req.seq, self._step_no))
            joins.append(req)
        return joins

    def _retire_locked(self, req):
        self._slots[req.slot] = None
        self.runner.pool.free(req.pages)
        req.pages = None
        self._schedule.append(("leave", req.seq, self._step_no))
        self.stats.on_sequence_done()

    def _page_row(self, req):
        row = _np.zeros(self.runner.pages_per_seq, _np.int32)
        row[:len(req.pages)] = req.pages
        return row

    def _prefill_joiners(self, joins):
        """Prefill each joiner (outside ``_cond``; the runner serializes
        device calls) — its first greedy token comes from the prefill
        logits.  Returns the sequences already finished (budget of 1 or
        an immediate eos)."""
        finished = []
        for req in joins:
            t0 = time.monotonic()
            self._step_started = t0
            try:
                with self._runner_lock:
                    logits = self.runner.prefill(req.prompt,
                                                 req.pages)
            finally:
                self._step_started = None
            self.stats.on_prefill(self.runner.bucket_for(req.prompt.size),
                                  (time.monotonic() - t0) * 1000.0)
            req.cached_len = int(req.prompt.size)
            tok = int(logits.argmax())
            req.tokens.append(tok)
            if req.on_token is not None:
                try:
                    req.on_token(tok)
                except Exception:
                    pass
            if req.tokens_left == 0 or tok == self.eos_token:
                finished.append(req)
        return finished

    def _run_step(self, active):
        """One decode step for the current active set.  Chaos fires the
        registered ``serving.batch`` site per step; a raise fails every
        active sequence AND frees its pages (no-leak contract)."""
        from ..resilience import chaos as _chaos
        self._step_started = time.monotonic()
        try:
            _chaos.maybe_inject("serving.batch", ctx=active)
            pt = _np.zeros((self.runner.slots, self.runner.pages_per_seq),
                           _np.int32)
            lengths = _np.zeros(self.runner.slots, _np.int32)
            toks = _np.zeros(self.runner.slots, _np.int32)
            for req in active:
                pt[req.slot] = self._page_row(req)
                lengths[req.slot] = req.cached_len
                toks[req.slot] = req.tokens[-1]
            with self._runner_lock:
                logits = self.runner.decode_step(pt, lengths, toks)
            step_ms = (time.monotonic() - self._step_started) * 1000.0
            self._observe_token_ms(step_ms)
            finished = []
            for req in active:
                tok = int(logits[req.slot].argmax())
                req.tokens.append(tok)
                req.cached_len += 1
                if req.on_token is not None:
                    try:
                        req.on_token(tok)
                    except Exception:
                        pass
                if req.tokens_left == 0 or tok == self.eos_token:
                    finished.append(req)
            self.stats.on_step(len(active), step_ms,
                               tiers=[r.tier for r in active])
            self.stats.set_recompiles(
                self.runner.recompiles_since_warmup())
            with self._cond:
                self._step_no += 1
                for req in finished:
                    self._retire_locked(req)
            for req in finished:
                req.set_result(_np.asarray(req.tokens, _np.int32))
            if self.on_step_success is not None:
                try:
                    self.on_step_success()
                except Exception:
                    pass
        except Exception as e:
            # chaos raise or a runner failure: fail every active
            # sequence, free its pages — pages never leak (the chaos
            # reclamation test), the worker keeps serving
            with self._cond:
                self._step_no += 1
                for req in active:
                    if req.pages is not None:
                        self._retire_locked(req)
            for req in active:
                if not req.done():
                    req.set_exception(e)
            self.stats.on_batch(0, len(active), [], error=True,
                                tiers=[r.tier for r in active])
            if self.on_step_error is not None:
                try:
                    self.on_step_error(e)
                except Exception:
                    pass
        finally:
            self._step_started = None

    def _observe_token_ms(self, measured_ms):
        if self._est_token_ewma_ms is None:
            self._est_token_ewma_ms = measured_ms
        else:
            self._est_token_ewma_ms = 0.7 * self._est_token_ewma_ms \
                + 0.3 * measured_ms

    def _fail_prefilled(self, req, exc):
        """A joiner whose prefill raised: retire it and propagate."""
        with self._cond:
            self._retire_locked(req)
        if not req.done():
            req.set_exception(exc)
        if self.on_step_error is not None:
            try:
                self.on_step_error(exc)
            except Exception:
                pass

    def _loop(self):
        while True:
            with self._cond:
                if self._paused:
                    self._cond.wait(timeout=0.05)
                    continue
                shed = self._sweep_hopeless_locked()
                joins = self._join_locked()
                active = [r for r in self._slots if r is not None]
                if not joins and not active and not shed:
                    if self._draining.is_set() and not self._queue:
                        break
                    self._cond.wait(timeout=0.05)
                    continue
            for req in shed:
                req.set_exception(RequestShed(
                    "deadline %.0fms unreachable (modeled completion "
                    "exceeds remaining budget, tier=%s, %d tokens left); "
                    "shed by sweep" % (req.deadline_ms, req.tier,
                                       req.tokens_left),
                    tier=req.tier,
                    retry_after_s=self._retry_after_s(
                        self.modeled_wait_ms()),
                    shed_at="sweep"))
            prefill_done = []
            for req in joins:
                try:
                    prefill_done += self._prefill_joiners([req])
                except Exception as e:
                    self._fail_prefilled(req, e)
            for req in prefill_done:
                with self._cond:
                    self._retire_locked(req)
                req.set_result(_np.asarray(req.tokens, _np.int32))
            with self._cond:
                active = [r for r in self._slots if r is not None]
            if active:
                self._run_step(active)
        self._drained.set()

    # -- fleet surface ------------------------------------------------------
    def swap_runner(self, runner, timeout=30.0):
        raise MXNetError(
            "DecodeBatcher does not hot-swap: live page tables index one "
            "runner's cache pool; drain and re-register instead")

    # -- lifecycle ---------------------------------------------------------
    def drain(self, timeout=60.0):
        """Graceful shutdown: stop admitting, decode every queued and
        active sequence to completion, join the worker.  Idempotent."""
        with self._cond:
            self._draining.set()
            self._cond.notify_all()
        if not self._drained.wait(timeout):
            raise TimeoutError("decode batcher did not drain within %ss"
                               % timeout)
        self._thread.join(timeout=5.0)
        return True

    def force_drain(self):
        """Hard drain: fail every queued AND active sequence, free all
        pages, mark drained without waiting for a wedged step.  Returns
        the number of sequences failed."""
        with self._cond:
            self._draining.set()
            stuck, self._queue = self._queue, []
            for i, req in enumerate(self._slots):
                if req is not None:
                    stuck.append(req)
                    if req.pages is not None:
                        self.runner.pool.free(req.pages)
                        req.pages = None
                    self._slots[i] = None
            self._cond.notify_all()
        failed = 0
        for req in stuck:
            self.stats.on_dequeue(1)
            req.set_exception(Draining(
                "decode server hit its drain deadline; sequence "
                "not served"))
            failed += 1
        self._drained.set()
        return failed

    close = drain
