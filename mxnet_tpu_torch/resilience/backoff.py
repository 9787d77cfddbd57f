"""Shared retry/backoff policy: exponential backoff with jitter.

The PyTorch port's copy of ``mxnet_tpu/resilience/backoff.py``: every
transient-failure site retries the same way, drawing its delays from one
:class:`BackoffPolicy` (the serving fleet's circuit breakers take their
open windows from it).  Jitter is the load-shedding half of the policy:
N clients that all lost the same server must not redial in lockstep.

Stdlib only.
"""
from __future__ import annotations

import random
import time

__all__ = ["BackoffPolicy", "retry_call", "RetriesExhausted"]


class RetriesExhausted(RuntimeError):
    """``retry_call`` ran out of attempts; ``__cause__`` is the last error."""


class BackoffPolicy:
    """Exponential backoff with multiplicative jitter.

    delay(attempt) = min(base_s * factor**attempt, max_delay_s) * U,
    with U uniform in [1-jitter, 1+jitter] from a policy-local RNG —
    ``seed`` pins the jitter stream so a chaos test (or a BENCH record)
    replays the exact same schedule.

    Parameters
    ----------
    base_s : first delay, seconds.
    factor : multiplier per attempt.
    max_delay_s : cap on the un-jittered delay.
    max_retries : attempts ``retry_call``/``delays`` will make.
    jitter : half-width of the multiplicative jitter band (0 disables).
    seed : int or None — None uses nondeterministic jitter.
    """

    def __init__(self, base_s=0.5, factor=2.0, max_delay_s=30.0,
                 max_retries=8, jitter=0.25, seed=None):
        if base_s <= 0 or factor < 1.0:
            raise ValueError("need base_s > 0 and factor >= 1, got %r/%r"
                             % (base_s, factor))
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1), got %r" % (jitter,))
        self.base_s = float(base_s)
        self.factor = float(factor)
        self.max_delay_s = float(max_delay_s)
        self.max_retries = int(max_retries)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)

    def delay(self, attempt):
        """Jittered delay for 0-based ``attempt``."""
        d = min(self.base_s * self.factor ** int(attempt), self.max_delay_s)
        if self.jitter:
            d *= self._rng.uniform(1.0 - self.jitter, 1.0 + self.jitter)
        return d

    def delays(self):
        """The full delay schedule: ``max_retries`` jittered delays."""
        return [self.delay(a) for a in range(self.max_retries)]

    def sleep(self, attempt):
        """Sleep the jittered delay for ``attempt``; returns it."""
        d = self.delay(attempt)
        time.sleep(d)
        return d


def retry_call(fn, *args, policy=None, retry_on=(OSError, ConnectionError),
               on_retry=None, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying on ``retry_on`` with the
    policy's backoff.  ``on_retry(attempt, exc, delay)`` (if given) is
    called before each sleep — the hook error-history recorders (the
    bench's ``backend_error_history``) plug into.  Raises
    :class:`RetriesExhausted` from the last error once attempts run out.
    """
    policy = policy or BackoffPolicy()
    last = None
    for attempt in range(policy.max_retries + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            last = e
            if attempt >= policy.max_retries:
                break
            d = policy.delay(attempt)
            if on_retry is not None:
                on_retry(attempt, e, d)
            time.sleep(d)
    raise RetriesExhausted(
        "%s failed after %d attempts: %s"
        % (getattr(fn, "__name__", fn), policy.max_retries + 1,
           last)) from last
