"""Deterministic fault injection: replay a fault schedule.

The PyTorch port's copy of ``mxnet_tpu/resilience/chaos.py``, holding
the probe sites the serving path and the data pipeline fire:

- **probe sites**: code at failure-relevant points calls
  ``chaos.maybe_inject("site.name", count, ctx=...)``.  When no schedule
  is installed this is one module-global ``None`` check — zero overhead
  in production.  The registered sites are in :data:`SITES`.
- **faults**: ``Fault(site, at, action, arg)`` — trigger the ``at``-th
  probe hit (1-based; or the probe's explicit ``count``) at ``site`` and
  perform ``action``:

  =========  ==========================================================
  action     effect
  =========  ==========================================================
  raise      raise ``arg`` (an exception instance/class; default
             ``ChaosError``) out of the probe site
  delay      ``time.sleep(arg)`` seconds (stall injection)
  kill       ``os.kill(os.getpid(), SIGKILL)`` — the hard-crash case
  call       ``arg(ctx)`` — site-specific sabotage
  =========  ==========================================================

Faults fire once each (``repeat=True`` re-arms).  ``triggered()`` lists
what actually fired, for assertions.
"""
from __future__ import annotations

import os
import signal
import time

__all__ = ["Fault", "ChaosSchedule", "ChaosError", "install",
           "install_from_env", "uninstall", "installed", "maybe_inject",
           "triggered", "SITES"]

# every probe site shipped in mxnet_tpu_torch/, with its one-line contract
SITES = {
    "pipeline.dispatch": "per dispatched batch; ctx = (iter, wid, idx)",
    "serving.batch": "count = batch number; delay = runner stall",
    "serving.route": "count = routed-request ordinal; ctx = (model, tier)",
    "serving.swap": "fleet hot swap; ctx = model name",
    "trainer.step": "count = step number, before dispatch; ctx = trainer",
    "kvstore.request": "per parameter-server client RPC; ctx = the "
                       "message tuple",
    "kvstore.server_apply": "count = applied-push ordinal on the PS "
                            "server; ctx = (rank, step, key)",
    "kvstore.snapshot": "PS server snapshot capture",
    "checkpoint.save": "between the two halves of a snapshot's write",
    "ckpt.shard_write": "before each shard file is installed; "
                        "ctx = (step, rank)",
}


class ChaosError(RuntimeError):
    """Default injected failure (the 'dropped RPC' stand-in)."""


class Fault:
    """One scheduled fault: at the ``at``-th hit of ``site``, do ``action``."""

    __slots__ = ("site", "at", "action", "arg", "repeat", "_armed")

    def __init__(self, site, at, action="raise", arg=None, repeat=False):
        if action not in ("raise", "delay", "kill", "call"):
            raise ValueError("unknown chaos action %r" % (action,))
        self.site = str(site)
        self.at = int(at)
        self.action = action
        self.arg = arg
        self.repeat = bool(repeat)
        self._armed = True

    def spec(self):
        return (self.site, self.at, self.action, self.arg)

    def __repr__(self):
        return "Fault(%s@%d:%s)" % (self.site, self.at, self.action)


class ChaosSchedule:
    """An ordered set of faults plus per-site hit counters."""

    def __init__(self, faults=()):
        self.faults = list(faults)
        self._hits = {}
        self._triggered = []

    @classmethod
    def seeded(cls, seed, sites, n_faults=3, max_at=50, action="raise",
               arg=None):
        """``n_faults`` faults over ``sites`` at hits in [1, max_at], fully
        determined by ``seed`` (the reference's draw, so both packages
        give the same schedule for a seed)."""
        import random as _random
        rng = _random.Random(int(seed))
        sites = list(sites)
        return cls([Fault(sites[rng.randrange(len(sites))],
                          rng.randint(1, int(max_at)), action, arg)
                    for _ in range(int(n_faults))])

    def specs(self):
        return [f.spec() for f in self.faults]

    def hits(self, site):
        return self._hits.get(site, 0)


_active = None  # the installed ChaosSchedule, or None (the fast path)


def install(schedule):
    """Install a schedule (replacing any active one); returns it."""
    global _active
    if isinstance(schedule, (list, tuple)):
        schedule = ChaosSchedule(schedule)
    _active = schedule
    return schedule


def uninstall():
    """Deactivate fault injection; returns the previous schedule."""
    global _active
    prev, _active = _active, None
    return prev


def installed():
    return _active


def triggered():
    """Specs of faults that actually fired (empty when inactive)."""
    return list(_active._triggered) if _active is not None else []


def maybe_inject(site, count=None, ctx=None):
    """Probe: called from instrumented sites.  No-op (one ``None`` check)
    unless a schedule is installed.  ``count`` overrides the internal
    per-site hit counter."""
    sched = _active
    if sched is None:
        return
    if count is None:
        count = sched._hits[site] = sched._hits.get(site, 0) + 1
    else:
        sched._hits[site] = int(count)
    for f in sched.faults:
        if not f._armed or f.site != site or int(count) != f.at:
            continue
        if not f.repeat:
            f._armed = False
        sched._triggered.append(f.spec())
        # counted BEFORE the action runs, so even a kill leaves the
        # evidence behind (lazy import: chaos stays importable alone)
        try:
            from .. import telemetry as _tele
            _tele.fault_event(site, f.at, f.action, ctx=ctx)
        except Exception:
            pass  # telemetry must never mask or reorder the fault itself
        if f.action == "delay":
            time.sleep(float(f.arg or 0.05))
        elif f.action == "kill":
            os.kill(int(f.arg) if f.arg else os.getpid(), signal.SIGKILL)
        elif f.action == "call":
            f.arg(ctx)
        else:  # raise
            exc = f.arg if f.arg is not None else ChaosError(
                "chaos: injected failure at %s hit %d" % (site, f.at))
            if isinstance(exc, type):
                exc = exc("chaos: injected failure at %s hit %d"
                          % (site, f.at))
            raise exc


def install_from_env(var="MXTPU_CHAOS"):
    """Arm faults from an env spec — the subprocess chaos hook.

    Format: comma-separated ``site:at:action[:arg]`` entries, e.g.
    ``MXTPU_CHAOS="trainer.step:7:kill"``.  Returns the installed
    schedule, or None when the var is unset/empty."""
    spec = os.environ.get(var, "").strip()
    if not spec:
        return None
    faults = []
    for entry in spec.split(","):
        parts = entry.strip().split(":")
        if len(parts) < 3:
            raise ValueError("bad %s entry %r (want site:at:action[:arg])"
                             % (var, entry))
        site, at, action = parts[0], int(parts[1]), parts[2]
        arg = None
        if len(parts) > 3 and parts[3]:
            arg = float(parts[3]) if action == "delay" else parts[3]
        faults.append(Fault(site, at, action, arg))
    return install(ChaosSchedule(faults))
