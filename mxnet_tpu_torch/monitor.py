"""Monitor: per-op output statistics during training, the port of
``mxnet_tpu/monitor.py``.

An installed module calls :meth:`Monitor.observe` after each forward:
while activated (every ``interval``-th ``tic``) it runs the symbol's
internals on the bound arrays in inference mode, without autograd, and
parks every output whose name matches ``pattern`` as it lies on the
device.  The ``stat_func`` (and its copy to the host) runs only at
:meth:`toc` / :meth:`toc_print`, so a monitored loop syncs once per
interval, not once per op.  Past ``MXTPU_MONITOR_MAX_PENDING`` parked
values (1024) the oldest half is drained at once.  :meth:`install_eager`
taps every imperative ``nd`` op instead.  The queue and its drains are
read through the ``telemetry`` registry under the reference's names:
``mxtpu_monitor_pending``, ``mxtpu_monitor_observed_total``,
``mxtpu_monitor_drains_total`` and
``mxtpu_monitor_drain_seconds_total``.
"""
from __future__ import annotations

import logging
import os
import re
import time

import numpy as _np
import torch

from .ndarray.ndarray import _host as _tensor_host

__all__ = ["Monitor"]

# parked outputs beyond this drain at once (a tic() without toc() must
# not pin unbounded device memory)
_MAX_PENDING = int(os.environ.get("MXTPU_MONITOR_MAX_PENDING", "1024"))


def _host(value):
    return _tensor_host(value) if isinstance(value, torch.Tensor) \
        else _np.asarray(value)


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                return _np.abs(x).mean()
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []          # computed (step, name, stat)
        self._pending = []       # parked (step, name, device value)
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort
        self._observed = 0
        self._drains = 0
        self._drain_s = 0.0
        self._eager_tap = None
        from . import telemetry
        telemetry.registry().register_collector(self._metrics_samples,
                                                name="monitor")

    def _metrics_samples(self):
        return {
            "mxtpu_monitor_pending": len(self._pending),
            "mxtpu_monitor_observed_total": self._observed,
            "mxtpu_monitor_drains_total": self._drains,
            "mxtpu_monitor_drain_seconds_total": round(self._drain_s, 6),
        }

    def _park(self, step, name, value):
        """Queue a device value without reading it."""
        self._pending.append((step, name, value))
        self._observed += 1
        if len(self._pending) > _MAX_PENDING:
            overflow, self._pending = (self._pending[:_MAX_PENDING // 2],
                                       self._pending[_MAX_PENDING // 2:])
            self._drain(overflow)

    def _drain(self, entries):
        t0 = time.perf_counter()
        for step, name, value in entries:
            self.queue.append((step, name, self.stat_func(_host(value))))
        self._drains += 1
        self._drain_s += time.perf_counter() - t0

    def install(self, module):
        """Attach to a module, which calls :meth:`observe` after each
        forward."""
        self.exes.append(module)

    def tic(self):
        if self.step % self.interval == 0:
            self.queue = []
            self._pending = []
            self.activated = True
        self.step += 1

    def observe(self, module):
        if not self.activated:
            return
        from .executor import run_plan
        from .symbol.symbol import graph_plan
        exe = module._exec
        internals = module._symbol.get_internals()
        steps, heads = graph_plan(internals)
        with torch.no_grad():
            outs = run_plan(steps, heads,
                            {n: a._data for n, a in exe.arg_dict.items()},
                            {n: a._data for n, a in exe.aux_dict.items()},
                            False, exe._device)
        for name, value in zip(internals.list_outputs(), outs):
            if self.re_prog.match(name):
                self._park(self.step, name, value)

    def toc(self):
        if not self.activated:
            return []
        self.activated = False
        pending, self._pending = self._pending, []
        self._drain(pending)
        res = [(n, k, str(v)) for n, k, v in self.queue]
        if self.sort:
            res = sorted(res, key=lambda x: x[1])
        self.queue = []
        return res

    def toc_print(self):
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)

    def install_eager(self):
        """Tap every imperative op (each ``nd`` invoke parks its outputs,
        named ``<op>_output`` or ``<op>_output<i>``, while activated)."""
        from .ndarray import ndarray as _ndmod

        def tap(op_name, outs):
            if not self.activated:
                return
            for i, o in enumerate(outs):
                name = "%s_output%s" % (op_name, i if len(outs) > 1 else "")
                if self.re_prog.match(name):
                    self._park(self.step, name, o._data)

        self._eager_tap = tap
        _ndmod._MONITOR_TAPS.append(tap)
        return self

    def uninstall_eager(self):
        from .ndarray import ndarray as _ndmod
        if self._eager_tap in _ndmod._MONITOR_TAPS:
            _ndmod._MONITOR_TAPS.remove(self._eager_tap)
        self._eager_tap = None
