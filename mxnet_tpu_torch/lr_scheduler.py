"""Learning-rate schedulers: the port of ``mxnet_tpu/lr_scheduler.py``
(reference: ``python/mxnet/lr_scheduler.py``).  Host-side Python; the
trainer reads ``opt.lr_scheduler(step)`` once per step."""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01):
        super().__init__(base_lr)
        if step < 1:
            raise ValueError("step must be >= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, base_lr=0.01):
        super().__init__(base_lr)
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update

    def __call__(self, num_update):
        if num_update <= self.max_update:
            self.base_lr = self.base_lr_orig * pow(
                1 - float(num_update) / float(self.max_update), self.power)
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Cosine decay with warmup (the reference package's addition)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0, warmup_steps=0,
                 warmup_begin_lr=0.0):
        super().__init__(base_lr)
        self.max_update = max_update
        self.final_lr = final_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.max_lr = base_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.warmup_begin_lr + (
                self.max_lr - self.warmup_begin_lr) * num_update / max(
                    1, self.warmup_steps)
        if num_update <= self.max_update:
            t = (num_update - self.warmup_steps) / max(
                1, self.max_update - self.warmup_steps)
            return self.final_lr + (self.max_lr - self.final_lr) * 0.5 * (
                1 + math.cos(math.pi * t))
        return self.final_lr
