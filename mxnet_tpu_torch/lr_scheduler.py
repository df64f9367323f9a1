"""Learning-rate schedulers of the port (mirrors
``mxnet_tpu/lr_scheduler.py``).

Reference: python/mxnet/lr_scheduler.py — FactorScheduler,
MultiFactorScheduler, PolyScheduler, CosineScheduler with warmup. Pure
Python host objects: ``Optimizer`` reads the schedule's value each
update, in float64, and the update ops take it as a per-step scalar, so
a schedule never changes a recorded update program
(``optimizer/fused.py``).
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base scheduler: maps ``num_update`` → learning rate.

    Supports linear/constant warmup for the first ``warmup_steps`` updates
    (reference: python/mxnet/lr_scheduler.py:30-80).
    """

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        if warmup_mode not in ("linear", "constant"):
            raise ValueError("Supported warmup modes are linear and constant")
        self.warmup_mode = warmup_mode
        if warmup_begin_lr > base_lr:
            raise ValueError("Base lr has to be higher than warmup_begin_lr")
        if warmup_steps < 0:
            raise ValueError("Warmup steps has to be positive or 0")

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == "linear":
            increase = ((self.warmup_final_lr - self.warmup_begin_lr)
                        * float(num_update) / float(self.warmup_steps))
            return self.warmup_begin_lr + increase
        return self.warmup_begin_lr

    def __call__(self, num_update):
        raise NotImplementedError()


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates (reference: FactorScheduler)."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                return self.base_lr
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each step in a given list (reference:
    MultiFactorScheduler)."""

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        assert isinstance(step, list) and len(step) >= 1
        for i, _step in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise ValueError("Schedule step must be an increasing list")
            if _step < 1:
                raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay to final_lr over max_update (reference:
    PolyScheduler)."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        assert isinstance(max_update, int)
        if max_update < 1:
            raise ValueError("maximum number of updates must be strictly positive")
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = (self.final_lr
                            + (self.base_lr_orig - self.final_lr)
                            * pow(1 - float(num_update - self.warmup_steps)
                                  / float(self.max_steps), self.power))
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Cosine decay to final_lr over max_update (reference:
    CosineScheduler)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        assert isinstance(max_update, int)
        if max_update < 1:
            raise ValueError("maximum number of updates must be strictly positive")
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = (self.final_lr
                            + (self.base_lr_orig - self.final_lr)
                            * (1 + math.cos(math.pi * (num_update - self.warmup_steps)
                                            / self.max_steps)) / 2)
        return self.base_lr
