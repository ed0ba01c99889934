"""Learning-rate schedules (port of paddle_tpu/optimizer/lr.py: the
``LRScheduler`` protocol and the usual pretraining schedules).  They are
host-side Python: the optimizer reads ``scheduler()`` once per applied
update and the caller advances it with ``step()``."""
from __future__ import annotations

import math
from typing import Optional


class LRScheduler:
    """Base schedule: ``last_epoch`` counts ``step()`` calls (the
    constructor makes the first), ``last_lr`` is ``get_lr()`` there."""

    def __init__(self, learning_rate=0.1, last_epoch=-1):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = self.base_lr
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch: Optional[int] = None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def get_lr(self) -> float:
        raise NotImplementedError

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list, tuple))}

    def set_state_dict(self, state_dict):
        self.__dict__.update(state_dict)


class LinearWarmup(LRScheduler):
    """Linear ramp from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then ``learning_rate`` (a float or another schedule, stepped from 0
    at the end of the warmup)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1):
        self.lr = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * (
                self.last_epoch / self.warmup_steps) + self.start_lr
        if isinstance(self.lr, LRScheduler):
            self.lr.step(self.last_epoch - self.warmup_steps)
            return self.lr()
        return self.lr


class CosineAnnealingDecay(LRScheduler):
    """eta_min + (base - eta_min) * (1 + cos(pi * t / T_max)) / 2."""

    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class LinearLR(LRScheduler):
    """base * a factor ramped linearly from ``start_factor`` to
    ``end_factor`` over ``total_steps``."""

    def __init__(self, learning_rate, total_steps, start_factor=1. / 3,
                 end_factor=1.0, last_epoch=-1):
        if total_steps <= 0:
            raise ValueError("total_steps must be positive")
        if not 0 < start_factor <= 1:
            raise ValueError("start_factor must be in (0, 1]")
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        t = min(self.last_epoch, self.total_steps)
        factor = self.start_factor + (
            self.end_factor - self.start_factor) * t / self.total_steps
        return self.base_lr * factor


__all__ = ["CosineAnnealingDecay", "LRScheduler", "LinearLR",
           "LinearWarmup"]
