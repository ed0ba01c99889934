"""Learning-rate schedules (port of paddle_tpu/optimizer/lr.py).

A schedule is host-side Python: the optimizer reads ``scheduler()`` once
per applied update and the caller advances it with ``step()``.  A
schedule whose value is a function of its step alone also has
``traced_lr()``, the same value computed on the device from a step
tensor, which ``jit.TrainStep.run_steps`` evaluates inside its CUDA
graphs (the JAX package computes it inside its ``lax.scan``).  Where JAX
returns None (stateful, metric- or callback-driven schedules) so does
the port.

The device value must equal the host's: ``run_steps`` is held bit for
bit to single calls that read ``get_lr()``.  So each traced schedule
computes in f64, in ``get_lr``'s own order of operations, and is rounded
to f32 once; JAX's f32 arithmetic can land an ulp away.  Powers go
through ``_pow`` (a tensor exponent), because ``torch.pow`` with a
scalar exponent takes shortcuts (``rsqrt`` for -0.5, ``x*x*x`` for 3)
that round otherwise than ``math.pow``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

_F64 = torch.float64


def _full(value, like):
    """``value`` as a 0-d f64 tensor on ``like``'s device (a fill, which a
    CUDA graph captures; ``torch.tensor`` would copy from the host)."""
    return torch.full((), float(value), dtype=_F64, device=like.device)


def _pow(base, exp):
    """``base ** exp`` through the generic power of two tensors."""
    ref = exp if isinstance(exp, torch.Tensor) else base
    base = base if isinstance(base, torch.Tensor) else _full(base, ref)
    exp = exp if isinstance(exp, torch.Tensor) else _full(exp, ref)
    return torch.pow(base, exp)


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

    def _traced(self) -> Optional[Callable]:
        """``fn(step) -> 0-d f64 tensor``, ``get_lr()`` at ``last_epoch =
        step`` for an integer step tensor, or None where the schedule
        cannot be computed from its step alone."""
        return None

    def traced_lr(self) -> Optional[Callable]:
        """``fn(step) -> 0-d f32 tensor`` on the step's device: the
        learning rate at ``last_epoch = step``, equal to ``get_lr()``
        rounded to f32; None where the schedule cannot be traced."""
        fn = self._traced()
        if fn is None:
            return None
        return lambda step: fn(step).to(torch.float32)

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list, tuple))}

    def set_state_dict(self, state_dict):
        self.__dict__.update(state_dict)


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return (self.base_lr * self.d_model ** -0.5 *
                min(step ** -0.5, step * self.warmup_steps ** -1.5))

    def _traced(self):
        scale = self.base_lr * self.d_model ** -0.5
        slope = self.warmup_steps ** -1.5

        def fn(step):
            s = step.clamp_min(1).to(_F64)
            return scale * torch.minimum(_pow(s, -0.5), s * slope)
        return fn


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]

    def _traced(self):
        bounds = list(self.boundaries)
        values = [float(v) for v in self.values]

        def fn(step):
            # the first boundary above the step picks its value: walked
            # from the last, so the first one wins
            lr = _full(values[len(bounds)], step)
            for b, v in reversed(list(zip(bounds, values))):
                lr = torch.where(step < b, v, lr)
            return lr
        return fn


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)

    def _traced(self):
        base, gamma = self.base_lr, self.gamma
        return lambda step: base * torch.exp(-gamma * step.to(_F64))


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)

    def _traced(self):
        base, gamma = self.base_lr, self.gamma
        return lambda step: base / (1 + gamma * step.to(_F64))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / decay_steps) if step > 0 else 1
            decay_steps = decay_steps * div
        else:
            step = min(step, decay_steps)
        return ((self.base_lr - self.end_lr) *
                (1 - step / decay_steps) ** self.power + self.end_lr)

    def _traced(self):
        base, end, power = self.base_lr, self.end_lr, self.power
        ds, cycle = self.decay_steps, self.cycle

        def fn(step):
            s = step.to(_F64)
            if cycle:
                div = torch.where(step > 0, torch.ceil(s / ds), 1.0)
                eff = ds * div
            else:
                s = s.clamp_max(ds)
                eff = ds
            return (base - end) * _pow(1 - s / eff, power) + end
        return fn


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

    def _traced(self):
        if isinstance(self.lr, LRScheduler):
            inner = self.lr._traced()
            if inner is None:
                return None
        else:
            after = float(self.lr)
            inner = None
        warm, start, rise = self.warmup_steps, self.start_lr, \
            self.end_lr - self.start_lr

        def fn(step):
            ramp = rise * (step.to(_F64) / warm) + start
            rest = inner(step - warm) if inner is not None \
                else _full(after, step)
            return torch.where(step < warm, ramp, rest)
        return fn


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch

    def _traced(self):
        base, gamma = self.base_lr, self.gamma
        return lambda step: base * _pow(gamma, step.to(_F64))


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        n = sum(1 for m in self.milestones if m <= self.last_epoch)
        return self.base_lr * self.gamma ** n

    def _traced(self):
        base, gamma, miles = self.base_lr, self.gamma, list(self.milestones)

        def fn(step):
            n = torch.zeros((), dtype=_F64, device=step.device)
            for m in miles:
                n = n + (step >= m)
            return base * _pow(gamma, n)
        return fn


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)

    def _traced(self):
        base, gamma, size = self.base_lr, self.gamma, self.step_size
        return lambda step: base * _pow(
            gamma, torch.div(step, size, rounding_mode="floor").to(_F64))


class LambdaDecay(LRScheduler):
    """base * lr_lambda(epoch).  Traced best effort, as in the JAX
    package: the lambda gets the step as an f64 tensor and must return
    a tensor computed from it on the device (``jit.TrainStep`` tries it
    on a meta tensor, where any read back to the host fails, and takes
    single steps where it does)."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)

    def _traced(self):
        base, lam = self.base_lr, self.lr_lambda

        def fn(step):
            return base * torch.as_tensor(lam(step.to(_F64))).to(_F64)
        return fn


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1):
        self.lr_lambda = lr_lambda
        self._cur = float(learning_rate)
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        if self.last_epoch > 0:
            self._cur = self._cur * self.lr_lambda(self.last_epoch)
        return self._cur


class CosineAnnealingDecay(LRScheduler):
    """eta_min + (base - eta_min) * (1 + cos(pi * t / T_max)) / 2."""

    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2

    def _traced(self):
        eta, span, t_max = self.eta_min, self.base_lr - self.eta_min, \
            self.T_max
        return lambda step: eta + span * (
            1 + torch.cos(math.pi * step.to(_F64) / t_max)) / 2


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0,
                 last_epoch=-1):
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        t = self.last_epoch
        t_i = self.T_0
        while t >= t_i:
            t -= t_i
            t_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * t / t_i)) / 2


class ReduceOnPlateau(LRScheduler):
    """Scale the rate by ``factor`` once the metric given to ``step``
    has not improved for ``patience`` calls."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0

    def get_lr(self):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        current = float(metrics.item() if hasattr(metrics, "item")
                        else metrics)
        self.last_epoch += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.best is None or self._is_better(current):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0

    def _is_better(self, current):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return current < self.best * (1 - self.threshold)
            return current < self.best - self.threshold
        if self.threshold_mode == "rel":
            return current > self.best * (1 + self.threshold)
        return current > self.best + self.threshold


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        super().__init__(self.initial_lr, last_epoch)

    def _interp(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return (end - start) * pct + start

    def get_lr(self):
        step = min(self.last_epoch, self.total_steps)
        up_steps = int(self.phase_pct * self.total_steps)
        if step <= up_steps:
            return self._interp(self.initial_lr, self.max_lr,
                                step / max(up_steps, 1))
        return self._interp(self.max_lr, self.end_lr,
                            (step - up_steps)
                            / max(self.total_steps - up_steps, 1))


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1):
        self.max_lr = max_learning_rate
        self.step_up = step_size_up
        self.step_down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        self.scale_fn = scale_fn
        self.scale_mode = scale_mode
        super().__init__(base_learning_rate, last_epoch)

    def get_lr(self):
        total = self.step_up + self.step_down
        cycle = math.floor(1 + self.last_epoch / total)
        x = self.last_epoch - (cycle - 1) * total
        pct = x / self.step_up if x <= self.step_up else \
            1 - (x - self.step_up) / self.step_down
        scale = 1.0
        if self.scale_fn is not None:
            arg = cycle if self.scale_mode == "cycle" else self.last_epoch
            scale = self.scale_fn(arg)
        elif self.mode == "triangular2":
            scale = 1 / (2 ** (cycle - 1))
        elif self.mode == "exp_range":
            scale = self.exp_gamma ** self.last_epoch
        return self.base_lr + (self.max_lr - self.base_lr) * pct * scale


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

    def _traced(self):
        base, total = self.base_lr, self.total_steps
        f0, rise = self.start_factor, self.end_factor - self.start_factor
        return lambda step: base * (
            f0 + rise * step.clamp_max(total).to(_F64) / total)


__all__ = ["CosineAnnealingDecay", "CosineAnnealingWarmRestarts",
           "CyclicLR", "ExponentialDecay", "InverseTimeDecay",
           "LRScheduler", "LambdaDecay", "LinearLR", "LinearWarmup",
           "MultiStepDecay", "MultiplicativeDecay", "NaturalExpDecay",
           "NoamDecay", "OneCycleLR", "PiecewiseDecay", "PolynomialDecay",
           "ReduceOnPlateau", "StepDecay"]
