"""Optimizers (port of paddle_tpu/optimizer/optimizer.py: the base and
every optimizer).

Each optimizer updates every parameter with ``torch._foreach_*`` ops: one
pass over the parameter list, in place, with no host sync.  The learning
rate (f32) and the step number (int32) reach the rule as 0-d tensors on
the parameters' device, and every number computed from them (Adam's
bias corrections, AdamW's decay factor, RAdam's rectification) is
computed there, so a CUDA graph that captured an update replays it
correctly at any later step; only constants of the optimizer
(betas, epsilon, coefficients) are host numbers.  ``torch._foreach_*``
takes a tensor scalar in ``_foreach_mul_``/``_foreach_add_`` but not as
``alpha=``/``value=``, so a step size that depends on the learning rate
multiplies a temporary.  Scalars are computed in f32, as the JAX rules
compute them in the working dtype.

Under ``multi_precision`` a bf16/f16 parameter keeps an f32 master weight
and f32 state; the rule runs on the master, and the parameter is then
the master cast to its dtype.  Gradients are cast to the working dtype
first.  These are not Pallas kernels in the JAX package (XLA fuses them
there), so torch ops are the port's form of them.

``LBFGS`` is host-driven, as in the JAX package: its ``step(closure)``
re-evaluates the loss and gradients and reads numbers back between
them, so it runs outside the graphed train step.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List

import numpy as np
import torch

from .lr import LRScheduler

_LOW = (torch.bfloat16, torch.float16)


class WeightDecayRegularizer:
    """Base regularizer: a coefficient the optimizer folds into the
    gradient before its rule."""

    coeff = 0.0


class L2Decay(WeightDecayRegularizer):
    """Coupled L2 regularization: coeff * param added to the gradient."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay(WeightDecayRegularizer):
    """Coupled L1 regularization: coeff * sign(param) added to the
    gradient."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class Optimizer:
    """Base: parameter list, state slots, master weights, coupled
    weight decay, learning rate (with ``_lr_factor``) and step
    bookkeeping, state dicts."""

    _state_slots: List[str] = []

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided")
        self._parameter_list = list(parameters)
        self._learning_rate = learning_rate
        if isinstance(weight_decay, (int, float)) and \
                not isinstance(weight_decay, bool):
            self.regularization = L2Decay(float(weight_decay))
        else:
            self.regularization = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {}
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._global_step = 0
        # a factor on top of the schedule (a plateau rule scales it, so a
        # reduction works whatever the schedule's shape)
        self._lr_factor = 1.0

    # --------------------------------------------------------------- lr
    def get_lr(self) -> float:
        """The learning rate: the float given, or the schedule's current
        value, times ``_lr_factor``."""
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate()) * self._lr_factor
        return float(self._learning_rate) * self._lr_factor

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when the learning rate is an "
                               "LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler: LRScheduler):
        self._learning_rate = scheduler

    def _traced_schedule(self):
        """The schedule as a device function ``step -> 0-d f64 lr``
        (before ``_lr_factor``, and before the rounding to f32 that
        ``get_lr``'s caller makes), or None for a float rate or a
        schedule that cannot be traced: what ``jit.TrainStep.run_steps``
        reads to choose between the rate computed in its graphs and one
        call a step."""
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate._traced()
        return None

    # ------------------------------------------------------------ state
    def _init_slot(self, slot: str, p: torch.Tensor) -> torch.Tensor:
        dtype = torch.float32 if self._multi_precision else p.dtype
        return torch.zeros(p.shape, dtype=dtype, device=p.device)

    def _ensure_state(self, params):
        for slot in self._state_slots:
            acc = self._accumulators.setdefault(slot, {})
            for p in params:
                if id(p) not in acc:
                    acc[id(p)] = self._init_slot(slot, p)
        if self._multi_precision:
            for p in params:
                if id(p) not in self._master_weights and p.dtype in _LOW:
                    self._master_weights[id(p)] = p.detach().float()

    # ----------------------------------------------------------- update
    def _rule(self, works, grads, states, lr, step, params):
        """Update ``works`` (and ``states``, slot -> list) in place from
        ``grads``, all lists in the working dtype, at learning rate
        ``lr`` (0-d f32) and step number ``step`` (0-d int32), both
        tensors on the parameters' device.  Override."""
        raise NotImplementedError

    def _decay_grads(self, grads, works):
        """Coupled L2 or L1 decay added to the gradients."""
        reg = self.regularization
        if isinstance(reg, L2Decay) and reg.coeff != 0.0:
            return torch._foreach_add(grads, works, alpha=reg.coeff)
        if isinstance(reg, L1Decay) and reg.coeff != 0.0:
            return torch._foreach_add(grads, torch._foreach_sign(works),
                                      alpha=reg.coeff)
        return grads

    @torch.no_grad()
    def _apply_update(self, params, grads, lr, step) -> None:
        """The fused update of ``params`` from ``grads`` (one each, in the
        param's dtype or the master's) at learning rate ``lr`` and step
        number ``step``, 0-d tensors on the parameters' device — shared
        by ``step()`` and ``jit.TrainStep``."""
        if not params:
            return
        self._ensure_state(params)
        masters = [self._master_weights.get(id(p)) for p in params]
        works = [m if m is not None else p.data
                 for p, m in zip(params, masters)]
        grads = [g if g.dtype == w.dtype else g.to(w.dtype)
                 for g, w in zip(grads, works)]
        grads = self._decay_grads(grads, works)
        states = {s: [self._accumulators[s][id(p)] for p in params]
                  for s in self._state_slots}
        self._rule(works, grads, states, lr, step, params)
        low = [(p.data, m) for p, m in zip(params, masters) if m is not None]
        if low:
            torch._foreach_copy_([p for p, _ in low], [m for _, m in low])

    def step(self):
        """Eager update of every trainable parameter that has a grad."""
        params = [p for p in self._parameter_list
                  if p.requires_grad and p.grad is not None]
        if not params:
            return
        pairs = [(p, p.grad) for p in params]
        if self._grad_clip is not None:
            pairs = self._grad_clip(pairs)
        self._global_step += 1
        dev = params[0].device
        self._apply_update(
            params, [g for _, g in pairs],
            torch.tensor(self.get_lr(), dtype=torch.float32, device=dev),
            torch.tensor(self._global_step, dtype=torch.int32, device=dev))

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None

    # ------------------------------------------------------- state dict
    def _names(self):
        return {id(p): getattr(p, "name", None) or f"param_{i}"
                for i, p in enumerate(self._parameter_list)}

    def state_dict(self):
        sd = {}
        name_of = self._names()
        for slot, acc in self._accumulators.items():
            for pid, t in acc.items():
                if pid in name_of:
                    sd[f"{name_of[pid]}.{slot}"] = t
        for pid, t in self._master_weights.items():
            if pid in name_of:
                sd[f"{name_of[pid]}.master_weight"] = t
        sd["global_step"] = self._global_step
        if self._lr_factor != 1.0:
            sd["lr_factor"] = self._lr_factor
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        """Load a ``state_dict()``.  State tensors that exist already are
        written in place (a captured CUDA graph holds their addresses);
        missing ones are created."""
        name_of = self._names()
        by_name = {name_of[id(p)]: p for p in self._parameter_list}
        self._global_step = int(state_dict.get("global_step", 0))
        self._lr_factor = float(state_dict.get("lr_factor", 1.0))
        if "LR_Scheduler" in state_dict and \
                isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for key, value in state_dict.items():
            if key in ("global_step", "LR_Scheduler", "lr_factor"):
                continue
            pname, slot = key.rsplit(".", 1)
            p = by_name.get(pname)
            if p is None:
                continue
            home = self._master_weights if slot == "master_weight" \
                else self._accumulators.setdefault(slot, {})
            value = torch.as_tensor(value)
            if id(p) in home:
                home[id(p)].copy_(value)
            else:
                home[id(p)] = value.to(p.device).clone()


class SGD(Optimizer):
    """param -= lr * grad."""

    def _rule(self, works, grads, states, lr, step, params):
        torch._foreach_sub_(works, torch._foreach_mul(grads, lr))


class Momentum(Optimizer):
    """v = mu * v + g; param -= lr * v, or lr * (g + mu * v) with
    Nesterov."""

    _state_slots = ["velocity"]

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _rule(self, works, grads, states, lr, step, params):
        v = states["velocity"]
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, grads)
        if self._use_nesterov:
            upd = torch._foreach_add(grads, torch._foreach_mul(
                v, self._momentum))
            torch._foreach_mul_(upd, lr)
        else:
            upd = torch._foreach_mul(v, lr)
        torch._foreach_sub_(works, upd)


def _bias_correction(beta, stepf):
    """1 - beta ** step, a 0-d f32 tensor (beta rounded to f32, as JAX
    rounds it to the working dtype)."""
    return 1 - torch.pow(beta, stepf)


class Adam(Optimizer):
    """Adam with bias correction (and AMSGrad's running max of v)."""

    _state_slots = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, amsgrad=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._amsgrad = amsgrad
        if amsgrad:
            self._state_slots = ["moment1", "moment2", "moment2_max"]

    def _moments(self, grads, states):
        """m = b1 m + (1 - b1) g and v = b2 v + (1 - b2) g^2, in place."""
        b1, b2 = self._beta1, self._beta2
        m, v = states["moment1"], states["moment2"]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        return m, v

    def _rule(self, works, grads, states, lr, step, params):
        m, v = self._moments(grads, states)
        if self._amsgrad:
            torch._foreach_maximum_(states["moment2_max"], v)
            v = states["moment2_max"]
        stepf = step.float()
        denom = torch._foreach_div(v, _bias_correction(self._beta2, stepf))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        # param += m / (denom / (-lr / (1 - b1^t))): the step size folded
        # into the denominator saves a pass over the moments
        torch._foreach_div_(denom, -lr / _bias_correction(self._beta1,
                                                           stepf))
        torch._foreach_addcdiv_(works, m, denom)


class AdamW(Adam):
    """Adam with decoupled weight decay: before the Adam rule, every
    parameter that ``apply_decay_param_fun(name)`` keeps (all of them
    when it is None) is scaled by 1 - lr * coeff.  ``name`` is the
    parameter's ``name`` attribute, ``''`` where none is set, as the JAX
    package passes ``p.name`` (``param_<i>`` names only state-dict
    keys)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False, amsgrad=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, multi_precision, amsgrad)
        self._coeff = float(getattr(weight_decay, "coeff", weight_decay))
        self._apply_decay_param_fun = apply_decay_param_fun

    def _rule(self, works, grads, states, lr, step, params):
        if self._coeff:
            fun = self._apply_decay_param_fun
            decay = [w for w, p in zip(works, params)
                     if fun is None or fun(getattr(p, "name", None) or "")]
            if decay:
                torch._foreach_mul_(decay, 1 - lr * self._coeff)
        super()._rule(works, grads, states, lr, step, params)


class Adamax(Optimizer):
    """m = b1 m + (1 - b1) g; u = max(b2 u, |g|);
    param -= lr / (1 - b1^t) * m / (u + eps)."""

    _state_slots = ["moment", "inf_norm"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _rule(self, works, grads, states, lr, step, params):
        m, u = states["moment"], states["inf_norm"]
        torch._foreach_mul_(m, self._beta1)
        torch._foreach_add_(m, grads, alpha=1 - self._beta1)
        torch._foreach_mul_(u, self._beta2)
        torch._foreach_maximum_(u, torch._foreach_abs(grads))
        size = lr / _bias_correction(self._beta1, step.float())
        upd = torch._foreach_mul(m, size)
        torch._foreach_div_(upd, torch._foreach_add(u, self._epsilon))
        torch._foreach_sub_(works, upd)


class Adagrad(Optimizer):
    """mom += g^2; param -= lr * g / (sqrt(mom) + eps)."""

    _state_slots = ["moment"]

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _init_slot(self, slot, p):
        return super()._init_slot(slot, p).fill_(self._initial)

    def _rule(self, works, grads, states, lr, step, params):
        mom = states["moment"]
        torch._foreach_addcmul_(mom, grads, grads)
        denom = torch._foreach_sqrt(mom)
        torch._foreach_add_(denom, self._epsilon)
        upd = torch._foreach_mul(grads, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(works, upd)


class Adadelta(Optimizer):
    """E[g^2] and E[dx^2] running averages (rho); the step
    sqrt(E[dx^2] + eps) / sqrt(E[g^2] + eps) * g, scaled by lr."""

    _state_slots = ["avg_squared_grad", "avg_squared_update"]

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._epsilon, self._rho = epsilon, rho

    def _rule(self, works, grads, states, lr, step, params):
        rho, eps = self._rho, self._epsilon
        sq, sq_u = states["avg_squared_grad"], states["avg_squared_update"]
        torch._foreach_mul_(sq, rho)
        torch._foreach_addcmul_(sq, grads, grads, value=1 - rho)
        upd = torch._foreach_add(sq_u, eps)
        torch._foreach_sqrt_(upd)
        den = torch._foreach_add(sq, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, grads)
        torch._foreach_mul_(sq_u, rho)
        torch._foreach_addcmul_(sq_u, upd, upd, value=1 - rho)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(works, upd)


class RMSProp(Optimizer):
    """ms = rho ms + (1 - rho) g^2 (centered: minus the running mean of g
    squared); mom = momentum mom + lr g / sqrt(ms + eps);
    param -= mom."""

    _state_slots = ["mean_square", "mean_grad", "momentum"]

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _rule(self, works, grads, states, lr, step, params):
        rho = self._rho
        ms, mg, mom = (states[s] for s in self._state_slots)
        torch._foreach_mul_(ms, rho)
        torch._foreach_addcmul_(ms, grads, grads, value=1 - rho)
        if self._centered:
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, grads, alpha=1 - rho)
            denom = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
            torch._foreach_add_(denom, self._epsilon)
        else:
            denom = torch._foreach_add(ms, self._epsilon)
        torch._foreach_sqrt_(denom)
        upd = torch._foreach_mul(grads, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(mom, self._momentum)
        torch._foreach_add_(mom, upd)
        torch._foreach_sub_(works, mom)


class Lamb(Optimizer):
    """Adam's direction plus decoupled decay, r = mhat / (sqrt(vhat) +
    eps) + wd * param, scaled per parameter by the trust ratio
    ||param|| / ||r|| (1 where either is 0).  A parameter whose name
    ``exclude_from_weight_decay_fn`` accepts takes no decay (the JAX
    package keeps the function and decays every parameter)."""

    _state_slots = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    _moments = Adam._moments

    def _rule(self, works, grads, states, lr, step, params):
        m, v = self._moments(grads, states)
        stepf = step.float()
        r = torch._foreach_div(m, _bias_correction(self._beta1, stepf))
        denom = torch._foreach_div(v, _bias_correction(self._beta2, stepf))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_div_(r, denom)
        fun = self._exclude_fn
        decay = [(ri, w) for ri, w, p in zip(r, works, params)
                 if fun is None or not fun(getattr(p, "name", None) or "")]
        if decay and self._lamb_wd:
            torch._foreach_add_([ri for ri, _ in decay],
                                [w for _, w in decay], alpha=self._lamb_wd)
        w_norm = torch.stack(torch._foreach_norm(works))
        r_norm = torch.stack(torch._foreach_norm(r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        torch._foreach_mul_(r, list((lr * trust).unbind()))
        torch._foreach_sub_(works, r)


class ASGD(Optimizer):
    """The JAX package's ASGD: the SGD step, with its ``d`` and ``ys``
    slots kept (and left at zero)."""

    _state_slots = ["d", "ys"]

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    _rule = SGD._rule


class Rprop(Optimizer):
    """Resilient propagation: each entry's own step ``lr_t`` (f32, from
    the rate at construction) grows by eta+ while the gradient keeps its
    sign and shrinks by eta- when it flips (that gradient then counts as
    0), clipped to ``learning_rate_range``; param -= lr_t * sign(g)."""

    _state_slots = ["prev_grad", "lr_t"]

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._lr_range = learning_rate_range
        self._etas = etas

    def _init_slot(self, slot, p):
        value = self.get_lr() if slot == "lr_t" else 0.0
        return torch.full(p.shape, value, dtype=torch.float32,
                          device=p.device)

    def _rule(self, works, grads, states, lr, step, params):
        # per tensor: torch has no foreach select
        eta_minus, eta_plus = self._etas
        lo, hi = self._lr_range
        for w, g, prev, lr_t in zip(works, grads, states["prev_grad"],
                                    states["lr_t"]):
            sign = torch.sign(g * prev)
            factor = torch.where(sign > 0, eta_plus,
                                 torch.where(sign < 0, eta_minus, 1.0))
            lr_t.copy_(torch.clamp(lr_t * factor, lo, hi))
            g = torch.where(sign < 0, 0.0, g)
            w.sub_((lr_t * torch.sign(g)).to(w.dtype))
            prev.copy_(g)


class NAdam(Optimizer):
    """Adam with Nesterov momentum through the momentum-decay schedule
    mu_t = b1 (1 - 0.5 * 0.96^(t psi)) and its running product
    (``mu_product``, a 0-d f32 per parameter)."""

    _state_slots = ["moment1", "moment2", "mu_product"]

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2 = beta1, beta2
        self._epsilon = epsilon
        self._momentum_decay = momentum_decay

    def _init_slot(self, slot, p):
        if slot == "mu_product":
            return torch.ones((), dtype=torch.float32, device=p.device)
        return super()._init_slot(slot, p)

    _moments = Adam._moments

    def _rule(self, works, grads, states, lr, step, params):
        b1, psi = self._beta1, self._momentum_decay
        t = step.float()
        mu_t = b1 * (1 - 0.5 * torch.pow(0.96, t * psi))
        mu_t1 = b1 * (1 - 0.5 * torch.pow(0.96, (t + 1) * psi))
        prods = states["mu_product"]
        torch._foreach_mul_(prods, mu_t)
        prod = torch.stack(prods)
        m, v = self._moments(grads, states)
        upd = torch._foreach_mul(m, mu_t1)
        torch._foreach_div_(upd, list((1 - prod * mu_t1).unbind()))
        cur = torch._foreach_mul(grads, 1 - mu_t)
        torch._foreach_div_(cur, list((1 - prod).unbind()))
        torch._foreach_add_(upd, cur)
        denom = torch._foreach_div(v, _bias_correction(self._beta2, t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_mul_(upd, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(works, upd)


class RAdam(Optimizer):
    """Rectified Adam: while the variance estimate is untrustworthy
    (rho_t <= 5) the step is lr * mhat, unadapted; after, Adam's step
    times the rectification.  The branch is a select on the device: one
    of the two step sizes is 0."""

    _state_slots = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2 = beta1, beta2
        self._epsilon = epsilon

    _moments = Adam._moments

    def _rule(self, works, grads, states, lr, step, params):
        # the constants in f32, as JAX computes them from an f32 beta2
        one = np.float32(1)
        rho_inf = 2 * one / (one - np.float32(self._beta2)) - one
        inf_den = float((rho_inf - 4 * one) * (rho_inf - 2 * one))
        rho_inf = float(rho_inf)
        t = step.float()
        b2_t = torch.pow(self._beta2, t)
        rho_t = rho_inf - 2.0 * t * b2_t / (1 - b2_t)
        r_num = (rho_t - 4) * (rho_t - 2) * rho_inf
        r_den = inf_den * rho_t
        rect = torch.sqrt(torch.clamp_min(r_num / r_den, 0.0))
        adapt = rho_t > 5.0
        m, v = self._moments(grads, states)
        mhat = torch._foreach_div(m, _bias_correction(self._beta1, t))
        vhat = torch._foreach_div(v, 1 - b2_t)
        torch._foreach_sqrt_(vhat)
        torch._foreach_add_(vhat, self._epsilon)
        adapted = torch._foreach_mul(mhat, torch.where(adapt, lr * rect, 0.0))
        torch._foreach_div_(adapted, vhat)
        torch._foreach_mul_(mhat, torch.where(adapt, 0.0, lr))
        torch._foreach_add_(adapted, mhat)
        torch._foreach_sub_(works, adapted)


class LBFGS(Optimizer):
    """Limited-memory BFGS with an optional strong-Wolfe line search
    (the JAX package's ``LBFGS``).  ``step(closure)`` calls ``closure``
    (which clears the gradients, computes the loss and calls
    ``backward``) as often as the iteration needs, up to ``max_eval``
    (default ``max_iter * 5 // 4``) evaluations.

    The curvature math runs on flat f32 vectors of the trainable
    parameters (``_flat``); ``_gather`` applies the optimizer's
    ``grad_clip`` and its coupled L1/L2 decay to the gradients first,
    since this optimizer bypasses the fused update that applies them
    elsewhere.  The two-loop recursion floors y.s and y.y at 1e-10; the
    history of (s, y) pairs is a ``deque(maxlen=history_size)``.  The
    line search tries at most 10 step sizes, halving on too little
    decrease and doubling on too steep a slope.  As in the JAX package,
    when all 10 tries fail the step size has been halved or doubled once
    more after the last evaluation: the parameters stay at the last point
    evaluated (its loss and gradient are the iteration's), but the
    stored step ``s`` and the next iteration's start are ``x0 + t * d``
    with the changed size."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False)
        self.max_iter = max_iter
        self.max_eval = max_eval if max_eval is not None \
            else max_iter * 5 // 4
        self.tol_grad = tolerance_grad
        self.tol_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s = deque(maxlen=history_size)
        self._y = deque(maxlen=history_size)

    @staticmethod
    def _flat(tensors):
        return torch.cat([t.detach().reshape(-1).float() for t in tensors])

    @staticmethod
    @torch.no_grad()
    def _unflatten_to_params(flat, params):
        off = 0
        for p in params:
            n = p.numel()
            p.copy_(flat[off:off + n].view_as(p).to(p.dtype))
            off += n

    def _gather(self, params):
        """The flat parameters and gradients, the gradients clipped and
        with the coupled decay added."""
        grads = [p.grad for p in params]
        if self._grad_clip is not None:
            pg = [(p, g) for p, g in zip(params, grads) if g is not None]
            clipped = {id(p): g for p, g in self._grad_clip(pg)}
            grads = [clipped.get(id(p), g) for p, g in zip(params, grads)]
        x = self._flat(params)
        g = self._flat([g if g is not None else torch.zeros_like(p)
                        for p, g in zip(params, grads)])
        reg = self.regularization
        if isinstance(reg, L1Decay):
            g = g + reg.coeff * torch.sign(x)
        elif isinstance(reg, L2Decay):
            g = g + reg.coeff * x
        return x, g

    def _direction(self, g):
        """The two-loop recursion over the stored (s, y) pairs."""
        q = g
        alphas = []
        for s, y in reversed(list(zip(self._s, self._y))):
            rho = 1.0 / torch.clamp_min(torch.dot(y, s), 1e-10)
            a = rho * torch.dot(s, q)
            alphas.append((a, rho, s, y))
            q = q - a * y
        if self._s:
            s, y = self._s[-1], self._y[-1]
            q = q * (torch.dot(s, y)
                     / torch.clamp_min(torch.dot(y, y), 1e-10))
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return -q

    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure that recomputes "
                             "the loss and gradients")
        params = [p for p in self._parameter_list if p.requires_grad]
        loss = closure()
        x0, g = self._gather(params)
        if float(g.abs().max()) <= self.tol_grad:
            return loss
        n_evals = 1
        for _ in range(self.max_iter):
            d = self._direction(g)
            lr = float(self.get_lr())
            t = lr
            f0 = float(loss.detach())
            gtd = float(torch.dot(g, d))
            if self.line_search_fn == "strong_wolfe":
                c1, c2 = 1e-4, 0.9
                for _ls in range(10):
                    self._unflatten_to_params(x0 + t * d, params)
                    self.clear_grad()
                    loss_t = closure()
                    n_evals += 1
                    _, g_t = self._gather(params)
                    if float(loss_t.detach()) > f0 + c1 * t * gtd:
                        t *= 0.5
                        continue
                    if abs(float(torch.dot(g_t, d))) > c2 * abs(gtd):
                        t *= 2.0
                        continue
                    break
                loss, g_new = loss_t, g_t
                x_new = x0 + t * d
            else:
                x_new = x0 + t * d
                self._unflatten_to_params(x_new, params)
                self.clear_grad()
                loss = closure()
                n_evals += 1
                _, g_new = self._gather(params)
            s = x_new - x0
            ygrad = g_new - g
            if float(torch.dot(s, ygrad)) > 1e-10:
                self._s.append(s)
                self._y.append(ygrad)
            if float(g_new.abs().max()) <= self.tol_grad:
                break
            if float(s.abs().max()) <= self.tol_change:
                break
            if n_evals >= self.max_eval:
                break
            x0, g = x_new, g_new
        return loss


__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "AdamW", "Adamax",
           "L1Decay", "L2Decay", "LBFGS", "Lamb", "Momentum", "NAdam",
           "Optimizer", "RAdam", "RMSProp", "Rprop", "SGD",
           "WeightDecayRegularizer"]
