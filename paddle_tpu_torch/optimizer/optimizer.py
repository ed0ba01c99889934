"""Optimizers (port of paddle_tpu/optimizer/optimizer.py: the base, SGD,
Adam and AdamW).

Each optimizer updates every parameter with ``torch._foreach_*`` ops: one
pass over the parameter list, in place, with no host sync (the learning
rate and the step are host numbers the caller already holds).  Under
``multi_precision`` a bf16/f16 parameter keeps an f32 master weight and
f32 moments; the rule runs on the master, and the parameter is then the
master cast to its dtype.  Gradients are cast to the working dtype first.
These are not Pallas kernels in the JAX package (XLA fuses them there),
so torch ops are the port's form of them.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .lr import LRScheduler

_LOW = (torch.bfloat16, torch.float16)


class L2Decay:
    """Coupled L2 regularization: coeff * param added to the gradient."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class Optimizer:
    """Base: parameter list, state slots, master weights, coupled L2
    decay, learning rate and step bookkeeping, state dicts."""

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

    def get_lr(self) -> float:
        """The learning rate: the float given, or the schedule's current
        value."""
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    # ------------------------------------------------------------ state
    def _ensure_state(self, params):
        for slot in self._state_slots:
            acc = self._accumulators.setdefault(slot, {})
            for p in params:
                if id(p) not in acc:
                    dtype = torch.float32 if self._multi_precision \
                        else p.dtype
                    acc[id(p)] = torch.zeros(p.shape, dtype=dtype,
                                             device=p.device)
        if self._multi_precision:
            for p in params:
                if id(p) not in self._master_weights and p.dtype in _LOW:
                    self._master_weights[id(p)] = p.detach().float()

    # ----------------------------------------------------------- update
    def _rule(self, works, grads, states, lr: float, step: int, params):
        """Update ``works`` (and ``states``, slot -> list) in place from
        ``grads``, all lists in the working dtype.  Override."""
        raise NotImplementedError

    @torch.no_grad()
    def _apply_update(self, params, grads, lr: float, step: int) -> None:
        """The fused update of ``params`` from ``grads`` (one each, in the
        param's dtype or the master's) at learning rate ``lr`` and step
        number ``step`` — shared by ``step()`` and ``jit.TrainStep``."""
        if not params:
            return
        self._ensure_state(params)
        masters = [self._master_weights.get(id(p)) for p in params]
        works = [m if m is not None else p.data
                 for p, m in zip(params, masters)]
        grads = [g if g.dtype == w.dtype else g.to(w.dtype)
                 for g, w in zip(grads, works)]
        if isinstance(self.regularization, L2Decay) and \
                self.regularization.coeff != 0.0:
            grads = torch._foreach_add(grads, works,
                                       alpha=self.regularization.coeff)
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
        self._apply_update(params, [g for _, g in pairs], self.get_lr(),
                           self._global_step)

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
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        name_of = self._names()
        by_name = {name_of[id(p)]: p for p in self._parameter_list}
        self._global_step = int(state_dict.get("global_step", 0))
        if "LR_Scheduler" in state_dict and \
                isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for key, value in state_dict.items():
            if key in ("global_step", "LR_Scheduler"):
                continue
            pname, slot = key.rsplit(".", 1)
            p = by_name.get(pname)
            if p is None:
                continue
            t = torch.as_tensor(value).to(p.device).clone()
            if slot == "master_weight":
                self._master_weights[id(p)] = t
            else:
                self._accumulators.setdefault(slot, {})[id(p)] = t


class SGD(Optimizer):
    """param -= lr * grad."""

    def _rule(self, works, grads, states, lr, step, params):
        torch._foreach_add_(works, grads, alpha=-lr)


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

    def _rule(self, works, grads, states, lr, step, params):
        b1, b2 = self._beta1, self._beta2
        m, v = states["moment1"], states["moment2"]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        if self._amsgrad:
            torch._foreach_maximum_(states["moment2_max"], v)
            v = states["moment2_max"]
        bc1 = 1 - b1 ** step
        bc2 = 1 - b2 ** step
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_addcdiv_(works, m, denom, value=-lr / bc1)


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


__all__ = ["Adam", "AdamW", "L2Decay", "Optimizer", "SGD"]
