"""One training step: forward, loss, backward and the optimizer update
(port of paddle_tpu/jit/train_step.py ``TrainStep``).

Where the JAX package traces the whole step into one donated-buffer XLA
program, the port runs it eagerly: autograd for the backward (the flash
attention, RMSNorm and RoPE gradients are the ops' own autograd
Functions, with kernels on the card), then the optimizer's one-pass
``torch._foreach_*`` update in place.  The parameters live in the model
the whole time, so ``sync()`` has nothing to write back.  Nothing reads a
device value on the host: the loss comes back as a device tensor.

Usage::

    step = TrainStep(model, loss_fn, optimizer)     # loss_fn(out, *labels)
    loss = step(inputs, labels)
"""
from __future__ import annotations

from typing import Callable

import torch

from ..optimizer.lr import LRScheduler


def _as_tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


class TrainStep:
    """``model`` forward on ``inputs``, ``loss_fn(outputs, *labels)``,
    backward, gradient clipping (the optimizer's ``grad_clip``) and the
    optimizer update.

    With ``accumulate_steps`` k > 1 the gradients of k calls are summed —
    in f32 wherever a master weight exists, so small micro-gradients are
    not rounded away in bf16 — and every k-th call applies their mean
    (``accumulate_avg``) or sum, cast back to the parameter's dtype, then
    clipped, as the JAX step does.  The optimizer's step counter advances
    before an update and only on a call that applies one; the learning
    rate is the optimizer's (its scheduler's current value), read once
    per call.  Parameters with ``requires_grad=False`` are left alone."""

    def __init__(self, model, loss_fn: Callable, optimizer,
                 accumulate_steps: int = 1, accumulate_avg: bool = True):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.accumulate_steps = int(accumulate_steps)
        self.accumulate_avg = bool(accumulate_avg)
        if self.accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got "
                             f"{accumulate_steps}")
        self._train_params = [p for p in model.parameters()
                              if p.requires_grad]
        optimizer._ensure_state(self._train_params)
        masters = [optimizer._master_weights.get(id(p))
                   for p in self._train_params]
        self._grad_accum = [
            torch.zeros_like(m if m is not None else p.detach())
            for p, m in zip(self._train_params, masters)] \
            if self.accumulate_steps > 1 else []
        self._micro_step = 0

    def _grads(self):
        """Each trainable parameter's gradient, taken off the parameter
        (a parameter the loss does not reach gets zeros)."""
        grads = []
        for p in self._train_params:
            g = p.grad
            p.grad = None
            grads.append(g if g is not None else torch.zeros_like(p))
        return grads

    def _clip(self, grads):
        clip = self.optimizer._grad_clip
        if clip is None:
            return grads
        return [g for _, g in clip(list(zip(self._train_params, grads)))]

    def __call__(self, inputs, labels=()):
        """One step; returns the f32 loss as a device tensor (no host
        sync unless the caller reads it)."""
        opt = self.optimizer
        k = self.accumulate_steps
        self._micro_step += 1
        apply_now = self._micro_step % k == 0
        if apply_now:
            opt._global_step += 1
        lr = opt.get_lr()
        for p in self._train_params:
            p.grad = None
        outputs = self.model(*_as_tuple(inputs))
        loss = self.loss_fn(outputs, *_as_tuple(labels)).float()
        loss.backward()
        grads = self._grads()
        if k == 1:
            opt._apply_update(self._train_params, self._clip(grads), lr,
                              opt._global_step)
        else:
            with torch.no_grad():
                torch._foreach_add_(self._grad_accum, grads)
                if apply_now:
                    denom = k if self.accumulate_avg else 1
                    avg = [(a / denom).to(p.dtype) for a, p in
                           zip(self._grad_accum, self._train_params)]
                    opt._apply_update(self._train_params, self._clip(avg),
                                      lr, opt._global_step)
                    torch._foreach_zero_(self._grad_accum)
        return loss.detach()

    def run_steps(self, batches):
        """K single steps in a row over ``batches``, a non-empty sequence
        of ``(inputs, labels)`` pairs, advancing the learning-rate
        schedule once after each (the JAX ``run_steps`` contract).
        Returns the (K,) f32 loss vector on the device; its numbers equal
        K single calls."""
        lr = self.optimizer._learning_rate
        sched = lr if isinstance(lr, LRScheduler) else None
        losses = []
        for inputs, labels in batches:
            losses.append(self(inputs, labels))
            if sched is not None:
                sched.step()
        return torch.stack(losses)

    def sync(self):
        """Kept for parity with the JAX API: the port's parameters live in
        the model, so there is nothing to write back."""
