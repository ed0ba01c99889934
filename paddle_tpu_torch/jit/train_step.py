"""One training step: forward, loss, backward and the optimizer update
(port of paddle_tpu/jit/train_step.py ``TrainStep``).

The JAX package traces the whole step into one donated-buffer XLA
program, and ``run_steps`` into one ``lax.scan`` that computes the
learning rate and the step number inside the program.  The port's
counterpart on a card is a CUDA graph: ``TrainStep`` captures the step
once for each input signature and replays it, with the learning rate and
the step number read from a device buffer.  On the CPU the same body runs
eagerly; that is ``EagerTrainStep``, which is also the card's yardstick
for the graphs.  The body: autograd for the backward (the flash
attention, RMSNorm and RoPE gradients are the ops' own autograd
Functions, with kernels on the card), gradient clipping, then the
optimizer's one-pass ``torch._foreach_*`` update in place.  The
parameters live in the model the whole time, so ``sync()`` has nothing
to write back.  Nothing reads a device value on the host: the loss
comes back as a device tensor.

Usage::

    step = TrainStep(model, loss_fn, optimizer)     # loss_fn(out, *labels)
    loss = step(inputs, labels)
    losses = step.run_steps([(inputs, labels), ...])
"""
from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch

from .. import amp
from .._device import Upload as _Upload
from ..cuda_graphs import capture
from ..optimizer.lr import LRScheduler


def _as_tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


class EagerTrainStep:
    """``model`` forward on ``inputs``, ``loss_fn(outputs, *labels)``,
    backward, gradient clipping (the optimizer's ``grad_clip``) and the
    optimizer update, run eagerly.

    With ``accumulate_steps`` k > 1 the gradients of k calls are summed —
    in f32 wherever a master weight exists, so small micro-gradients are
    not rounded away in bf16 — and every k-th call applies their mean
    (``accumulate_avg``) or sum, cast back to the parameter's dtype, then
    clipped, as the JAX step does.  The optimizer's step counter advances
    before an update and only on a call that applies one; the learning
    rate is the optimizer's ``get_lr()`` (its scheduler's current value
    times ``_lr_factor``), read once per call.  Both reach the body as
    0-d tensors of one device buffer (lr f32, step int32), written by one
    copy a call.  Parameters with ``requires_grad=False`` are left
    alone.  The model's buffers are the forward's: a batch norm in
    training updates its running ``_mean`` / ``_variance`` in place on
    every call (the JAX package's compiled step skips that update; its
    eager forward makes it, and so does the port here and in the graphs).

    ``amp_level`` other than "O0" runs ``model(*inputs)`` — the forward
    only; ``loss_fn`` runs outside it, as in the JAX package — under
    ``amp.auto_cast(level=amp_level, dtype=amp_dtype)``.

    An optimizer set to offload (``distributed.group_sharded_parallel(...,
    offload=True)``) keeps its state and masters in pinned host memory;
    the update moves them through the device a group at a time
    (``Optimizer._apply_update``), and ``TrainStep``'s graphs capture
    those copies.  The gradient sums of ``accumulate_steps`` stay on the
    device."""

    def __init__(self, model, loss_fn: Callable, optimizer,
                 amp_level: str = "O0", amp_dtype: str = "bfloat16",
                 accumulate_steps: int = 1, accumulate_avg: bool = True):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.amp_level = amp_level
        self.amp_dtype = amp_dtype
        self.accumulate_steps = int(accumulate_steps)
        self.accumulate_avg = bool(accumulate_avg)
        if self.accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got "
                             f"{accumulate_steps}")
        self._train_params = [p for p in model.parameters()
                              if p.requires_grad]
        self._device = next(model.parameters()).device
        optimizer._ensure_state(self._train_params)
        masters = [optimizer._master_weights.get(id(p))
                   for p in self._train_params]
        # on the parameters' device, where an offloaded master is not
        self._grad_accum = [
            torch.zeros(p.shape, device=p.device,
                        dtype=p.dtype if m is None else m.dtype)
            for p, m in zip(self._train_params, masters)] \
            if self.accumulate_steps > 1 else []
        self._micro_step = 0
        dev = self._device
        self._upload = _Upload(dev)
        # a call's learning rate (f32 bits) and step number
        self._scalars = torch.zeros(2, dtype=torch.int32, device=dev)
        self._lr = self._scalars[0:1].view(torch.float32)[0]
        self._step = self._scalars[1]
        # run_steps: micro step, optimizer step and schedule step before
        # the run, the micro step within it, then (as f64 bits) the
        # optimizer's _lr_factor and its rate for a constant schedule
        self._fused = torch.zeros(6, dtype=torch.int64, device=dev)
        self._sched_fn_cache = None

    # ------------------------------------------------------------- body
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

    def _cast_ctx(self):
        """The amp context the forward runs in."""
        if self.amp_level and self.amp_level != "O0":
            return amp.auto_cast(level=self.amp_level, dtype=self.amp_dtype)
        return contextlib.nullcontext()

    def _body(self, inputs, labels, apply_now: bool):
        """One micro step on the device: the f32 loss, gradients summed
        or applied at the rate and step in ``_scalars``."""
        k = self.accumulate_steps
        for p in self._train_params:
            p.grad = None
        with self._cast_ctx():
            outputs = self.model(*inputs)
        loss = self.loss_fn(outputs, *labels).float()
        loss.backward()
        grads = self._grads()
        with torch.no_grad():
            if k > 1:
                torch._foreach_add_(self._grad_accum, grads)
                if not apply_now:
                    return loss.detach()
                denom = k if self.accumulate_avg else 1
                grads = [(a / denom).to(p.dtype) for a, p in
                         zip(self._grad_accum, self._train_params)]
            self.optimizer._apply_update(self._train_params,
                                         self._clip(grads), self._lr,
                                         self._step)
            if k > 1:
                torch._foreach_zero_(self._grad_accum)
        return loss.detach()

    def _execute(self, inputs, labels, apply_now: bool):
        """Run the body over a micro step's tensors: eagerly."""
        return self._body(inputs, labels, apply_now)

    def _schedule_body(self, fn):
        """The rate and step number of micro step ``i`` of a run_steps
        call, into ``_scalars``, from the run's counters in ``_fused``
        (JAX ``scan_steps``): the rate is ``fn(sched0 + i) * lr_factor``
        in f64, rounded once to f32 as ``get_lr()`` is (the constant rate
        where ``fn`` is None); the step ``g0 + micro // k - micro0 // k``;
        then ``i`` advances."""
        f = self._fused
        micro0, g0, sched0, i = f[0], f[1], f[2], f[3]
        factor, lr_op = f[4:6].view(torch.float64).unbind()
        k = self.accumulate_steps
        micro = micro0 + i + 1
        self._step.copy_(g0 + torch.div(micro, k, rounding_mode="floor")
                         - torch.div(micro0, k, rounding_mode="floor"))
        self._lr.copy_(lr_op if fn is None else fn(sched0 + i) * factor)
        i.add_(1)

    def _run_schedule(self, fn):
        self._schedule_body(fn)

    # ------------------------------------------------------------- call
    def __call__(self, inputs, labels=()):
        """One step; returns the f32 loss as a device tensor (no host
        sync unless the caller reads it)."""
        opt = self.optimizer
        self._micro_step += 1
        apply_now = self._micro_step % self.accumulate_steps == 0
        if apply_now:
            opt._global_step += 1
        values = np.zeros(2, np.int32)
        values.view(np.float32)[0] = opt.get_lr()
        values[1] = opt._global_step
        self._upload(self._scalars, values)
        return self._execute(_as_tuple(inputs), _as_tuple(labels),
                             apply_now)

    # ----------------------------------------------------- K-step runs
    def _sched(self):
        """The optimizer's LRScheduler, or None for a float rate."""
        lr = self.optimizer._learning_rate
        return lr if isinstance(lr, LRScheduler) else None

    def _sched_fingerprint(self):
        """Identity and hyperparameters of the schedule, nested ones
        included (JAX ``_sched_fingerprint``): what a traced schedule
        bakes in, so a schedule swapped or edited in place is traced
        anew.  ``last_epoch`` and ``last_lr`` are run-time operands."""

        def fp(sched):
            hyper = tuple(sorted(
                (k, repr(v)) for k, v in sched.state_dict().items()
                if k not in ("last_epoch", "last_lr")))
            nested = tuple(sorted(
                (k, fp(v)) for k, v in vars(sched).items()
                if isinstance(v, LRScheduler)))
            return (id(sched), hyper, nested)

        sched = self._sched()
        return None if sched is None else fp(sched)

    def _traced_sched_fn(self):
        """The optimizer's traced schedule (``step -> f64``), tried once
        on a meta tensor, where a value read back to the host fails; None
        when there is none or it fails (the single-step path)."""
        key = self._sched_fingerprint()
        if self._sched_fn_cache is not None and \
                self._sched_fn_cache[0] == key:
            return self._sched_fn_cache[1]
        fn = self.optimizer._traced_schedule()
        if fn is not None:
            try:
                out = fn(torch.zeros((), dtype=torch.int64, device="meta"))
                ok = isinstance(out, torch.Tensor) and out.dim() == 0 \
                    and out.device.type == "meta"
            except Exception:   # noqa: BLE001 — a user lambda may raise
                ok = False      # anything; it is then not traceable
            fn = fn if ok else None
        self._sched_fn_cache = (key, fn)
        return fn

    @property
    def fused_supported(self) -> bool:
        """True when ``run_steps`` computes the rate on the device (a
        constant rate, or a schedule whose traced form works); False
        means k single calls, each followed by ``sched.step()``."""
        return self._sched() is None or self._traced_sched_fn() is not None

    def run_steps(self, batches, k=None):
        """k micro steps over ``batches``, a sequence of ``(inputs,
        labels)`` pairs each as ``__call__`` takes them, all of one
        structure, shape and dtype; the schedule advances once after each
        (the JAX ``run_steps`` contract).  Returns the (k,) f32 losses on
        the device, with no host sync; its numbers equal k single calls.

        Where ``fused_supported``, the batches are stacked on the device
        once and each micro step's rate and optimizer step number are
        computed on the device from a counter (``_schedule_body``); the
        host's counters and the schedule are brought up to date after the
        run.  Otherwise each micro step is a single call."""
        batches = list(batches)
        if k is None:
            k = len(batches)
        if k != len(batches) or k < 1:
            raise ValueError(f"k ({k}) must equal the number of batches "
                             f"({len(batches)}) and be >= 1")
        if any(not (isinstance(b, (tuple, list)) and len(b) == 2)
               for b in batches):
            raise ValueError("run_steps takes a sequence of (inputs, "
                             "labels) pairs")
        sched = self._sched()
        if not self.fused_supported:
            losses = []
            for inputs, labels in batches:
                losses.append(self(inputs, labels))
                if sched is not None:
                    sched.step()
            return torch.stack(losses)
        pairs = [tuple(tuple(map(torch.as_tensor, _as_tuple(x)))
                       for x in b) for b in batches]
        if len({(len(ins),) + tuple((t.shape, t.dtype) for t in ins + labs)
                for ins, labs in pairs}) != 1:
            raise ValueError("all run_steps batches must share one "
                             "structure, shape and dtype")
        n_in = len(pairs[0][0])
        stacks = [torch.stack([(ins + labs)[j] for ins, labs in pairs])
                  .to(self._device) for j in range(len(sum(pairs[0], ())))]
        opt, K = self.optimizer, self.accumulate_steps
        micro0 = self._micro_step
        values = np.zeros(6, np.int64)
        values[:3] = (micro0, opt._global_step,
                      0 if sched is None else sched.last_epoch)
        values.view(np.float64)[4:] = (opt._lr_factor,
                                       np.float32(opt.get_lr()))
        self._upload(self._fused, values)
        fn = self._traced_sched_fn()
        losses = []
        for i in range(k):
            self._run_schedule(fn)
            batch = tuple(s[i] for s in stacks)
            losses.append(self._execute(batch[:n_in], batch[n_in:],
                                        (micro0 + i + 1) % K == 0))
        self._micro_step += k
        opt._global_step += (micro0 + k) // K - micro0 // K
        if sched is not None:
            for _ in range(k):
                sched.step()
        return torch.stack(losses)

    def sync(self):
        """Kept for parity with the JAX API: the port's parameters live in
        the model, so there is nothing to write back."""


class TrainStep(EagerTrainStep):
    """The training step, as CUDA graphs when the model lives on a card:
    the port's counterpart of the JAX ``TrainStep``'s compiled program.

    It keeps one ``torch.cuda.CUDAGraph`` per key — the shapes and dtypes
    of the input and label tensors, the amp state the forward runs under
    (``amp_level`` and ``amp_dtype``, or the caller's ``auto_cast`` at
    O0: a graph captured at one level is never replayed at another),
    and whether the call applies the
    update (with ``accumulate_steps`` k > 1, accumulating and applying are
    two graphs: JAX's ``lax.cond`` as two captures) — and one for
    ``run_steps``' rate and step computation per schedule.  All draw on
    one memory pool.  The first call of a key runs its body eagerly on a
    side stream (that call is the step, and it builds every kernel and
    warms the stream) and then captures the body, which executes
    nothing; later calls copy their tensors into the key's static
    buffers and replay.  A replay returns a copy of the graph's loss, so
    a loss returned earlier is not overwritten.

    A graph holds the addresses of the parameters, the model's buffers
    (a batch norm's running statistics, which every replay updates in
    place as the eager step does), the optimizer's state and master
    weights (``set_state_dict`` writes them in place) and the static
    buffers, and bakes in the optimizer's constants and the model's
    structure: nothing may rebind one of them after a capture
    (``load_state_dict`` copies into them; ``model.to(...)`` or assigning
    a new tensor to a buffer does not).  ``captures`` and ``replays`` count graphs; a
    replay adds its capture's launches to every kernel wrapper's
    ``launches`` (the capture's own count is taken back: it launched
    nothing).  Graphs sharing the pool may run in any order because no
    graph's output outlives the call that replays it.  There is no
    fallback: a capture or replay that fails raises (a key's first call
    has then made its step eagerly).  On the CPU this is
    ``EagerTrainStep``."""

    def __init__(self, model, loss_fn: Callable, optimizer,
                 amp_level: str = "O0", amp_dtype: str = "bfloat16",
                 accumulate_steps: int = 1, accumulate_avg: bool = True):
        super().__init__(model, loss_fn, optimizer, amp_level, amp_dtype,
                         accumulate_steps, accumulate_avg)
        self.captures = 0
        self.replays = 0
        self._graphed = self._device.type == "cuda"
        # key -> (graph, {kernel wrapper: launches a replay}, output)
        self._graphs = {}
        # tensor signature -> static input and label buffers
        self._buffers = {}
        if self._graphed:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self._device)

    def _graph(self, key, body):
        """``body()`` through the key's graph: a replay, or on the key's
        first call the body itself, eagerly on the capture stream, and
        then its capture.  Returns the body's output (on a replay, a copy
        of the graph's, which the next replay overwrites)."""
        entry = self._graphs.get(key)
        if entry is not None:
            graph, launches, out = entry
            graph.replay()
            for fn, n in launches.items():
                fn.launches += n
            self.replays += 1
            return None if out is None else out.clone()
        here = torch.cuda.current_stream(self._device)
        self._stream.wait_stream(here)
        with torch.cuda.stream(self._stream):
            result = body()
        here.wait_stream(self._stream)
        if isinstance(result, torch.Tensor):
            result.record_stream(here)
        graph = torch.cuda.CUDAGraph()
        out, launches = capture(graph, self._pool, self._stream, body,
                                self._generators())
        self._graphs[key] = (graph, launches, out)
        self.captures += 1
        return result

    def _generators(self):
        """The CUDA generators the model's modules draw from (a module's
        ``generator`` attribute, as the MoE gates' random keep and jitter
        have): a capture registers them, so each replay draws anew."""
        return [g for g in dict.fromkeys(
            getattr(m, "generator", None) for m in self.model.modules())
            if isinstance(g, torch.Generator) and g.device.type == "cuda"]

    def _execute(self, inputs, labels, apply_now: bool):
        if not self._graphed:
            return super()._execute(inputs, labels, apply_now)
        tensors = inputs + labels
        if not all(isinstance(t, torch.Tensor) for t in tensors):
            raise TypeError("a graphed train step takes tensors as inputs "
                            "and labels")
        sig = (len(inputs),) + tuple((tuple(t.shape), t.dtype)
                                     for t in tensors)
        static = self._buffers.get(sig)
        if static is None:
            static = self._buffers[sig] = [
                torch.empty(t.shape, dtype=t.dtype, device=self._device)
                for t in tensors]
        for dst, src in zip(static, tensors):
            dst.copy_(src, non_blocking=True)
        n = len(inputs)
        with self._cast_ctx():
            amp_key = amp._state_key()
        return self._graph(
            ("step", sig, amp_key, apply_now),
            lambda: self._body(tuple(static[:n]), tuple(static[n:]),
                               apply_now))

    def _run_schedule(self, fn):
        if not self._graphed:
            return super()._run_schedule(fn)
        self._graph(("schedule", self._sched_fingerprint(), fn is None),
                    lambda: self._schedule_body(fn))
