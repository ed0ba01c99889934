"""Automatic mixed precision (port of paddle_tpu/amp): ``auto_cast``
(levels O0, OD, O1, O2, custom op lists), ``decorate``, ``GradScaler``.

The JAX package casts at its one op-dispatch point, by op name: a
black-listed op runs its floating inputs in f32, a white-listed op
casts its f32 inputs to the amp dtype (O1 and OD), and under O2 every
op but the black-listed casts its f32 inputs.  The port has no dispatch
layer, so each of its op sites that the JAX package dispatches under a
name calls :func:`_cast_args` with that name on its tensor inputs:
``linear`` (``nn.Linear``), ``embedding_`` (``nn.Embedding``),
``rms_norm_f`` (``nn.RMSNorm``), ``fused_rope`` and ``flash_attention``
(the LLaMA attention; ``flash_attention`` also in
``nn.functional.flash_attention``), ``tied_lm_head`` (a tied LM head),
``cross_entropy_f`` (``nn.functional.cross_entropy``), ``matmul`` (the
MoE gate's logits), ``moe_topk_routing`` / ``moe_gating`` (the gate's
routing), ``moe_ragged_dispatch``, ``expert_ffn`` and
``moe_ragged_combine`` (the MoE layer), ``multiply`` (the MoE
model's weighted balance loss); and on the vision and OCR paths
``conv1d`` / ``conv2d``, ``max_pool2d``, ``avg_pool2d``,
``adaptive_avg_pool2d_``, ``relu``, ``add`` (a residual), ``flatten_``,
the batch norm's ``mean``, ``var``, ``multiply`` (the running
variance's factor) and ``batch_norm_f``, ``rnn_LSTM`` / ``rnn_GRU`` /
``rnn_RNN`` and the cells' ``lstm_cell`` / ``gru_cell`` / ``rnn_cell``,
CRNN's ``transpose`` and ``reshape``, and the CTC loss's ``ctc_loss_``,
``clip``, ``divide``, ``mean`` and ``sum``.  Every other op keeps its input types
and promotes as ``jnp`` does where the two agree (an f32 and a bf16
tensor give f32 in both).  ``torch.autocast`` is not used: its op lists
are not the JAX package's, differ between the CPU and the card, and
leave the port's own autograd Functions (the flash and RMSNorm kernels)
alone.

The state is thread-local, as in the JAX package.  A recomputed block
(``torch.utils.checkpoint``) runs its forward again in the backward, on
the autograd engine's thread: the model's checkpoint calls pass
:func:`recompute_contexts` so the recomputation runs under the amp state
of the forward it repeats.
"""
from __future__ import annotations

import contextlib
import threading

import torch

# the JAX package's lists, under its op names
WHITE_LIST = {
    "matmul", "bmm", "mm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "einsum_", "addmm", "flash_attention", "sdpa",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "expm1", "pow", "square",
    "reciprocal", "rsqrt", "softmax_", "log_softmax_", "cross_entropy_f",
    "nll_loss_f", "bce_f", "bce_logits_f", "kl_div_f", "layer_norm_f",
    "batch_norm_f", "group_norm_f", "instance_norm_f", "rms_norm_f",
    "logsumexp", "cumsum", "cumprod", "norm", "vector_norm", "dist", "cov",
    "mse_loss_f", "l1_loss_f", "smooth_l1_f", "softmax_with_cross_entropy",
    "sum", "mean",
}

_LOW = (torch.bfloat16, torch.float16)
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def _convert_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.white = WHITE_LIST
        self.black = BLACK_LIST


_state = _AmpState()


def _snapshot():
    s = _state
    return (s.enabled, s.dtype, s.level, s.white, s.black)


def _restore(saved):
    s = _state
    s.enabled, s.dtype, s.level, s.white, s.black = saved


def _state_key():
    """The current state as a hashable key (what a captured forward
    bakes in)."""
    s = _state
    if not s.enabled or s.level == "O0":
        return None
    return (s.dtype, s.level, frozenset(s.white), frozenset(s.black))


def _cast_args(op_name: str, *args):
    """``args`` as the JAX package's amp hook leaves an op's inputs
    under the current state: unchanged when amp is off or at O0; a
    black-listed op's bf16/f16 tensors up to f32; a white-listed op's
    (O1, OD) or, under O2, any other op's f32 tensors down to the amp
    dtype.  Non-tensors (None, ints) pass through.  Returns a tuple."""
    s = _state
    if not s.enabled or s.level == "O0":
        return args
    if op_name in s.black:
        return tuple(a.float() if isinstance(a, torch.Tensor)
                     and a.dtype in _LOW else a for a in args)
    if s.level == "O2" or op_name in s.white:
        d = s.dtype
        return tuple(a.to(d) if isinstance(a, torch.Tensor)
                     and a.dtype == torch.float32 else a for a in args)
    return args


def recompute_contexts():
    """``context_fn`` for ``torch.utils.checkpoint.checkpoint``: the
    forward runs as it is, the recomputation under the amp state of that
    forward (taken now, when the checkpointed block first runs)."""
    saved = _snapshot()

    @contextlib.contextmanager
    def recompute():
        before = _snapshot()
        _restore(saved)
        try:
            yield
        finally:
            _restore(before)

    return contextlib.nullcontext(), recompute()


class auto_cast:
    """The reference's ``paddle.amp.auto_cast``: within the block, op
    sites cast their inputs by ``level`` ("O0", "OD", "O1", "O2") to
    ``dtype``, with ``custom_white_list`` / ``custom_black_list`` added
    to (and taken from) the default lists."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        if level not in ("O0", "OD", "O1", "O2"):
            raise ValueError(f"unsupported amp level {level}")
        self.enable = enable
        self.level = level
        self.dtype = _convert_dtype(dtype)
        self.custom_white = set(custom_white_list or ())
        self.custom_black = set(custom_black_list or ())

    def __enter__(self):
        self._saved = _snapshot()
        s = _state
        s.enabled = self.enable
        s.dtype = self.dtype
        s.level = self.level
        s.white = (WHITE_LIST | self.custom_white) - self.custom_black
        s.black = (BLACK_LIST | self.custom_black) - self.custom_white
        return self

    def __exit__(self, *exc):
        _restore(self._saved)
        return False


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """The reference's ``paddle.amp.decorate``: at O2 every floating
    parameter of the models is cast to ``dtype`` (in place: each stays
    the same ``Parameter``, so an optimizer built on it keeps it), and
    the optimizers keep f32 master weights (``_multi_precision``) unless
    ``master_weight`` is False.  Buffers keep their type: the port's
    LLaMA holds its RoPE tables in f32 whatever the model's type, so a
    decorated model is the model built in ``dtype`` (the JAX package
    casts buffers too)."""
    d = _convert_dtype(dtype)
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.is_floating_point() and p.dtype != d:
                        p.data = p.data.to(d)
                        p.grad = None
    if optimizers is None:
        return models if single_model else model_list
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    if level == "O2" and master_weight is not False:
        for opt in opt_list:
            opt._multi_precision = True
    return (models if single_model else model_list,
            optimizers if single_opt else opt_list)


class GradScaler:
    """The reference's ``paddle.amp.GradScaler``: dynamic loss scaling.
    ``scale`` multiplies the loss; ``step`` divides the optimizer's
    gradients by the scale and skips the update when any of them is not
    finite; ``update`` halves the scale (``decr_ratio``) after
    ``decr_every_n_nan_or_inf`` such steps and doubles it
    (``incr_ratio``) after ``incr_every_n_steps`` clean ones, never
    below 1.  With ``enable=False`` everything passes through.  Whether
    a gradient overflowed is one read of a device flag a step (the JAX
    package reads one a parameter)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    def unscale_(self, optimizer):
        if not self._enable or self._unscaled:
            return
        self._unscaled = True
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        found = False
        if grads:
            with torch.no_grad():
                torch._foreach_mul_(grads, 1.0 / self._scale)
                finite = torch.stack([torch.isfinite(g).all()
                                      for g in grads]).all()
            found = not bool(finite)
        self._found_inf = found

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def update(self):
        self._unscaled = False
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_count": self._good_steps, "decr_count": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("incr_count", 0)
        self._bad_steps = sd.get("decr_count", 0)

    set_state_dict = load_state_dict


def is_bfloat16_supported():
    return True


def is_float16_supported():
    return True


__all__ = ["BLACK_LIST", "GradScaler", "WHITE_LIST", "amp_guard",
           "auto_cast", "decorate", "is_bfloat16_supported",
           "is_float16_supported", "recompute_contexts"]
