"""Functional ops of the port (port of paddle_tpu/nn/functional): the
loss the training path calls, the activations, dropout and layer norm
BERT calls, the convolutions, pools and batch norm of the vision and OCR
models, the attention entries of ``attention.py`` and the CTC loss of
``ctc.py``.  Each casts its inputs under amp by the JAX op's name.

The convolutions, pools and batch norm are XLA ops in the JAX package
(``lax.conv_general_dilated``, ``lax.reduce_window``), so the port's are
torch's: cuDNN for the convolutions, torch ops for the rest.  Layout is
NCHW, as in the JAX package."""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from ... import amp
from ..layer.common import dropout, flatten
from ..layer.norm import layer_norm
from .attention import (flash_attention, flashmask_attention,
                        scaled_dot_product_attention)
from .ctc import ctc_decode, ctc_loss


def gelu(x, approximate=False):
    """GELU: exact (erf), or the tanh form with ``approximate``."""
    (x,) = amp._cast_args("gelu", x)
    return F.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x):
    (x,) = amp._cast_args("tanh", x)
    return torch.tanh(x)


def relu(x):
    (x,) = amp._cast_args("relu", x)
    return torch.relu(x)


def add(a, b):
    """``a + b`` as the JAX op ``add`` (under amp O2 its f32 inputs are
    cast to the amp type)."""
    a, b = amp._cast_args("add", a, b)
    return a + b


# ------------------------------------------------------------------- convs
def _ntuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(int(x) for x in v)


def _conv_padding(padding, n):
    """The JAX package's padding forms: "SAME" / "VALID", an int, one int
    a spatial dim, 2n ints (lo, hi of each dim) or n (lo, hi) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (int, np.integer)):
        return [(int(padding),) * 2] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, (int, np.integer))
                                 for p in padding):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    return [tuple(int(q) for q in p) for p in padding]


def _pad_pairs(padding, spatial, window, stride, dilation):
    """(lo, hi) of each spatial dim, "SAME" and "VALID" resolved as XLA
    resolves them (SAME: ceil(in / stride) outputs, the odd pad at the
    end)."""
    pads = _conv_padding(padding, len(spatial))
    if pads == "VALID":
        return [(0, 0)] * len(spatial)
    if pads == "SAME":
        out = []
        for size, k, s, d in zip(spatial, window, stride, dilation):
            total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
            out.append((total // 2, total - total // 2))
        return out
    return pads


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN limited to its deterministic algorithms (and no autotuning)
    for the block; the flags are put back after it.  Some of its weight
    gradient algorithms add partial sums with atomics, whose order varies
    from run to run, and a graphed training step must equal its eager
    twin bit for bit."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


class _Conv(torch.autograd.Function):
    """A convolution whose forward and backward run under
    ``_deterministic_cudnn`` (the backward is ``aten.convolution_backward``
    with the forward's arguments)."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding, dilation, groups):
        ctx.save_for_backward(x, weight)
        ctx.args = (stride, padding, dilation, groups)
        with _deterministic_cudnn():
            return torch.convolution(x, weight, None, stride, padding,
                                     dilation, False, [0] * len(stride),
                                     groups)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.args
        with _deterministic_cudnn():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                grad, x, weight, None, stride, padding, dilation, False,
                [0] * len(stride), groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None, None


def _conv(x, weight, bias, stride, padding, dilation, groups, ndim,
          channel_last, op_name):
    """JAX ``_conv_impl``: the convolution (weight [out, in / groups,
    *k] in either data format, the reference's layout; the JAX package
    reads a channel-last convolution's weight as [*k, in, out]), then the
    bias added to its output."""
    x, weight, bias = amp._cast_args(op_name, x, weight, bias)
    if channel_last:
        x = x.movedim(-1, 1)
    stride = _ntuple(stride, ndim)
    dilation = _ntuple(dilation, ndim)
    pads = _pad_pairs(padding, x.shape[2:], weight.shape[2:], stride,
                      dilation)
    if all(lo == hi for lo, hi in pads):
        sym = [lo for lo, _ in pads]
    else:
        x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
        sym = [0] * ndim
    out = _Conv.apply(x, weight, stride, sym, dilation, groups)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * ndim)
    return out.movedim(1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    """The reference's ``conv1d``: weight [out, in / groups, k]."""
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format == "NLC", "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """The reference's ``conv2d``: weight [out, in / groups, kh, kw];
    ``padding`` an int, pairs or "SAME" / "VALID" (JAX's rules)."""
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format == "NHWC", "conv2d")


# ----------------------------------------------------------------- pooling
def _pool2d(x, kernel_size, stride, padding, channel_last, avg,
            exclusive=True):
    """JAX ``_pool`` in two dims: max pooling pads with -inf; average
    pooling divides the window's sum by its size, or with ``exclusive``
    by the count of its unpadded elements.  JAX's ``_pool`` takes
    ``ceil_mode`` and never uses it, and so neither does the port."""
    if channel_last:
        x = x.movedim(-1, 1)
    ks = _ntuple(kernel_size, 2)
    st = _ntuple(stride if stride is not None else kernel_size, 2)
    pads = _pad_pairs(padding, x.shape[2:], ks, st, (1, 1))
    direct = all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ks))
    if direct:
        sym = [lo for lo, _ in pads]
    else:
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        sym = [0, 0]
    if not avg:
        if not direct:
            x = F.pad(x, flat, value=-math.inf)
        out = F.max_pool2d(x, ks, st, sym)
    elif direct:
        out = F.avg_pool2d(x, ks, st, sym, count_include_pad=not exclusive)
    else:
        summed = F.avg_pool2d(F.pad(x, flat), ks, st, 0, divisor_override=1)
        if exclusive:
            ones = F.pad(torch.ones_like(x[:1, :1]), flat)
            out = summed / F.avg_pool2d(ones, ks, st, 0, divisor_override=1)
        else:
            out = summed / (ks[0] * ks[1])
    return out.movedim(1, -1) if channel_last else out


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    """Max pooling (padding with -inf); ``ceil_mode`` is ignored, as in
    the JAX package."""
    (x,) = amp._cast_args("max_pool2d", x)
    return _pool2d(x, kernel_size, stride, padding, data_format == "NHWC",
                   avg=False)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCHW"):
    """Average pooling, ``exclusive`` of the padding by default;
    ``ceil_mode`` is ignored, as in the JAX package."""
    (x,) = amp._cast_args("avg_pool2d", x)
    return _pool2d(x, kernel_size, stride, padding, data_format == "NHWC",
                   avg=True, exclusive=exclusive)


def _adaptive_axis(x, axis, out_size):
    """Mean over bins floor(i * in / out) .. ceil((i + 1) * in / out) of
    ``axis``: a reshape and one mean where ``out_size`` divides the axis
    (whose backward has no atomics, unlike torch's adaptive pooling on a
    card), else a mean a bin."""
    size = x.shape[axis]
    if size % out_size == 0:
        shape = list(x.shape)
        shape[axis:axis + 1] = [out_size, size // out_size]
        return x.reshape(shape).mean(axis + 1)
    bins = []
    for i in range(out_size):
        lo = (i * size) // out_size
        hi = ((i + 1) * size + out_size - 1) // out_size
        bins.append(x.narrow(axis, lo, hi - lo).mean(axis, keepdim=True))
    return torch.cat(bins, axis)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """JAX ``_adaptive_avg_pool2d``: the height's bins, then the width's."""
    (x,) = amp._cast_args("adaptive_avg_pool2d_", x)
    oh, ow = _ntuple(output_size, 2)
    if data_format == "NHWC":
        x = x.movedim(-1, 1)
    out = _adaptive_axis(_adaptive_axis(x, 2, oh), 3, ow)
    return out.movedim(1, -1) if data_format == "NHWC" else out


# -------------------------------------------------------------- batch norm
def _batch_mean(x, axes):
    """The batch mean (the JAX op ``mean``: black-listed, so f32 under
    amp)."""
    (x,) = amp._cast_args("mean", x)
    return x.mean(axes)


def _batch_var(x, axes):
    """The biased batch variance (the JAX op ``var``, on neither amp
    list): computed in f32 and rounded to the input's type, as ``jnp.var``
    computes a bf16 or f16 input."""
    (x,) = amp._cast_args("var", x)
    if x.dtype in (torch.bfloat16, torch.float16):
        return torch.var(x.float(), axes, correction=0).to(x.dtype)
    return torch.var(x, axes, correction=0)


def _unbiased(var, n):
    """The running update's variance: ``var * n / (n - 1)`` (the JAX op
    ``multiply``, whose f64 numpy factor promotes a bf16 variance to
    f32)."""
    return var.float() * (n / max(n - 1, 1))


def _batch_norm(x, mean, variance, weight, bias, epsilon, ch):
    """JAX ``_batch_norm`` (op ``batch_norm_f``, black-listed):
    (x - mean) * rsqrt(variance + eps) * weight + bias, the statistics
    broadcast along channel axis ``ch``."""
    x, mean, variance, weight, bias = amp._cast_args(
        "batch_norm_f", x, mean, variance, weight, bias)
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    out = (x - mean.reshape(shape)) \
        * torch.rsqrt(variance.reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """The reference's ``batch_norm``.  In training (without
    ``use_global_stats``) it normalizes by the batch's mean and biased
    variance and updates the running statistics in place:
    running = momentum * running + (1 - momentum) * batch, the variance's
    batch term unbiased (the reference's ``momentum=0.9`` is torch's
    0.1).  The update is in place and on every call, also inside a
    graphed ``jit.TrainStep`` (the JAX package skips it under a tracer);
    nothing rebinds the buffers, so a captured graph keeps their
    addresses.  Otherwise it normalizes by the running statistics."""
    ch = x.dim() - 1 if data_format in ("NHWC", "NLC", "NDHWC") else 1
    if not training or use_global_stats:
        return _batch_norm(x, running_mean, running_var, weight, bias,
                           epsilon, ch)
    axes = tuple(i for i in range(x.dim()) if i != ch)
    mean = _batch_mean(x, axes)
    var = _batch_var(x, axes)
    out = _batch_norm(x, mean, var, weight, bias, epsilon, ch)
    if running_mean is not None:
        n = x.numel() // x.shape[ch]
        with torch.no_grad():
            unbiased = _unbiased(var.detach(), n)
            running_mean.copy_(momentum * running_mean
                               + (1 - momentum) * mean.detach())
            running_var.copy_(momentum * running_var
                              + (1 - momentum) * unbiased)
    return out


def cross_entropy(input, label, ignore_index=-100, reduction="mean"):
    """Softmax cross entropy over the last axis of ``input`` with integer
    class labels (the reference's ``cross_entropy`` with hard labels).
    Labels equal to ``ignore_index`` contribute 0, and ``"mean"`` divides
    by the number of the others (at least 1), as the JAX package does.
    A label shaped like ``input`` with a last axis of 1 is squeezed."""
    (input,) = amp._cast_args("cross_entropy_f", input)
    if label.dim() == input.dim() and label.shape[-1] == 1:
        label = label.squeeze(-1)
    logits = input.reshape(-1, input.shape[-1])
    flat = label.reshape(-1).long()
    if reduction == "none":
        return F.cross_entropy(logits, flat, ignore_index=ignore_index,
                               reduction="none").reshape(label.shape)
    total = F.cross_entropy(logits, flat, ignore_index=ignore_index,
                            reduction="sum")
    if reduction == "sum":
        return total
    if reduction != "mean":
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    count = (flat != ignore_index).sum().to(total.dtype)
    return total / count.clamp_min(1.0)


__all__ = ["adaptive_avg_pool2d", "add", "avg_pool2d", "batch_norm",
           "conv1d", "conv2d", "cross_entropy", "ctc_decode", "ctc_loss",
           "dropout", "flash_attention", "flashmask_attention", "flatten",
           "gelu", "layer_norm", "max_pool2d", "relu",
           "scaled_dot_product_attention", "tanh"]
