"""Linear, Embedding, Dropout and Flatten (port of
paddle_tpu/nn/layer/common.py).

The JAX package stores a Linear weight as [in_features, out_features];
these modules use PyTorch's [out_features, in_features], so weights
carried over from the JAX package are transposed (see
``models/convert.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ... import amp
from ...ops.quant_matmul import quant_linear_forward


class Linear(nn.Module):
    """y = x @ weight.T (+ bias), weight [out_features, in_features].

    Quantized serving: while a serving step runs, the paged decoder arms
    ``_serving_quant = (mode, w_q, scale)`` with the layer's int8 twin
    and the forward runs ``ops.quant_matmul.quant_linear_forward``; the
    decoder clears it when the step ends, so it is never armed outside
    one.

    Tensor-parallel serving: a row-parallel projection of a rank's shard
    (o and down, bias-free) computes a partial sum, and the paged
    decoder arms ``_tp_reduce`` with the collective that closes its
    block (a sum over the ranks) for the duration of each step, as it
    arms ``_serving_quant``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = False, device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if bias else None)
        self._serving_quant = None
        self._tp_reduce = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self._serving_quant
        if q is not None:
            out = quant_linear_forward(self, x, q)
        else:
            x, w, b = amp._cast_args("linear", x, self.weight, self.bias)
            out = F.linear(x, w, b)
        r = self._tp_reduce
        return out if r is None else r(out)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(nn.Module):
    """Row lookup in a [num_embeddings, embedding_dim] table.  On a card,
    under autograd, the table's gradient is ``sorted_row_sums`` (the same
    bits every run); torch's own CUDA backward adds the gradients of
    the tokens that share a row in an order that varies from run to run
    (BERT's token types: every token reads row 0)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 device=None, dtype=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        (weight,) = amp._cast_args("embedding_", self.weight)
        if weight.is_cuda and weight.requires_grad and \
                torch.is_grad_enabled():
            return _Lookup.apply(weight, ids)
        return F.embedding(ids, weight)

    def extra_repr(self) -> str:
        return f"{self.num_embeddings}, {self.embedding_dim}"


class _Lookup(torch.autograd.Function):
    """``F.embedding`` whose backward is ``sorted_row_sums``."""

    @staticmethod
    def forward(ctx, weight, ids):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return sorted_row_sums(ids, grad, ctx.rows), None


def sorted_row_sums(ids, grad, rows):
    """The gradient of a row lookup: row r of the [rows, D] result sums
    ``grad``'s rows of the tokens with id r.  Computed the same way every
    run, with fixed shapes (no host read, so a CUDA graph captures it):
    the tokens are sorted stably by id, their gradients summed as
    differences of f64 prefix sums at the ends of each id's run, and each
    run's total added into its row together with exact zeros from the
    other positions, so the order of the additions cannot show."""
    flat = ids.reshape(-1).long()
    g = grad.reshape(-1, grad.shape[-1])
    n = flat.numel()
    out = torch.zeros((rows, g.shape[-1]), dtype=grad.dtype,
                      device=grad.device)
    if n == 0:
        return out
    order = torch.argsort(flat, stable=True)
    key = flat[order]
    # (D, n): the prefix sums run along contiguous rows, where torch's
    # scan is parallel (along dim 0 a thread walks each column)
    csum = g[order].t().contiguous().double().cumsum(1)
    pos = torch.arange(n, device=flat.device)
    last = torch.ones(n, dtype=torch.bool, device=flat.device)
    last[:-1] = key[1:] != key[:-1]
    ends = torch.where(last, pos, -1)
    prev = torch.cat([ends.new_full((1,), -1), ends[:-1]]).cummax(0).values
    base = torch.where(prev >= 0, csum[:, prev.clamp_min(0)], 0.0)
    total = torch.where(last, csum - base, 0.0).to(grad.dtype)
    return out.index_add_(0, key, total.t())


class Dropout(nn.Module):
    """Dropout in the reference's modes: ``upscale_in_train`` (kept
    entries scaled by 1 / (1 - p) in training, identity in eval) or
    ``downscale_in_infer`` (kept as they are in training, scaled by
    1 - p in eval).  ``axis`` drops whole slices along the given axes.
    The mask is drawn from ``generator`` (a ``torch.Generator`` on the
    input's device; torch's default one when None).  The JAX package
    draws from its threefry keys, so the two packages' masks differ; at
    p = 0 or in eval both are exact."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", generator=None):
        super().__init__()
        if mode not in ("upscale_in_train", "downscale_in_infer"):
            raise ValueError(f"unsupported dropout mode {mode!r}")
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.p, self.axis, self.training, self.mode,
                       self.generator)

    def extra_repr(self) -> str:
        return f"p={self.p}"


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator=None):
    """The functional form of :class:`Dropout` (the JAX op ``dropout_``:
    under amp O2 its f32 input is cast)."""
    (x,) = amp._cast_args("dropout_", x)
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    shape = x.shape
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = [x.shape[a] if a in axes or a - x.dim() in axes else 1
                 for a in range(x.dim())]
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


class Flatten(nn.Module):
    """Dims ``start_axis`` .. ``stop_axis`` merged into one."""

    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flatten(x, self.start_axis, self.stop_axis)


def flatten(x, start_axis=0, stop_axis=-1):
    """The reference's ``flatten`` (the JAX op ``flatten_``, in
    paddle_tpu/tensor/manipulation.py)."""
    (x,) = amp._cast_args("flatten_", x)
    return torch.flatten(x, start_axis, stop_axis)
