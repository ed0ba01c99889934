"""Linear and Embedding (port of paddle_tpu/nn/layer/common.py).

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
    """Row lookup in a [num_embeddings, embedding_dim] table."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 device=None, dtype=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        (weight,) = amp._cast_args("embedding_", self.weight)
        return F.embedding(ids, weight)

    def extra_repr(self) -> str:
        return f"{self.num_embeddings}, {self.embedding_dim}"
