"""The transformer encoder (port of the encoder half of
paddle_tpu/nn/layer/transformer.py): ``MultiHeadAttention``,
``TransformerEncoderLayer``, ``TransformerEncoder``.  Layout (batch,
seq, d_model).  Attention is ``functional.scaled_dot_product_attention``:
without a mask the port's flash kernels (non-causal), with an additive
mask the plain masked softmax.  The decoder half and the incremental
caches (``gen_cache``) are not ported yet.
"""
from __future__ import annotations

import copy
import math

import torch
from torch import nn

from .. import functional as F
from ..functional import add
from .common import Dropout, Linear
from .norm import LayerNorm


@torch.no_grad()
def xavier_normal_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """The JAX package's default Linear init: N(0, 2 / (fan_in +
    fan_out))."""
    fan_out, fan_in = weight.shape
    return weight.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                          generator=generator)


class MultiHeadAttention(nn.Module):
    """q/k/v/out projections (with bias) around scaled dot-product
    attention over ``num_heads`` heads.  ``dropout`` is kept for the
    reference API; attention ignores it, as the JAX package does."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, device=None, dtype=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(bias=True, device=device, dtype=dtype)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _shape(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = out.reshape(out.shape[0], out.shape[1], self.embed_dim)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Self-attention and a two-Linear feed-forward block, each with
    dropout and a residual; LayerNorm after each (or before, with
    ``normalize_before``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, layer_norm_eps=1e-5,
                 device=None, dtype=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(device=device, dtype=dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, bias=True, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, bias=True, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.act_dropout = Dropout(act_dropout, generator=generator)
        if activation not in ("relu", "gelu"):
            raise ValueError(f"unsupported activation {activation!r}")
        self.activation = activation

    def _act(self, x):
        return F.gelu(x) if self.activation == "gelu" else F.relu(x)

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, src_mask)
        src = add(residual, self.dropout1(src))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self._act(self.linear1(src))))
        src = add(residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer`` (the first is the layer
    given; each copy has its own parameters, drawn anew by the model's
    init), then an optional final norm."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [_clone(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        output = src
        for mod in self.layers:
            output = mod(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output


def _clone(layer):
    """A deep copy of ``layer`` whose dropouts share its generators."""
    memo = {id(m.generator): m.generator for m in layer.modules()
            if isinstance(m, Dropout) and m.generator is not None}
    return copy.deepcopy(layer, memo)
