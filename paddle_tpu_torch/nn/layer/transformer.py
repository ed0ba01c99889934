"""Transformer layers (port of paddle_tpu/nn/layer/transformer.py):
``MultiHeadAttention`` with its incremental ``Cache`` and precomputed
``StaticCache``, ``TransformerEncoderLayer`` / ``TransformerEncoder``,
``TransformerDecoderLayer`` / ``TransformerDecoder`` and ``Transformer``.
Layout (batch, seq, d_model).  Attention is
``functional.scaled_dot_product_attention``: without a mask the port's
flash kernels (non-causal; a cached decoding step is one query row
against the cache), with an additive mask (a decoder's causal
``tgt_mask``) the plain masked softmax, as the JAX package routes it.
"""
from __future__ import annotations

import collections
import copy
import math

import torch
from torch import nn

from ..._device import resolve_device
from .. import functional as F
from ..functional import add
from .common import Dropout, Linear
from .layers import LayerList, seed_model
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
    reference API; attention ignores it, as the JAX package does.

    ``cache``: a ``Cache(k, v)`` holds the keys and values of the steps
    so far, [batch, steps, heads, head_dim]; this step's are appended
    and the forward returns ``(out, new Cache)``.  A ``StaticCache``
    holds keys and values computed once (``gen_cache(memory,
    type=StaticCache)``, a decoder's cross-attention) and is used as it
    is; the forward then returns ``out`` alone."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

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

    def gen_cache(self, key, value=None, type=None):
        """With ``type=StaticCache`` the projected keys and values of
        ``key`` / ``value``; otherwise an empty ``Cache`` (zero steps) in
        ``key``'s type."""
        if type is MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None
                                        else key))
            return self.StaticCache(k, v)
        k = key.new_zeros((key.shape[0], 0, self.num_heads, self.head_dim))
        return self.Cache(k, torch.zeros_like(k))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = F.concat([cache.k, k], 1)
                v = F.concat([cache.v, v], 1)
                cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None and not isinstance(cache, self.StaticCache):
            return out, cache
        return out


class _FeedForward:
    """The activation of the feed-forward block, looked up in
    ``functional`` at each call."""

    def _set_activation(self, name):
        if name not in ("relu", "gelu"):
            raise ValueError(f"unsupported activation {name!r}")
        self.activation = name

    def _act(self, x):
        return F.gelu(x) if self.activation == "gelu" else F.relu(x)


class TransformerEncoderLayer(_FeedForward, nn.Module):
    """Self-attention and a two-Linear feed-forward block, each with
    dropout and a residual; LayerNorm after each (or before, with
    ``normalize_before``).  With ``cache`` (``gen_cache(src)``) the
    self-attention appends to it and the forward returns ``(out, new
    cache)``."""

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
        self._set_activation(activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
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
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer`` (the first is the layer
    given; each copy has its own parameters, drawn anew by the model's
    init), then an optional final norm.  ``cache`` is a list of each
    layer's cache (``gen_cache``); with it the forward returns ``(out,
    new caches)``."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] + [_clone(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(_FeedForward, nn.Module):
    """Self-attention over the target (``tgt_mask``, e.g. causal), then
    cross-attention over the encoder's ``memory`` (``memory_mask``),
    then the feed-forward block, each with dropout, a residual and a
    LayerNorm (after, or before with ``normalize_before``).  ``cache``
    is ``(Cache, StaticCache)`` (``gen_cache(memory)``): the
    self-attention appends this step to the first, the cross-attention
    reads the second instead of projecting ``memory``; the forward then
    returns ``(out, (new Cache, StaticCache))``."""

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
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **kw)
        self.linear1 = Linear(d_model, dim_feedforward, bias=True, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, bias=True, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.dropout3 = Dropout(dropout, generator=generator)
        self.act_dropout = Dropout(act_dropout, generator=generator)
        self._set_activation(activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incr = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = add(residual, self.dropout1(tgt))
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                              None if cache is None else cache[1])
        tgt = add(residual, self.dropout2(tgt))
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.act_dropout(self._act(self.linear1(tgt))))
        tgt = add(residual, self.dropout3(tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr, cache[1]))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(nn.Module):
    """``num_layers`` copies of ``decoder_layer``, then an optional final
    norm; ``cache`` a list of each layer's ``(Cache, StaticCache)``."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] + [_clone(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """Each layer's ``(Cache, StaticCache)``; ``do_zip`` is accepted
        and ignored, as in the JAX package."""
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(nn.Module):
    """The reference's ``paddle.nn.Transformer``: an encoder of
    ``num_encoder_layers`` and a decoder of ``num_decoder_layers``
    (``custom_encoder`` / ``custom_decoder`` replace them), with a final
    LayerNorm on each under ``normalize_before``.  ``forward(src, tgt,
    src_mask, tgt_mask, memory_mask)`` returns the decoder's output.
    Built on ``device`` (default the card); the weights are drawn from
    ``seed`` by the JAX initializers' laws and the dropouts draw from
    the model's own ``generator`` (``layers.seed_model``; ``seed=None``
    for a caller that loads weights)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, custom_encoder=None,
                 custom_decoder=None, device="cuda", dtype=None, seed=0):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before)
        with torch.device(resolve_device(device)):
            if custom_encoder is not None:
                self.encoder = custom_encoder
            else:
                self.encoder = TransformerEncoder(
                    TransformerEncoderLayer(*args), num_encoder_layers,
                    LayerNorm(d_model) if normalize_before else None)
            if custom_decoder is not None:
                self.decoder = custom_decoder
            else:
                self.decoder = TransformerDecoder(
                    TransformerDecoderLayer(*args), num_decoder_layers,
                    LayerNorm(d_model) if normalize_before else None)
        seed_model(self, dtype, seed)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """The additive causal mask [length, length] f32: 0 on and below
        the diagonal, -inf above, on the model's device."""
        dev = next(self.parameters()).device
        return torch.full((length, length), -math.inf,
                          device=dev).triu(1)


def _clone(layer):
    """A deep copy of ``layer`` whose dropouts share its generators."""
    memo = {id(m.generator): m.generator for m in layer.modules()
            if isinstance(m, Dropout) and m.generator is not None}
    return copy.deepcopy(layer, memo)
