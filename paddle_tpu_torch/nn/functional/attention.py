"""Attention entry points of the port (port of
paddle_tpu/nn/functional/attention.py): ``flash_attention``,
``scaled_dot_product_attention`` and ``flashmask_attention``, layout
(batch, seq, heads, head_dim)."""
from __future__ import annotations

import math

import torch

from ... import amp
from ...ops.flash_attention import flash_attention_bshd
from ...ops.flashmask_attention import flashmask_attention_bshd


def flash_attention(query, key, value, causal=False):
    """The reference API ``flash_attention``: layout (batch, seq, heads,
    head_dim), returns ``(out, None)``.  It always runs the port's flash
    kernels on the card (differentiable under autograd) and their plain
    versions on the CPU; the port has no autotune between the two."""
    query, key, value = amp._cast_args("flash_attention", query, key, value)
    return flash_attention_bshd(query, key, value, causal=causal), None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """The reference API ``scaled_dot_product_attention`` (the JAX op
    ``sdpa``).  Without a mask it is the flash path: the port's flash
    kernels on the card, forward and backward.  With an additive mask
    (broadcast to (batch, heads, sq, sk)) it is the plain masked softmax,
    as the JAX package computes it in XLA: f32 scores plus the mask,
    softmax, then the probabilities in ``value``'s type.  ``dropout_p``
    is ignored, as in the JAX package."""
    query, key, value, attn_mask = amp._cast_args(
        "sdpa", query, key, value, attn_mask)
    if attn_mask is None:
        return flash_attention_bshd(query, key, value, causal=is_causal)
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    if k.shape[1] != q.shape[1]:
        group = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + attn_mask
    if is_causal:
        sq, sk = q.shape[2], k.shape[2]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = s.masked_fill(~keep, -0.7 * float(torch.finfo(
            torch.float32).max))
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(v.dtype), v)
    return out.transpose(1, 2)


def flashmask_attention(query, key, value, startend_row_indices,
                        dropout=0.0, causal=False, window_size=None,
                        return_softmax_lse=False, return_seed_offset=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """The reference API ``flashmask_attention`` (PaddlePaddle 3.0):
    attention under a mask given as per-column row intervals,
    ``startend_row_indices`` (batch, mask heads, sk, 1 | 2 | 4) int32 —
    column j is masked for the rows in [start_j, end_j) (1 column:
    [start, sq); 4: two bands) — with an optional top-left causal mask.
    Layout (batch, seq, heads, head_dim).  The FlashMask kernels run on
    the card (forward, and dK/dV and dQ under autograd), their plain
    versions on the CPU; a row that every column masks comes back as
    zeros.  As in the JAX package, ``dropout`` and ``window_size`` are
    ignored, and the extra outputs asked for are None: ``out``, or
    ``(out, None)``, or ``(out, None, None)`` with the seed offset."""
    out = flashmask_attention_bshd(query, key, value, startend_row_indices,
                                   causal=causal)
    if return_softmax_lse or return_seed_offset:
        return (out, None) + ((None,) if return_seed_offset else ())
    return out


__all__ = ["flash_attention", "flashmask_attention",
           "scaled_dot_product_attention"]
