"""Attention entry points of the port (port of
paddle_tpu/nn/functional/attention.py): ``flash_attention`` and
``flashmask_attention``, layout (batch, seq, heads, head_dim)."""
from __future__ import annotations

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


__all__ = ["flash_attention", "flashmask_attention"]
