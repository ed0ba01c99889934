"""Incubating functions of the port (port of
paddle_tpu/incubate/nn/functional): the chunked LM-head loss.
``fused_moe`` is not ported yet."""
from __future__ import annotations

from ....nn.functional.fused_loss import fused_linear_cross_entropy_raw


def fused_linear_cross_entropy(hidden, weight, labels, bias=None,
                               ignore_index=-100, chunk_rows=1024,
                               name=None):
    """Chunked LM-head loss: the mean cross entropy of ``hidden @
    weight.T (+ bias)`` against ``labels``, without ever holding the
    [tokens, vocab] logits (``nn/functional/fused_loss.py``: row chunks
    in the forward, recomputed in the backward).  ``weight`` is [vocab,
    hidden], as the port's ``Linear`` stores it (the JAX package takes
    [hidden, vocab]); leading dims of ``hidden`` and ``labels`` are
    flattened.  Returns an f32 scalar."""
    return fused_linear_cross_entropy_raw(
        hidden, weight, labels, bias=bias, ignore_index=int(ignore_index),
        chunk_rows=int(chunk_rows))


__all__ = ["fused_linear_cross_entropy"]
