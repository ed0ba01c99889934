"""Functional ops of the port (port of paddle_tpu/nn/functional): the
loss the training path calls and the attention entries of
``attention.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import amp
from .attention import flash_attention, flashmask_attention


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


__all__ = ["cross_entropy", "flash_attention", "flashmask_attention"]
