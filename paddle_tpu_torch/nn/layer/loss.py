"""Loss layers of the port (port of paddle_tpu/nn/layer/loss.py
``CrossEntropyLoss``)."""
from __future__ import annotations

from torch import nn

from .. import functional as F


class CrossEntropyLoss(nn.Module):
    """Softmax cross entropy with integer class labels over the last
    axis (``functional.cross_entropy``).  Class weights, soft labels,
    another axis, ``use_softmax=False`` and label smoothing are not
    ported yet and raise."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        if weight is not None or soft_label or axis != -1 \
                or not use_softmax or label_smoothing:
            raise NotImplementedError(
                "CrossEntropyLoss: only hard labels over the last axis, "
                "without class weights or label smoothing, are ported")
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.cross_entropy(input, label, ignore_index=self.ignore_index,
                               reduction=self.reduction)
