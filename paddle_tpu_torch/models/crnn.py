"""CRNN, the OCR recognition model (port of paddle_tpu/models/crnn.py):
a conv backbone whose two 2x poolings collapse the height, a
bidirectional two-layer LSTM over the width, a per-step classifier, and
the CTC loss (``nn.functional.ctc_loss``) on its time-major logits."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import amp
from .._device import resolve_device
from ..nn import BatchNorm2D, Conv2D, Linear, LSTM, MaxPool2D, ReLU, \
    Sequential
from ..nn.layer.layers import init_weights


def _transpose(x, perm):
    """``x.permute(perm)`` as the JAX op ``transpose``."""
    (x,) = amp._cast_args("transpose", x)
    return x.permute(perm)


def _reshape(x, shape):
    (x,) = amp._cast_args("reshape", x)
    return x.reshape(shape)


class CRNN(nn.Module):
    """Input [N, C, H, W] (H divisible by 4); output logits [W / 4, N,
    num_classes], time-major, as ``ctc_loss`` takes them.  Weights are
    drawn on ``device`` from ``seed`` (the JAX initializers' laws);
    ``seed=None`` leaves the layers' own draws for a caller that loads
    weights (``models.convert.crnn_params_from_numpy``)."""

    def __init__(self, num_classes, in_channels=1, img_height=32,
                 hidden_size=96, channels=(32, 64, 128), device="cuda",
                 dtype=None, seed: Optional[int] = 0):
        super().__init__()
        if img_height % 4 != 0:
            raise ValueError("img_height must be divisible by 4 "
                             "(two 2x poolings collapse it)")
        kw = dict(device=resolve_device(device), dtype=dtype)
        c1, c2, c3 = channels
        self.backbone = Sequential(
            Conv2D(in_channels, c1, 3, padding=1, **kw),
            BatchNorm2D(c1, **kw), ReLU(), MaxPool2D(2, 2),
            Conv2D(c1, c2, 3, padding=1, **kw),
            BatchNorm2D(c2, **kw), ReLU(), MaxPool2D(2, 2),
            Conv2D(c2, c3, 3, padding=1, **kw),
            BatchNorm2D(c3, **kw), ReLU(),
        )
        self.rnn = LSTM(c3 * (img_height // 4), hidden_size, num_layers=2,
                        direction="bidirect", time_major=False, **kw)
        self.head = Linear(2 * hidden_size, num_classes, bias=True, **kw)
        self.num_classes = num_classes
        if seed is not None:
            init_weights(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.backbone(x)                       # [N, C3, H/4, W/4]
        n, c, h, w = feat.shape
        seq = _reshape(_transpose(feat, (0, 3, 1, 2)), (n, w, c * h))
        enc, _ = self.rnn(seq)                        # [N, T, 2 hidden]
        logits = self.head(enc)                       # [N, T, classes]
        return _transpose(logits, (1, 0, 2))          # [T, N, classes]


def crnn_tiny(num_classes, in_channels=1, img_height=16, device="cuda",
              dtype=None, seed: Optional[int] = 0):
    """The small configuration of the tests and the CPU benchmark."""
    return CRNN(num_classes, in_channels, img_height, hidden_size=48,
                channels=(16, 32, 64), device=device, dtype=dtype,
                seed=seed)
