"""Activation layers of the port (port of the ``Tanh``, ``GELU`` and
``ReLU`` of paddle_tpu/nn/layer/activation.py)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F


class Tanh(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.tanh(x)


class ReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)


class GELU(nn.Module):
    """GELU, exact (erf) unless ``approximate``."""

    def __init__(self, approximate: bool = False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x, self.approximate)
