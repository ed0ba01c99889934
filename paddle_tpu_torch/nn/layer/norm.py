"""RMSNorm (port of paddle_tpu/nn/layer/norm.py ``RMSNorm``)."""
from __future__ import annotations

import torch
from torch import nn

from ... import amp
from ...ops.fused_norm_rope import rms_norm


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight over the last dim: the Triton
    kernel on the card, the plain version on the CPU."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6,
                 device=None, dtype=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight = amp._cast_args("rms_norm_f", x, self.weight)
        return rms_norm(x, weight, self.epsilon)
