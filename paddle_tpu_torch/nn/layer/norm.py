"""RMSNorm and LayerNorm (port of paddle_tpu/nn/layer/norm.py
``RMSNorm`` and ``LayerNorm``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
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


class LayerNorm(nn.Module):
    """(x - mean) / sqrt(var + eps) * weight + bias over the trailing
    ``normalized_shape`` dims (the biased variance).  It is XLA in the JAX
    package, so torch's ``layer_norm`` is the port's form of it; under
    amp it is the black-listed ``layer_norm_f``, computed in f32."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                             device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={list(self.normalized_shape)}"


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """The functional form; inputs of mixed types compute in their
    promoted type, as ``jnp`` promotes them."""
    x, weight, bias = amp._cast_args("layer_norm_f", x, weight, bias)
    dt = x.dtype
    for t in (weight, bias):
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    return F.layer_norm(x.to(dt), tuple(normalized_shape),
                        None if weight is None else weight.to(dt),
                        None if bias is None else bias.to(dt), epsilon)
