"""Batch norms, RMSNorm and LayerNorm (port of
paddle_tpu/nn/layer/norm.py ``BatchNorm``, ``BatchNorm1D/2D/3D``,
``RMSNorm`` and ``LayerNorm``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ... import amp
from ...ops.fused_norm_rope import rms_norm
from .. import functional


class _BatchNormBase(nn.Module):
    """Batch norm over the channel axis of ``data_format``: weight 1 and
    bias 0 (parameters), the running ``_mean`` 0 and ``_variance`` 1
    (buffers, under the JAX package's names).  In training the batch
    statistics normalize and the running ones are updated in place,
    ``momentum`` weighting the old value (the reference's 0.9 is torch's
    0.1); in eval the running ones normalize.  See
    ``functional.batch_norm``."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 data_format="NCHW", use_global_stats=None, device=None,
                 dtype=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.ones(num_features, **kw))
        self.bias = nn.Parameter(torch.zeros(num_features, **kw))
        self.register_buffer("_mean", torch.zeros(num_features, **kw))
        self.register_buffer("_variance", torch.ones(num_features, **kw))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self._mean.zero_()
        self._variance.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return functional.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self.momentum,
            epsilon=self.epsilon, data_format=self.data_format,
            use_global_stats=self.use_global_stats)

    def extra_repr(self) -> str:
        return f"num_features={self.num_features}, momentum={self.momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 data_format="NCL", use_global_stats=None, device=None,
                 dtype=None):
        super().__init__(num_features, momentum, epsilon,
                         "NCHW" if data_format == "NCL" else "NHWC",
                         use_global_stats, device, dtype)


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 data_format="NCDHW", use_global_stats=None, device=None,
                 dtype=None):
        super().__init__(num_features, momentum, epsilon,
                         "NCHW" if data_format == "NCDHW" else "NHWC",
                         use_global_stats, device, dtype)


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
