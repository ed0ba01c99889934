"""Convolution and pooling layers (port of paddle_tpu/nn/layer/conv_pool.py
``Conv1D``, ``Conv2D``, ``MaxPool2D``, ``AvgPool2D`` and
``AdaptiveAvgPool2D``).  A convolution's weight is [out_channels,
in_channels / groups, *kernel_size] in both packages, so the weight
bridge carries it as it is."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import functional as F


class _ConvNd(nn.Module):
    """The weight [out, in / groups, *k], drawn as the JAX package draws
    it: KaimingUniform over ``fan_in`` = in / groups * prod(k) with the
    leaky-ReLU gain at slope sqrt(5), i.e. U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), and the bias from the same range; ``bias_attr=False``
    means no bias."""

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, bias_attr, data_format, ndim,
                 device=None, dtype=None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = F._ntuple(kernel_size, ndim)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels // groups) + self.kernel_size, **kw))
        self.bias = None if bias_attr is False else \
            nn.Parameter(torch.empty(out_channels, **kw))
        self.reset_parameters()

    @property
    def fan_in(self) -> int:
        return (self.in_channels // self.groups) \
            * int(np.prod(self.kernel_size))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        bound = 1.0 / math.sqrt(self.fan_in)
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias_attr=None,
                 data_format="NCL", device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias_attr, data_format,
                         1, device, dtype)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv2D(_ConvNd):
    """The reference's ``Conv2D`` (NCHW by default)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias_attr=None,
                 data_format="NCHW", device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias_attr, data_format,
                         2, device, dtype)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class MaxPool2D(nn.Module):
    """Max pooling; ``ceil_mode`` is kept and ignored, as in the JAX
    package."""

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 data_format="NCHW"):
        super().__init__()
        self.args = (kernel_size, stride, padding)
        self.ceil_mode = ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, *self.args, ceil_mode=self.ceil_mode,
                            data_format=self.data_format)


class AvgPool2D(nn.Module):
    """Average pooling, exclusive of the padding by default."""

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, data_format="NCHW"):
        super().__init__()
        self.args = (kernel_size, stride, padding)
        self.ceil_mode = ceil_mode
        self.exclusive = exclusive
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, *self.args, ceil_mode=self.ceil_mode,
                            exclusive=self.exclusive,
                            data_format=self.data_format)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)
