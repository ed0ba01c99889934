"""GoogLeNet (Inception v1) and InceptionV3 (port of
paddle_tpu/vision/models/inception.py): the same blocks, channel plans
and names.  GoogLeNet in training with its aux heads returns ``(out,
aux1, aux2)``.  ``with_pool`` is accepted and ignored, as in the JAX
package.  ``device``, ``dtype``, ``seed`` and the dropout ``generator``
as in ``small_nets.py``."""
from __future__ import annotations

import torch
from torch import nn

from ..._device import resolve_device
from ...nn import functional as F
from ...nn.layer.activation import ReLU
from ...nn.layer.common import Dropout, Linear
from ...nn.layer.conv_pool import (AdaptiveAvgPool2D, AvgPool2D, Conv2D,
                                   MaxPool2D)
from ...nn.layer.layers import Sequential, seed_model
from ...nn.layer.norm import BatchNorm2D

__all__ = ["GoogLeNet", "InceptionV3", "googlenet", "inception_v3"]


class ConvBNReLU(Sequential):
    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__(
            Conv2D(cin, cout, kernel, stride, padding, bias_attr=False),
            BatchNorm2D(cout), ReLU())


# ================================================================ GoogLeNet
class _InceptionBlock(nn.Module):
    """The 4-branch v1 block: 1x1 / 1x1 -> 3x3 / 1x1 -> 5x5 / pool -> 1x1."""

    def __init__(self, cin, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = ConvBNReLU(cin, c1, 1)
        self.b3 = Sequential(ConvBNReLU(cin, c3r, 1),
                             ConvBNReLU(c3r, c3, 3, padding=1))
        self.b5 = Sequential(ConvBNReLU(cin, c5r, 1),
                             ConvBNReLU(c5r, c5, 5, padding=2))
        self.bp = Sequential(MaxPool2D(3, 1, 1), ConvBNReLU(cin, proj, 1))

    def forward(self, x):
        return F.concat([self.b1(x), self.b3(x), self.b5(x), self.bp(x)], 1)


class _AuxHead(nn.Module):
    def __init__(self, cin, num_classes):
        super().__init__()
        self.pool = AdaptiveAvgPool2D(4)   # input-size-independent 4x4
        self.conv = ConvBNReLU(cin, 128, 1)
        self.fc1 = Linear(128 * 4 * 4, 1024, bias=True)
        self.relu = ReLU()
        self.drop = Dropout(0.7)
        self.fc2 = Linear(1024, num_classes, bias=True)

    def forward(self, x):
        x = F.flatten(self.conv(self.pool(x)), 1)
        return self.fc2(self.drop(self.relu(self.fc1(x))))


class GoogLeNet(nn.Module):
    """Returns ``(out, aux1, aux2)`` in training with the aux heads
    (``with_aux``), as the reference does; ``out`` otherwise."""

    def __init__(self, num_classes=1000, with_pool=True, with_aux=True,
                 device="cuda", dtype=None, seed=0):
        super().__init__()
        self.with_aux = with_aux
        with torch.device(resolve_device(device)):
            self.stem = Sequential(
                ConvBNReLU(3, 64, 7, 2, 3), MaxPool2D(3, 2, 1),
                ConvBNReLU(64, 64, 1), ConvBNReLU(64, 192, 3, padding=1),
                MaxPool2D(3, 2, 1))
            self.i3a = _InceptionBlock(192, 64, 96, 128, 16, 32, 32)
            self.i3b = _InceptionBlock(256, 128, 128, 192, 32, 96, 64)
            self.pool3 = MaxPool2D(3, 2, 1)
            self.i4a = _InceptionBlock(480, 192, 96, 208, 16, 48, 64)
            self.i4b = _InceptionBlock(512, 160, 112, 224, 24, 64, 64)
            self.i4c = _InceptionBlock(512, 128, 128, 256, 24, 64, 64)
            self.i4d = _InceptionBlock(512, 112, 144, 288, 32, 64, 64)
            self.i4e = _InceptionBlock(528, 256, 160, 320, 32, 128, 128)
            self.pool4 = MaxPool2D(3, 2, 1)
            self.i5a = _InceptionBlock(832, 256, 160, 320, 32, 128, 128)
            self.i5b = _InceptionBlock(832, 384, 192, 384, 48, 128, 128)
            self.avg = AdaptiveAvgPool2D(1)
            self.drop = Dropout(0.4)
            self.fc = Linear(1024, num_classes, bias=True)
            if with_aux:
                self.aux1 = _AuxHead(512, num_classes)
                self.aux2 = _AuxHead(528, num_classes)
        seed_model(self, dtype, seed)

    def forward(self, x):
        aux = self.with_aux and self.training
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4a(x)
        a1 = self.aux1(x) if aux else None
        x = self.i4d(self.i4c(self.i4b(x)))
        a2 = self.aux2(x) if aux else None
        x = self.pool4(self.i4e(x))
        x = F.flatten(self.avg(self.i5b(self.i5a(x))), 1)
        out = self.fc(self.drop(x))
        return (out, a1, a2) if aux else out


def googlenet(pretrained=False, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled; load a "
                         "state_dict explicitly")
    return GoogLeNet(**kwargs)


# ============================================================== InceptionV3
class _InceptionA(nn.Module):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.b1 = ConvBNReLU(cin, 64, 1)
        self.b5 = Sequential(ConvBNReLU(cin, 48, 1),
                             ConvBNReLU(48, 64, 5, padding=2))
        self.b3 = Sequential(ConvBNReLU(cin, 64, 1),
                             ConvBNReLU(64, 96, 3, padding=1),
                             ConvBNReLU(96, 96, 3, padding=1))
        self.bp = Sequential(AvgPool2D(3, 1, 1),
                             ConvBNReLU(cin, pool_features, 1))

    def forward(self, x):
        return F.concat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)], 1)


class _InceptionB(nn.Module):
    """Grid reduction 35x35 -> 17x17."""

    def __init__(self, cin):
        super().__init__()
        self.b3 = ConvBNReLU(cin, 384, 3, 2)
        self.b33 = Sequential(ConvBNReLU(cin, 64, 1),
                              ConvBNReLU(64, 96, 3, padding=1),
                              ConvBNReLU(96, 96, 3, 2))
        self.bp = MaxPool2D(3, 2)

    def forward(self, x):
        return F.concat([self.b3(x), self.b33(x), self.bp(x)], 1)


class _InceptionC(nn.Module):
    """Factorized 7x7 block."""

    def __init__(self, cin, c7):
        super().__init__()
        self.b1 = ConvBNReLU(cin, 192, 1)
        self.b7 = Sequential(
            ConvBNReLU(cin, c7, 1),
            ConvBNReLU(c7, c7, (1, 7), padding=(0, 3)),
            ConvBNReLU(c7, 192, (7, 1), padding=(3, 0)))
        self.b77 = Sequential(
            ConvBNReLU(cin, c7, 1),
            ConvBNReLU(c7, c7, (7, 1), padding=(3, 0)),
            ConvBNReLU(c7, c7, (1, 7), padding=(0, 3)),
            ConvBNReLU(c7, c7, (7, 1), padding=(3, 0)),
            ConvBNReLU(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = Sequential(AvgPool2D(3, 1, 1), ConvBNReLU(cin, 192, 1))

    def forward(self, x):
        return F.concat([self.b1(x), self.b7(x), self.b77(x), self.bp(x)],
                        1)


class _InceptionD(nn.Module):
    """Grid reduction 17x17 -> 8x8."""

    def __init__(self, cin):
        super().__init__()
        self.b3 = Sequential(ConvBNReLU(cin, 192, 1),
                             ConvBNReLU(192, 320, 3, 2))
        self.b7 = Sequential(
            ConvBNReLU(cin, 192, 1),
            ConvBNReLU(192, 192, (1, 7), padding=(0, 3)),
            ConvBNReLU(192, 192, (7, 1), padding=(3, 0)),
            ConvBNReLU(192, 192, 3, 2))
        self.bp = MaxPool2D(3, 2)

    def forward(self, x):
        return F.concat([self.b3(x), self.b7(x), self.bp(x)], 1)


class _InceptionE(nn.Module):
    """Expanded 8x8 block with split 3x1/1x3 branches."""

    def __init__(self, cin):
        super().__init__()
        self.b1 = ConvBNReLU(cin, 320, 1)
        self.b3_1 = ConvBNReLU(cin, 384, 1)
        self.b3_2a = ConvBNReLU(384, 384, (1, 3), padding=(0, 1))
        self.b3_2b = ConvBNReLU(384, 384, (3, 1), padding=(1, 0))
        self.b33_1 = Sequential(ConvBNReLU(cin, 448, 1),
                                ConvBNReLU(448, 384, 3, padding=1))
        self.b33_2a = ConvBNReLU(384, 384, (1, 3), padding=(0, 1))
        self.b33_2b = ConvBNReLU(384, 384, (3, 1), padding=(1, 0))
        self.bp = Sequential(AvgPool2D(3, 1, 1), ConvBNReLU(cin, 192, 1))

    def forward(self, x):
        b3 = self.b3_1(x)
        b33 = self.b33_1(x)
        return F.concat([
            self.b1(x),
            F.concat([self.b3_2a(b3), self.b3_2b(b3)], 1),
            F.concat([self.b33_2a(b33), self.b33_2b(b33)], 1),
            self.bp(x)], 1)


class InceptionV3(nn.Module):
    def __init__(self, num_classes=1000, with_pool=True, device="cuda",
                 dtype=None, seed=0):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.stem = Sequential(
                ConvBNReLU(3, 32, 3, 2), ConvBNReLU(32, 32, 3),
                ConvBNReLU(32, 64, 3, padding=1), MaxPool2D(3, 2),
                ConvBNReLU(64, 80, 1), ConvBNReLU(80, 192, 3),
                MaxPool2D(3, 2))
            self.blocks = Sequential(
                _InceptionA(192, 32), _InceptionA(256, 64),
                _InceptionA(288, 64), _InceptionB(288),
                _InceptionC(768, 128), _InceptionC(768, 160),
                _InceptionC(768, 160), _InceptionC(768, 192),
                _InceptionD(768), _InceptionE(1280), _InceptionE(2048))
            self.avg = AdaptiveAvgPool2D(1)
            self.drop = Dropout(0.2)
            self.fc = Linear(2048, num_classes, bias=True)
        seed_model(self, dtype, seed)

    def forward(self, x):
        x = F.flatten(self.avg(self.blocks(self.stem(x))), 1)
        return self.fc(self.drop(x))


def inception_v3(pretrained=False, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled; load a "
                         "state_dict explicitly")
    return InceptionV3(**kwargs)
