"""LeNet, AlexNet, VGG and SqueezeNet (port of
paddle_tpu/vision/models/small_nets.py): the same layers, names and
heads.  Every model takes ``device`` (default the card), ``dtype`` and
``seed``: the weights are drawn on ``device`` from ``seed`` by the JAX
initializers' laws, and its dropouts draw from the model's own
``generator`` (``nn.layer.layers.seed_model``); ``seed=None`` leaves the
draws to a caller that loads weights
(``models.convert.vision_params_from_numpy``)."""
from __future__ import annotations

import torch
from torch import nn

from ..._device import resolve_device
from ...nn import functional as F
from ...nn.layer.activation import ReLU
from ...nn.layer.common import Dropout, Linear
from ...nn.layer.conv_pool import AdaptiveAvgPool2D, Conv2D, MaxPool2D
from ...nn.layer.layers import Sequential, seed_model
from ...nn.layer.norm import BatchNorm2D

__all__ = ["LeNet", "AlexNet", "VGG", "SqueezeNet", "alexnet", "vgg11",
           "vgg13", "vgg16", "vgg19", "squeezenet1_0", "squeezenet1_1"]


class LeNet(nn.Module):
    """The reference's LeNet (28 x 28 single-channel input)."""

    def __init__(self, num_classes=10, device="cuda", dtype=None, seed=0):
        super().__init__()
        self.num_classes = num_classes
        with torch.device(resolve_device(device)):
            self.features = Sequential(
                Conv2D(1, 6, 3, stride=1, padding=1), ReLU(),
                MaxPool2D(2, 2),
                Conv2D(6, 16, 5, stride=1, padding=0), ReLU(),
                MaxPool2D(2, 2))
            if num_classes > 0:
                self.fc = Sequential(Linear(400, 120, bias=True),
                                     Linear(120, 84, bias=True),
                                     Linear(84, num_classes, bias=True))
        seed_model(self, dtype, seed)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x


class AlexNet(nn.Module):
    """The reference's AlexNet."""

    def __init__(self, num_classes=1000, dropout=0.5, device="cuda",
                 dtype=None, seed=0):
        super().__init__()
        self.num_classes = num_classes
        with torch.device(resolve_device(device)):
            self.features = Sequential(
                Conv2D(3, 64, 11, stride=4, padding=2), ReLU(),
                MaxPool2D(3, 2),
                Conv2D(64, 192, 5, padding=2), ReLU(),
                MaxPool2D(3, 2),
                Conv2D(192, 384, 3, padding=1), ReLU(),
                Conv2D(384, 256, 3, padding=1), ReLU(),
                Conv2D(256, 256, 3, padding=1), ReLU(),
                MaxPool2D(3, 2))
            self.avgpool = AdaptiveAvgPool2D(6)
            if num_classes > 0:
                self.classifier = Sequential(
                    Dropout(dropout), Linear(256 * 6 * 6, 4096, bias=True),
                    ReLU(), Dropout(dropout),
                    Linear(4096, 4096, bias=True), ReLU(),
                    Linear(4096, num_classes, bias=True))
        seed_model(self, dtype, seed)

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(F.flatten(x, 1))
        return x


_VGG_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def _vgg_features(cfg, batch_norm):
    layers = []
    in_ch = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            layers.append(Conv2D(in_ch, v, 3, padding=1))
            if batch_norm:
                layers.append(BatchNorm2D(v))
            layers.append(ReLU())
            in_ch = v
    return Sequential(*layers)


class VGG(nn.Module):
    """The reference's VGG over ``features`` (a ``Sequential``, or the
    name of a configuration, "A" / "B" / "D" / "E", built here on
    ``device`` with ``batch_norm``)."""

    def __init__(self, features, num_classes=1000, with_pool=True,
                 batch_norm=False, device="cuda", dtype=None, seed=0):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        with torch.device(resolve_device(device)):
            self.features = _vgg_features(_VGG_CFGS[features], batch_norm) \
                if isinstance(features, str) else features
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D(7)
            if num_classes > 0:
                self.classifier = Sequential(
                    Linear(512 * 7 * 7, 4096, bias=True), ReLU(), Dropout(),
                    Linear(4096, 4096, bias=True), ReLU(), Dropout(),
                    Linear(4096, num_classes, bias=True))
        seed_model(self, dtype, seed)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(F.flatten(x, 1))
        return x


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return VGG("A", batch_norm=batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return VGG("B", batch_norm=batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return VGG("D", batch_norm=batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return VGG("E", batch_norm=batch_norm, **kwargs)


def alexnet(pretrained=False, **kwargs):
    return AlexNet(**kwargs)


class _Fire(nn.Module):
    def __init__(self, in_ch, squeeze, e1, e3):
        super().__init__()
        self.squeeze = Sequential(Conv2D(in_ch, squeeze, 1), ReLU())
        self.expand1 = Sequential(Conv2D(squeeze, e1, 1), ReLU())
        self.expand3 = Sequential(Conv2D(squeeze, e3, 3, padding=1), ReLU())

    def forward(self, x):
        s = self.squeeze(x)
        return F.concat([self.expand1(s), self.expand3(s)], 1)


class SqueezeNet(nn.Module):
    """The reference's SqueezeNet, ``version`` "1.0" or "1.1"."""

    def __init__(self, version="1.0", num_classes=1000, with_pool=True,
                 device="cuda", dtype=None, seed=0):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        with torch.device(resolve_device(device)):
            if version == "1.0":
                self.features = Sequential(
                    Conv2D(3, 96, 7, stride=2), ReLU(), MaxPool2D(3, 2),
                    _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                    _Fire(128, 32, 128, 128), MaxPool2D(3, 2),
                    _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                    _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                    MaxPool2D(3, 2), _Fire(512, 64, 256, 256))
            else:
                self.features = Sequential(
                    Conv2D(3, 64, 3, stride=2), ReLU(), MaxPool2D(3, 2),
                    _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                    MaxPool2D(3, 2),
                    _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                    MaxPool2D(3, 2),
                    _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                    _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256))
            if num_classes > 0:
                self.classifier = Sequential(
                    Dropout(0.5), Conv2D(512, num_classes, 1), ReLU())
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D(1)
        seed_model(self, dtype, seed)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.avgpool(x)
        return F.flatten(x, 1)


def squeezenet1_0(pretrained=False, **kwargs):
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return SqueezeNet("1.1", **kwargs)
