"""MobileNet V1 / V2 / V3, ShuffleNetV2 and DenseNet (port of
paddle_tpu/vision/models/mobilenets.py): the same layers, names, width
multipliers and heads.  The depthwise and grouped convolutions are
``Conv2D(..., groups=)``, which runs cuDNN under the port's deterministic
flags as every convolution does.  ``device``, ``dtype``, ``seed`` and the
dropout ``generator`` as in ``small_nets.py``."""
from __future__ import annotations

import torch
from torch import nn

from ..._device import resolve_device
from ...nn import functional as F
from ...nn.layer.activation import Hardsigmoid, Hardswish, ReLU, ReLU6, Swish
from ...nn.layer.common import Dropout, Linear
from ...nn.layer.conv_pool import (AdaptiveAvgPool2D, AvgPool2D, Conv2D,
                                   MaxPool2D)
from ...nn.layer.layers import Sequential, seed_model
from ...nn.layer.norm import BatchNorm2D

__all__ = ["MobileNetV1", "MobileNetV2", "MobileNetV3Small",
           "MobileNetV3Large", "ShuffleNetV2", "DenseNet",
           "mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small",
           "mobilenet_v3_large", "shufflenet_v2_x1_0", "densenet121"]


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _conv_bn(in_ch, out_ch, k, stride=1, groups=1, act=ReLU):
    pad = (k - 1) // 2
    layers = [Conv2D(in_ch, out_ch, k, stride=stride, padding=pad,
                     groups=groups, bias_attr=False), BatchNorm2D(out_ch)]
    if act is not None:
        layers.append(act())
    return Sequential(*layers)


class _Head(nn.Module):
    """What the families share: the optional global pool, then the
    classifier on the flattened features when ``num_classes`` > 0."""

    def _head(self, x):
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(F.flatten(x, 1))
        return x


class MobileNetV1(_Head):
    """Depthwise-separable stacks."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device="cuda", dtype=None, seed=0):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return int(ch * scale)

        cfg = [  # (out, stride) per depthwise-separable block
            (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
            (1024, 1)]
        with torch.device(resolve_device(device)):
            layers = [_conv_bn(3, c(32), 3, stride=2)]
            in_ch = c(32)
            for out, s in cfg:
                layers.append(_conv_bn(in_ch, in_ch, 3, stride=s,
                                       groups=in_ch))          # depthwise
                layers.append(_conv_bn(in_ch, c(out), 1))      # pointwise
                in_ch = c(out)
            self.features = Sequential(*layers)
            if with_pool:
                self.pool = AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.fc = Linear(c(1024), num_classes, bias=True)
        seed_model(self, dtype, seed)

    @property
    def classifier(self):
        return self.fc

    def forward(self, x):
        return self._head(self.features(x))


class _InvertedResidual(nn.Module):
    def __init__(self, in_ch, out_ch, stride, expand_ratio):
        super().__init__()
        hidden = int(round(in_ch * expand_ratio))
        self.use_res = stride == 1 and in_ch == out_ch
        layers = []
        if expand_ratio != 1:
            layers.append(_conv_bn(in_ch, hidden, 1, act=ReLU6))
        layers += [
            _conv_bn(hidden, hidden, 3, stride=stride, groups=hidden,
                     act=ReLU6),
            _conv_bn(hidden, out_ch, 1, act=None),
        ]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return F.add(x, out) if self.use_res else out


class MobileNetV2(_Head):
    """Inverted residuals."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device="cuda", dtype=None, seed=0):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [  # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_ch = _make_divisible(32 * scale)
        last = _make_divisible(1280 * max(1.0, scale))
        with torch.device(resolve_device(device)):
            layers = [_conv_bn(3, in_ch, 3, stride=2, act=ReLU6)]
            for t, c, n, s in cfg:
                out_ch = _make_divisible(c * scale)
                for i in range(n):
                    layers.append(_InvertedResidual(
                        in_ch, out_ch, s if i == 0 else 1, t))
                    in_ch = out_ch
            layers.append(_conv_bn(in_ch, last, 1, act=ReLU6))
            self.features = Sequential(*layers)
            if with_pool:
                self.pool = AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.classifier = Sequential(
                    Dropout(0.2), Linear(last, num_classes, bias=True))
        seed_model(self, dtype, seed)

    def forward(self, x):
        return self._head(self.features(x))


class _SqueezeExcite(nn.Module):
    def __init__(self, ch, reduce=4):
        super().__init__()
        mid = _make_divisible(ch // reduce)
        self.pool = AdaptiveAvgPool2D(1)
        self.fc1 = Conv2D(ch, mid, 1)
        self.fc2 = Conv2D(mid, ch, 1)
        self.relu = ReLU()
        self.hsig = Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return F.multiply(x, s)


class _MBV3Block(nn.Module):
    def __init__(self, in_ch, mid, out_ch, k, stride, se, act):
        super().__init__()
        self.use_res = stride == 1 and in_ch == out_ch
        layers = []
        if mid != in_ch:
            layers.append(_conv_bn(in_ch, mid, 1, act=act))
        layers.append(_conv_bn(mid, mid, k, stride=stride, groups=mid,
                               act=act))
        if se:
            layers.append(_SqueezeExcite(mid))
        layers.append(_conv_bn(mid, out_ch, 1, act=None))
        self.block = Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return F.add(x, out) if self.use_res else out


_MBV3_SMALL = [  # k, mid, out, se, act, stride
    (3, 16, 16, True, ReLU, 2), (3, 72, 24, False, ReLU, 2),
    (3, 88, 24, False, ReLU, 1), (5, 96, 40, True, Hardswish, 2),
    (5, 240, 40, True, Hardswish, 1), (5, 240, 40, True, Hardswish, 1),
    (5, 120, 48, True, Hardswish, 1), (5, 144, 48, True, Hardswish, 1),
    (5, 288, 96, True, Hardswish, 2), (5, 576, 96, True, Hardswish, 1),
    (5, 576, 96, True, Hardswish, 1)]
_MBV3_LARGE = [
    (3, 16, 16, False, ReLU, 1), (3, 64, 24, False, ReLU, 2),
    (3, 72, 24, False, ReLU, 1), (5, 72, 40, True, ReLU, 2),
    (5, 120, 40, True, ReLU, 1), (5, 120, 40, True, ReLU, 1),
    (3, 240, 80, False, Hardswish, 2), (3, 200, 80, False, Hardswish, 1),
    (3, 184, 80, False, Hardswish, 1), (3, 184, 80, False, Hardswish, 1),
    (3, 480, 112, True, Hardswish, 1), (3, 672, 112, True, Hardswish, 1),
    (5, 672, 160, True, Hardswish, 2), (5, 960, 160, True, Hardswish, 1),
    (5, 960, 160, True, Hardswish, 1)]


class _MobileNetV3(_Head):
    def __init__(self, cfg, last_mid, last_ch, scale=1.0, num_classes=1000,
                 with_pool=True, device="cuda", dtype=None, seed=0):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        with torch.device(resolve_device(device)):
            in_ch = _make_divisible(16 * scale)
            layers = [_conv_bn(3, in_ch, 3, stride=2, act=Hardswish)]
            for k, mid, out, se, act, s in cfg:
                layers.append(_MBV3Block(
                    in_ch, _make_divisible(mid * scale),
                    _make_divisible(out * scale), k, s, se, act))
                in_ch = _make_divisible(out * scale)
            layers.append(_conv_bn(in_ch, _make_divisible(last_mid * scale),
                                   1, act=Hardswish))
            self.features = Sequential(*layers)
            if with_pool:
                self.pool = AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.classifier = Sequential(
                    Linear(_make_divisible(last_mid * scale), last_ch,
                           bias=True),
                    Hardswish(), Dropout(0.2),
                    Linear(last_ch, num_classes, bias=True))
        seed_model(self, dtype, seed)

    def forward(self, x):
        return self._head(self.features(x))


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 **kwargs):
        super().__init__(_MBV3_SMALL, 576, 1024, scale, num_classes,
                         with_pool, **kwargs)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 **kwargs):
        super().__init__(_MBV3_LARGE, 960, 1280, scale, num_classes,
                         with_pool, **kwargs)


def _channel_shuffle(x, groups):
    """Channels [g0 c0, g0 c1, ..., g1 c0, ...] reordered to [g0 c0, g1
    c0, ..., g0 c1, ...] (reshape, swap the two channel axes, reshape)."""
    b, c, h, w = x.shape
    x = x.reshape(b, groups, c // groups, h, w).transpose(1, 2)
    return x.reshape(b, c, h, w)


class _ShuffleUnit(nn.Module):
    def __init__(self, in_ch, out_ch, stride, act=ReLU):
        super().__init__()
        self.stride = stride
        branch = out_ch // 2
        if stride == 1:
            self.branch2 = Sequential(
                _conv_bn(in_ch // 2, branch, 1, act=act),
                _conv_bn(branch, branch, 3, stride=1, groups=branch,
                         act=None),
                _conv_bn(branch, branch, 1, act=act))
        else:
            self.branch1 = Sequential(
                _conv_bn(in_ch, in_ch, 3, stride=stride, groups=in_ch,
                         act=None),
                _conv_bn(in_ch, branch, 1, act=act))
            self.branch2 = Sequential(
                _conv_bn(in_ch, branch, 1, act=act),
                _conv_bn(branch, branch, 3, stride=stride, groups=branch,
                         act=None),
                _conv_bn(branch, branch, 1, act=act))

    def forward(self, x):
        if self.stride == 1:
            half = x.shape[1] // 2
            out = F.concat([x[:, :half], self.branch2(x[:, half:])], 1)
        else:
            out = F.concat([self.branch1(x), self.branch2(x)], 1)
        return _channel_shuffle(out, 2)


class ShuffleNetV2(_Head):
    _WIDTH = {0.25: [24, 48, 96, 512], 0.33: [32, 64, 128, 512],
              0.5: [48, 96, 192, 1024], 1.0: [116, 232, 464, 1024],
              1.5: [176, 352, 704, 1024], 2.0: [244, 488, 976, 2048]}

    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, device="cuda", dtype=None, seed=0):
        super().__init__()
        act_layer = Swish if act == "swish" else ReLU
        self.num_classes = num_classes
        self.with_pool = with_pool
        widths = self._WIDTH[scale]
        with torch.device(resolve_device(device)):
            self.conv1 = _conv_bn(3, 24, 3, stride=2, act=act_layer)
            self.maxpool = MaxPool2D(3, 2, padding=1)
            in_ch = 24
            stages = []
            for i, repeats in enumerate([4, 8, 4]):
                out_ch = widths[i]
                units = [_ShuffleUnit(in_ch, out_ch, 2, act=act_layer)]
                for _ in range(repeats - 1):
                    units.append(_ShuffleUnit(out_ch, out_ch, 1,
                                              act=act_layer))
                stages.append(Sequential(*units))
                in_ch = out_ch
            self.stages = Sequential(*stages)
            self.conv_last = _conv_bn(in_ch, widths[3], 1, act=act_layer)
            if with_pool:
                self.pool = AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.fc = Linear(widths[3], num_classes, bias=True)
        seed_model(self, dtype, seed)

    @property
    def classifier(self):
        return self.fc

    def forward(self, x):
        x = self.conv_last(self.stages(self.maxpool(self.conv1(x))))
        return self._head(x)


class _DenseLayer(nn.Module):
    def __init__(self, in_ch, growth, bn_size):
        super().__init__()
        self.block = Sequential(
            BatchNorm2D(in_ch), ReLU(),
            Conv2D(in_ch, bn_size * growth, 1, bias_attr=False),
            BatchNorm2D(bn_size * growth), ReLU(),
            Conv2D(bn_size * growth, growth, 3, padding=1, bias_attr=False))

    def forward(self, x):
        return F.concat([x, self.block(x)], 1)


class DenseNet(_Head):
    """121 / 161 / 169 / 201 / 264 layers by ``block_config``."""

    _CONFIGS = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24),
                169: (6, 12, 32, 32), 201: (6, 12, 48, 32),
                264: (6, 12, 64, 48)}

    def __init__(self, layers=121, growth_rate=32, bn_size=4,
                 num_classes=1000, with_pool=True, device="cuda",
                 dtype=None, seed=0):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        block_config = self._CONFIGS[layers]
        ch = 2 * growth_rate
        with torch.device(resolve_device(device)):
            feats = [Conv2D(3, ch, 7, stride=2, padding=3, bias_attr=False),
                     BatchNorm2D(ch), ReLU(), MaxPool2D(3, 2, padding=1)]
            for bi, n in enumerate(block_config):
                for _ in range(n):
                    feats.append(_DenseLayer(ch, growth_rate, bn_size))
                    ch += growth_rate
                if bi != len(block_config) - 1:   # transition
                    feats += [BatchNorm2D(ch), ReLU(),
                              Conv2D(ch, ch // 2, 1, bias_attr=False),
                              AvgPool2D(2, 2)]
                    ch //= 2
            feats += [BatchNorm2D(ch), ReLU()]
            self.features = Sequential(*feats)
            if with_pool:
                self.pool = AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.classifier = Linear(ch, num_classes, bias=True)
        seed_model(self, dtype, seed)

    def forward(self, x):
        return self._head(self.features(x))


# ---------------------------------------------------------------- factories
def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Large(scale=scale, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.0, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return DenseNet(layers=121, **kwargs)


def densenet161(pretrained=False, **kwargs):
    # reference densenet161: growth 48, 96-ch stem
    return DenseNet(layers=161, growth_rate=48, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return DenseNet(layers=169, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return DenseNet(layers=201, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return DenseNet(layers=264, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.25, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.33, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.5, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.5, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=2.0, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.0, act="swish", **kwargs)
