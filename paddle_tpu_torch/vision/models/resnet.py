"""ResNet family (↔ paddle_tpu/vision/models/resnet.py): `BasicBlock`,
`BottleneckBlock`, `ResNet` and its constructors, resnet18 ... 152, the
ResNeXt (`groups`, `width`) and wide (`width` 128) forms.

NCHW at the API. The convs are `nn.Conv2D` (cuDNN on the card: the
reference's convs are XLA convolutions, not Pallas kernels), the norms
`nn.BatchNorm2D` with Paddle's running statistics, the residual add and
ReLU cast for AMP as the reference's ops. Weights come from an explicit
`torch.Generator` seeded by `seed` with Paddle's default initializers;
cross-package tests copy the JAX weights and statistics with
`convert.load_paddle_tpu_state`. `pretrained=True` raises, as in the
reference: no weights are bundled.
"""

from __future__ import annotations

import torch
from torch import nn

from ... import amp
from ... import nn as pnn
from ...device import resolve_device
from ...nn.layer.layers import Layer

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
           "resnext101_32x8d", "wide_resnet50_2", "wide_resnet101_2"]


def _add(a, b):
    return torch.add(*amp.cast_inputs("add", a, b))


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        norm_layer = norm_layer or pnn.BatchNorm2D
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.conv1 = pnn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                                bias_attr=False, **kw)
        self.bn1 = norm_layer(planes, device=device, dtype=dtype)
        self.relu = pnn.ReLU()
        self.conv2 = pnn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                                **kw)
        self.bn2 = norm_layer(planes, device=device, dtype=dtype)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(_add(out, identity))


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        norm_layer = norm_layer or pnn.BatchNorm2D
        kw = dict(generator=generator, device=device, dtype=dtype)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = pnn.Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = norm_layer(width, device=device, dtype=dtype)
        self.conv2 = pnn.Conv2D(width, width, 3, stride=stride,
                                padding=dilation, dilation=dilation,
                                groups=groups, bias_attr=False, **kw)
        self.bn2 = norm_layer(width, device=device, dtype=dtype)
        self.conv3 = pnn.Conv2D(width, planes * self.expansion, 1,
                                bias_attr=False, **kw)
        self.bn3 = norm_layer(planes * self.expansion, device=device,
                              dtype=dtype)
        self.relu = pnn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(_add(out, identity))


class ResNet(Layer):
    _LAYERS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
               101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, *, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self._kw = dict(generator=gen, device=dev, dtype=dtype)
        layers = self._LAYERS[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = pnn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                                bias_attr=False, **self._kw)
        self.bn1 = pnn.BatchNorm2D(self.inplanes, device=dev, dtype=dtype)
        self.relu = pnn.ReLU()
        self.maxpool = pnn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = pnn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = pnn.Linear(512 * block.expansion, num_classes,
                                 **self._kw)
        del self._kw

    def _make_layer(self, block, planes, blocks, stride=1):
        kw = self._kw
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = pnn.Sequential(
                pnn.Conv2D(self.inplanes, planes * block.expansion, 1,
                           stride=stride, bias_attr=False, **kw),
                pnn.BatchNorm2D(planes * block.expansion,
                                device=kw["device"], dtype=kw["dtype"]))
        layers = [block(self.inplanes, planes, stride, downsample, self.groups,
                        self.base_width, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, **kw))
        return pnn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            (x,) = amp.cast_inputs("flatten", x)
            x = self.fc(torch.flatten(x, 1))
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError(
            "pretrained weights are not bundled; load a checkpoint with "
            "convert.load_paddle_tpu_state or model.load_state_dict")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, groups=32, width=4, **kwargs)


def resnext101_32x8d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, groups=32, width=8,
                   **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, width=128, **kwargs)
