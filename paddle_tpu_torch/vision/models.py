"""LeNet and the ResNet family (port of ``paddle_tpu/vision/models.py``
``:12-143``).

NCHW throughout. Attribute names follow the JAX models, so
``state_dict()`` keys, the batch norms' ``_mean``/``_variance`` buffers
included, equal the JAX model's one to one and :func:`load_numpy_state`
carries weights across by name. A block's residual sum is ``F.add``,
the JAX ``add`` op. Every layer is built on ``device``
(``None``: CUDA, raising without a GPU) from ``generator`` (``None``:
the device's global generator).
"""
from __future__ import annotations

from .. import nn
from .._device import resolve_device
from ..nn import functional as F
from ..nn.layer import load_numpy_state

__all__ = ["LeNet", "BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "load_numpy_state"]


class LeNet(nn.Layer):
    def __init__(self, num_classes=10, device=None, generator=None):
        super().__init__()
        kw = {"device": resolve_device(device), "generator": generator}
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1, **kw),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0, **kw),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
        )
        self.fc = nn.Sequential(
            nn.Linear(400, 120, **kw),
            nn.Linear(120, 84, **kw),
            nn.Linear(84, num_classes, **kw),
        )

    def forward(self, x):
        return self.fc(F.flatten(self.features(x), 1))


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 device=None, generator=None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, **kw)
        self.bn1 = nn.BatchNorm2D(planes, **kw)
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               **kw)
        self.bn2 = nn.BatchNorm2D(planes, **kw)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(F.add(out, identity))


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 device=None, generator=None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.conv1 = nn.Conv2D(inplanes, planes, 1, bias_attr=False, **kw)
        self.bn1 = nn.BatchNorm2D(planes, **kw)
        self.conv2 = nn.Conv2D(planes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, **kw)
        self.bn2 = nn.BatchNorm2D(planes, **kw)
        self.conv3 = nn.Conv2D(planes, planes * 4, 1, bias_attr=False, **kw)
        self.bn3 = nn.BatchNorm2D(planes * 4, **kw)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(F.add(out, identity))


class ResNet(nn.Layer):
    """Stem (7x7/2 conv, batch norm, ReLU, 3x3/2 max pool), four stages
    of ``block`` x ``depth_cfg``, global average pool, linear head."""

    def __init__(self, block, depth_cfg, num_classes=1000, with_pool=True,
                 device=None, generator=None):
        super().__init__()
        kw = {"device": resolve_device(device), "generator": generator}
        self.inplanes = 64
        self.conv1 = nn.Conv2D(3, 64, 7, stride=2, padding=3, bias_attr=False,
                               **kw)
        self.bn1 = nn.BatchNorm2D(64, **kw)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, depth_cfg[0], **kw)
        self.layer2 = self._make_layer(block, 128, depth_cfg[1], 2, **kw)
        self.layer3 = self._make_layer(block, 256, depth_cfg[2], 2, **kw)
        self.layer4 = self._make_layer(block, 512, depth_cfg[3], 2, **kw)
        self.avgpool = nn.AdaptiveAvgPool2D(1)
        self.fc = nn.Linear(512 * block.expansion, num_classes, **kw)

    def _make_layer(self, block, planes, blocks, stride=1, **kw):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, **kw),
                nn.BatchNorm2D(planes * block.expansion, **kw),
            )
        layers = [block(self.inplanes, planes, stride, downsample, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, **kw))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        x = self.avgpool(x)
        return self.fc(F.flatten(x, 1))


def resnet18(num_classes=1000, **kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes, **kw)


def resnet34(num_classes=1000, **kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes, **kw)


def resnet50(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 4, 6, 3], num_classes, **kw)


def resnet101(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 4, 23, 3], num_classes, **kw)


def resnet152(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 8, 36, 3], num_classes, **kw)
