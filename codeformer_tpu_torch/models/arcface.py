"""ResNetArcFace identity network in PyTorch (counterpart of
codeformer_tpu/models/arcface.py; reference basicsr/archs/arcface_arch.py):
an IRBlock/SEBlock ResNet over 1-channel 128x128 faces to a 512-d
embedding. Registered for parity with the reference surface; no shipped
config uses it (the identity-loss hook of the GFPGAN lineage). The module
names are the reference `.pth` names; flax's (`layer1_0`, `se.fc_0`)
cross with `flax_to_state_dict(..., like=model.state_dict())`, PReLU's
`scale` as its `weight`.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY


def conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class SEBlock(nn.Module):
    """Squeeze-and-excitation (arcface_arch.py:149-170): fc is Linear,
    PReLU, Linear, Sigmoid."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.avg_pool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Sequential(nn.Linear(channel, channel // reduction),
                                nn.PReLU(),
                                nn.Linear(channel // reduction, channel),
                                nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        y = self.fc(self.avg_pool(x).view(b, c)).view(b, c, 1, 1)
        return x * y


class IRBlock(nn.Module):
    """Improved residual block (arcface_arch.py:56-101): BN, conv, BN,
    PReLU, strided conv, BN, SE, plus the (downsampled) input, then the
    same PReLU."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: nn.Module | None = None, use_se: bool = True):
        super().__init__()
        self.bn0 = nn.BatchNorm2d(inplanes)
        self.conv1 = conv3x3(inplanes, inplanes)
        self.bn1 = nn.BatchNorm2d(inplanes)
        self.prelu = nn.PReLU()
        self.conv2 = conv3x3(inplanes, planes, stride)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample
        self.use_se = use_se
        if use_se:
            self.se = SEBlock(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.prelu(self.bn1(self.conv1(self.bn0(x))))
        out = self.bn2(self.conv2(out))
        if self.use_se:
            out = self.se(out)
        residual = x if self.downsample is None else self.downsample(x)
        return self.prelu(out + residual)


@ARCH_REGISTRY.register()
class ResNetArcFace(nn.Module):
    """ArcFace ResNet (arcface_arch.py:172-243): (B, 1, 128, 128)
    grayscale -> (B, 512) embedding. Only IRBlock ships."""

    def __init__(self, block: str = 'IRBlock',
                 layers: Sequence[int] = (2, 2, 2, 2), use_se: bool = True):
        super().__init__()
        if block != 'IRBlock':
            raise ValueError(f'block {block!r}: only IRBlock ships')
        self.inplanes = 64
        self.use_se = use_se
        self.conv1 = nn.Conv2d(1, 64, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.prelu = nn.PReLU()
        self.maxpool = nn.MaxPool2d(2, 2)
        self.layer1 = self._make_layer(64, layers[0])
        self.layer2 = self._make_layer(128, layers[1], stride=2)
        self.layer3 = self._make_layer(256, layers[2], stride=2)
        self.layer4 = self._make_layer(512, layers[3], stride=2)
        self.bn4 = nn.BatchNorm2d(512)
        self.dropout = nn.Dropout()
        self.fc5 = nn.Linear(512 * 8 * 8, 512)
        self.bn5 = nn.BatchNorm1d(512)

    def _make_layer(self, planes: int, blocks: int,
                    stride: int = 1) -> nn.Sequential:
        downsample = None
        if stride != 1 or self.inplanes != planes:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes, 1, stride=stride,
                          bias=False),
                nn.BatchNorm2d(planes))
        layers = [IRBlock(self.inplanes, planes, stride, downsample,
                          use_se=self.use_se)]
        self.inplanes = planes
        layers += [IRBlock(planes, planes, use_se=self.use_se)
                   for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.prelu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.dropout(self.bn4(x))
        return self.bn5(self.fc5(x.flatten(1)))
