"""RetinaFace face detector, counterpart of
codeformer_tpu/models/retinaface.py (the reference's
facelib/detection/retinaface/{retinaface.py,retinaface_net.py}):
ResNet50 or MobileNetV1 x0.25 body with taps at strides 8/16/32, an FPN
with nearest-upsample merges, three SSH context modules and 1x1 heads
over 2 anchors a cell.

NCHW inside; the heads are flattened in the JAX (NHWC) anchor order,
which is the reference's permute(0, 2, 3, 1). Module names are the
reference `.pth` names (`body.layer1.0.conv1`, `fpn.output1.0`,
`ssh1.conv5X5_1.0`, `ClassHead.0.conv1x1`, ...), so released weights and
`flax_to_state_dict` of the JAX variables load strictly. BatchNorm runs
from its running statistics (the model is built for eval).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY


def _act(leaky: float) -> nn.Module:
    return nn.LeakyReLU(leaky) if leaky > 0 else nn.ReLU()


def conv_bn(cin, cout, kernel=3, stride=1, leaky=0.0, relu=True):
    """conv + BN (+ leaky relu): the reference's conv_bn /
    conv_bn_no_relu / conv_bn1X1 (retinaface_net.py:6-22)."""
    layers = [nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2,
                        bias=False), nn.BatchNorm2d(cout)]
    if relu:
        layers.append(_act(leaky))
    return nn.Sequential(*layers)


def conv_dw(cin, cout, stride=1, leaky=0.1):
    """Depthwise-separable block of MobileNetV1 (retinaface_net.py:25-33):
    indices 0, 1, 3, 4 hold the parameters."""
    return nn.Sequential(
        nn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False),
        nn.BatchNorm2d(cin), nn.LeakyReLU(leaky),
        nn.Conv2d(cin, cout, 1, 1, 0, bias=False),
        nn.BatchNorm2d(cout), nn.LeakyReLU(leaky))


class Bottleneck(nn.Module):
    """torchvision ResNet bottleneck (1x1 -> 3x3 with the stride -> 1x1
    x4)."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
            nn.BatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class ResNet50Body(nn.Module):
    """ResNet50 trunk returning (layer2, layer3, layer4), the
    IntermediateLayerGetter taps of the reference (retinaface.py:95-98)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for name, planes, blocks, stride in (('layer1', 64, 3, 1),
                                             ('layer2', 128, 4, 2),
                                             ('layer3', 256, 6, 2),
                                             ('layer4', 512, 3, 2)):
            layers = [Bottleneck(cin, planes, stride, downsample=True)]
            layers += [Bottleneck(planes * 4, planes)
                       for _ in range(1, blocks)]
            setattr(self, name, nn.Sequential(*layers))
            cin = planes * 4

    def forward(self, x) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        return [c3, c4, self.layer4(c4)]


class MobileNetV1Body(nn.Module):
    """MobileNetV1 x0.25 trunk returning (stage1, stage2, stage3)
    (retinaface_net.py:100-123)."""

    def __init__(self):
        super().__init__()
        self.stage1 = nn.Sequential(
            conv_bn(3, 8, 3, 2, leaky=0.1), conv_dw(8, 16, 1),
            conv_dw(16, 32, 2), conv_dw(32, 32, 1), conv_dw(32, 64, 2),
            conv_dw(64, 64, 1))
        self.stage2 = nn.Sequential(
            conv_dw(64, 128, 2), *[conv_dw(128, 128, 1) for _ in range(5)])
        self.stage3 = nn.Sequential(conv_dw(128, 256, 2),
                                    conv_dw(256, 256, 1))

    def forward(self, x) -> List[torch.Tensor]:
        s1 = self.stage1(x)
        s2 = self.stage2(s1)
        return [s1, s2, self.stage3(s2)]


class SSH(nn.Module):
    """Context module concatenating 3/5/7 receptive-field branches
    (retinaface_net.py:36-63)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        leaky = 0.1 if cout <= 64 else 0.0
        self.conv3X3 = conv_bn(cin, cout // 2, relu=False)
        self.conv5X5_1 = conv_bn(cin, cout // 4, leaky=leaky)
        self.conv5X5_2 = conv_bn(cout // 4, cout // 4, relu=False)
        self.conv7X7_2 = conv_bn(cout // 4, cout // 4, leaky=leaky)
        self.conv7x7_3 = conv_bn(cout // 4, cout // 4, relu=False)

    def forward(self, x):
        c5_1 = self.conv5X5_1(x)
        c7_2 = self.conv7X7_2(c5_1)
        return F.relu(torch.cat([self.conv3X3(x), self.conv5X5_2(c5_1),
                                 self.conv7x7_3(c7_2)], dim=1))


def _up2x(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Nearest x2 as repeat-then-crop: the reference's
    F.interpolate(size=..., mode='nearest') for ceil(h/s) pyramids."""
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return x[:, :, :target.shape[2], :target.shape[3]]


class FPN(nn.Module):
    """3-level FPN with nearest-upsample top-down merges
    (retinaface_net.py:66-97)."""

    def __init__(self, cins, cout: int):
        super().__init__()
        leaky = 0.1 if cout <= 64 else 0.0
        self.output1 = conv_bn(cins[0], cout, 1, leaky=leaky)
        self.output2 = conv_bn(cins[1], cout, 1, leaky=leaky)
        self.output3 = conv_bn(cins[2], cout, 1, leaky=leaky)
        self.merge1 = conv_bn(cout, cout, leaky=leaky)
        self.merge2 = conv_bn(cout, cout, leaky=leaky)

    def forward(self, feats) -> List[torch.Tensor]:
        o1 = self.output1(feats[0])
        o2 = self.output2(feats[1])
        o3 = self.output3(feats[2])
        o2 = self.merge2(o2 + _up2x(o3, o2))
        o1 = self.merge1(o1 + _up2x(o2, o1))
        return [o1, o2, o3]


class _Head(nn.Module):
    """1x1-conv prediction head over 2 anchors a cell
    (retinaface_net.py:138-175), flattened to (B, cells*anchors, out)."""

    def __init__(self, cin: int, out_per_anchor: int, num_anchors: int = 2):
        super().__init__()
        self.out_per_anchor = out_per_anchor
        self.conv1x1 = nn.Conv2d(cin, num_anchors * out_per_anchor, 1)

    def forward(self, x):
        out = self.conv1x1(x).permute(0, 2, 3, 1)
        return out.reshape(x.shape[0], -1, self.out_per_anchor)


RETINAFACE_CONFIGS = {
    'resnet50': dict(in_channel=256, out_channel=256),
    'mobile0.25': dict(in_channel=32, out_channel=64),
}


@ARCH_REGISTRY.register()
class RetinaFace(nn.Module):
    """Backbone -> FPN -> SSH -> heads.

    forward(x): x (B, 3, H, W) BGR, mean-subtracted (104, 117, 123), in
    the model's dtype. Returns (loc (B, N, 4), conf (B, N, 2) softmaxed
    in fp32, landms (B, N, 10)) in the anchor order of ops.anchors.
    """

    def __init__(self, network_name: str = 'resnet50'):
        super().__init__()
        cfg = RETINAFACE_CONFIGS[network_name]
        self.network_name = network_name
        self.body = (ResNet50Body() if network_name == 'resnet50'
                     else MobileNetV1Body())
        cin, cout = cfg['in_channel'], cfg['out_channel']
        self.fpn = FPN((cin * 2, cin * 4, cin * 8), cout)
        self.ssh1 = SSH(cout, cout)
        self.ssh2 = SSH(cout, cout)
        self.ssh3 = SSH(cout, cout)
        self.ClassHead = nn.ModuleList([_Head(cout, 2) for _ in range(3)])
        self.BboxHead = nn.ModuleList([_Head(cout, 4) for _ in range(3)])
        self.LandmarkHead = nn.ModuleList([_Head(cout, 10)
                                           for _ in range(3)])

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        fpn = self.fpn(self.body(x))
        feats = [self.ssh1(fpn[0]), self.ssh2(fpn[1]), self.ssh3(fpn[2])]
        loc = torch.cat([h(f) for h, f in zip(self.BboxHead, feats)], 1)
        conf = torch.cat([h(f) for h, f in zip(self.ClassHead, feats)], 1)
        landm = torch.cat([h(f) for h, f in zip(self.LandmarkHead, feats)],
                          1)
        return loc, torch.softmax(conf.float(), dim=-1), landm
