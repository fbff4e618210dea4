"""Plain RetinaFace (ResNet50 body) in PyTorch, float32: the benchmark's
reference for the detector's raw head outputs.

A frozen copy of the released network (sczhou/CodeFormer
facelib/detection/retinaface/retinaface.py and retinaface_net.py):
torchvision's ResNet50 to layer4, taps at strides 8/16/32, a 3-level FPN
with nearest-upsample merges, three SSH context modules and 1x1 heads
over two anchors a cell, the heads flattened in (cell, anchor) order.
BatchNorm from its running statistics. Parameter names are the released
`.pth` names.

`detect_input` is the detector's front end on uint8 BGR frames: a linear
resize to the detection size (half-pixel centres; no antialiasing, the
frames grow), zero padding to multiples of 64, the BGR means subtracted.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

MEANS_BGR = (104.0, 117.0, 123.0)


def conv_bn(cin, cout, k=3, stride=1, leaky=0.0, act=True):
    layers = [nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=False),
              nn.BatchNorm2d(cout)]
    if act:
        layers.append(nn.LeakyReLU(leaky) if leaky > 0 else nn.ReLU())
    return nn.Sequential(*layers)


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride=1, down=False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
            nn.BatchNorm2d(planes * 4)) if down else None

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + (x if self.downsample is None
                           else self.downsample(x)))


class Body(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for name, planes, n, stride in (('layer1', 64, 3, 1),
                                        ('layer2', 128, 4, 2),
                                        ('layer3', 256, 6, 2),
                                        ('layer4', 512, 3, 2)):
            blocks = [Bottleneck(cin, planes, stride, True)]
            blocks += [Bottleneck(planes * 4, planes) for _ in range(n - 1)]
            setattr(self, name, nn.Sequential(*blocks))
            cin = planes * 4

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        c3 = self.layer2(self.layer1(x))
        c4 = self.layer3(c3)
        return [c3, c4, self.layer4(c4)]


class SSH(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        leaky = 0.1 if cout <= 64 else 0.0
        self.conv3X3 = conv_bn(cin, cout // 2, act=False)
        self.conv5X5_1 = conv_bn(cin, cout // 4, leaky=leaky)
        self.conv5X5_2 = conv_bn(cout // 4, cout // 4, act=False)
        self.conv7X7_2 = conv_bn(cout // 4, cout // 4, leaky=leaky)
        self.conv7x7_3 = conv_bn(cout // 4, cout // 4, act=False)

    def forward(self, x):
        c5 = self.conv5X5_1(x)
        c7 = self.conv7X7_2(c5)
        return F.relu(torch.cat([self.conv3X3(x), self.conv5X5_2(c5),
                                 self.conv7x7_3(c7)], 1))


class FPN(nn.Module):
    def __init__(self, cins, cout):
        super().__init__()
        leaky = 0.1 if cout <= 64 else 0.0
        self.output1 = conv_bn(cins[0], cout, 1, leaky=leaky)
        self.output2 = conv_bn(cins[1], cout, 1, leaky=leaky)
        self.output3 = conv_bn(cins[2], cout, 1, leaky=leaky)
        self.merge1 = conv_bn(cout, cout, leaky=leaky)
        self.merge2 = conv_bn(cout, cout, leaky=leaky)

    def forward(self, feats):
        o1, o2, o3 = (self.output1(feats[0]), self.output2(feats[1]),
                      self.output3(feats[2]))
        up3 = F.interpolate(o3, size=o2.shape[2:], mode='nearest')
        o2 = self.merge2(o2 + up3)
        up2 = F.interpolate(o2, size=o1.shape[2:], mode='nearest')
        return [self.merge1(o1 + up2), o2, o3]


class Head(nn.Module):
    def __init__(self, cin, per_anchor, anchors=2):
        super().__init__()
        self.per_anchor = per_anchor
        self.conv1x1 = nn.Conv2d(cin, anchors * per_anchor, 1)

    def forward(self, x):
        out = self.conv1x1(x).permute(0, 2, 3, 1)
        return out.reshape(x.shape[0], -1, self.per_anchor)


class RetinaFace(nn.Module):
    """forward(x) -> (loc (B, N, 4), conf (B, N, 2) softmaxed,
    landmarks (B, N, 10))."""

    def __init__(self):
        super().__init__()
        self.body = Body()
        self.fpn = FPN((512, 1024, 2048), 256)
        self.ssh1, self.ssh2, self.ssh3 = SSH(256, 256), SSH(256, 256), \
            SSH(256, 256)
        self.ClassHead = nn.ModuleList(Head(256, 2) for _ in range(3))
        self.BboxHead = nn.ModuleList(Head(256, 4) for _ in range(3))
        self.LandmarkHead = nn.ModuleList(Head(256, 10) for _ in range(3))

    def features(self, x):
        f = self.fpn(self.body(x))
        return [self.ssh1(f[0]), self.ssh2(f[1]), self.ssh3(f[2])]

    def forward(self, x):
        feats = self.features(x)
        loc = torch.cat([h(f) for h, f in zip(self.BboxHead, feats)], 1)
        conf = torch.cat([h(f) for h, f in zip(self.ClassHead, feats)], 1)
        landm = torch.cat([h(f) for h, f in zip(self.LandmarkHead, feats)],
                          1)
        return loc, torch.softmax(conf, dim=-1), landm


def detect_input(frames_bgr_u8: torch.Tensor, det_hw) -> torch.Tensor:
    """uint8 BGR (B, H, W, 3) -> the detector's float32 input (B, 3, hb,
    wb): resized to det_hw, zero-padded to multiples of 64, minus the BGR
    means (retinaface.py:88)."""
    dh, dw = det_hw
    x = frames_bgr_u8.permute(0, 3, 1, 2).float()
    shrink = dh < x.shape[2] or dw < x.shape[3]
    if (dh, dw) != tuple(x.shape[2:]):
        x = F.interpolate(x, size=(dh, dw), mode='bilinear',
                          align_corners=False, antialias=shrink)
    hb, wb = -(-dh // 64) * 64, -(-dw // 64) * 64
    x = F.pad(x, (0, wb - dw, 0, hb - dh))
    return x - torch.tensor(MEANS_BGR, device=x.device).reshape(1, 3, 1, 1)
