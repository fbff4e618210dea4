"""BiSeNet face parser, counterpart of codeformer_tpu/models/bisenet.py
(the reference's facelib/parsing/{bisenet.py,resnet.py}): a ResNet18
context path with attention refinement modules, a feature fusion
module, and three output heads resized (bilinear, align_corners) to the
input.

NCHW; module names are the reference `.pth` names (`cp.resnet.layer1.0.
conv1`, `cp.arm16.conv_atten`, `ffm.convblk.conv`, `conv_out16.conv_out`,
...), so `parsing_bisenet.pth` and `flax_to_state_dict` of the JAX
variables (with `like=`) load strictly. BatchNorm runs from its running
statistics (the model is built for eval). The convs are cuDNN's.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY


class ConvBNReLU(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, ks: int = 3,
                 stride: int = 1, padding: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_chan, out_chan, ks, stride, padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(out_chan)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_chan, out_chan, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_chan)
        self.conv2 = nn.Conv2d(out_chan, out_chan, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_chan)
        self.downsample = None
        if stride != 1 or in_chan != out_chan:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_chan, out_chan, 1, stride, bias=False),
                nn.BatchNorm2d(out_chan))

    def forward(self, x):
        r = F.relu(self.bn1(self.conv1(x)))
        r = self.bn2(self.conv2(r))
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(shortcut + r)


def _layer(in_chan: int, out_chan: int, stride: int) -> nn.Sequential:
    return nn.Sequential(BasicBlock(in_chan, out_chan, stride),
                         BasicBlock(out_chan, out_chan))


class ResNet18(nn.Module):
    """The trunk: (feat8, feat16, feat32), strides 8, 16, 32."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.layer1 = _layer(64, 64, 1)
        self.layer2 = _layer(64, 128, 2)
        self.layer3 = _layer(128, 256, 2)
        self.layer4 = _layer(256, 512, 2)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feat8 = self.layer2(self.layer1(x))
        feat16 = self.layer3(feat8)
        return feat8, feat16, self.layer4(feat16)


class AttentionRefinementModule(nn.Module):
    def __init__(self, in_chan: int, out_chan: int):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, out_chan)
        self.conv_atten = nn.Conv2d(out_chan, out_chan, 1, bias=False)
        self.bn_atten = nn.BatchNorm2d(out_chan)

    def forward(self, x):
        feat = self.conv(x)
        atten = self.bn_atten(self.conv_atten(
            feat.mean(dim=(2, 3), keepdim=True)))
        return feat * torch.sigmoid(atten)


def _up_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """Nearest resize with half-pixel centres, as jax.image.resize's
    'nearest' (a plain repeat at the exact 2x of the model's maps)."""
    return F.interpolate(x, size=tuple(hw), mode='nearest-exact')


def _up_bilinear_ac(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize with align_corners=True (the reference's
    F.interpolate)."""
    return F.interpolate(x, size=tuple(hw), mode='bilinear',
                         align_corners=True)


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = ResNet18()
        self.arm16 = AttentionRefinementModule(256, 128)
        self.arm32 = AttentionRefinementModule(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.conv_head16 = ConvBNReLU(128, 128)
        self.conv_avg = ConvBNReLU(512, 128, ks=1, padding=0)

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        feat32_sum = self.arm32(feat32) + avg
        feat32_up = self.conv_head32(
            _up_nearest(feat32_sum, feat16.shape[2:]))
        feat16_sum = self.arm16(feat16) + feat32_up
        feat16_up = self.conv_head16(
            _up_nearest(feat16_sum, feat8.shape[2:]))
        return feat8, feat16_up, feat32_up


class FeatureFusionModule(nn.Module):
    def __init__(self, in_chan: int, out_chan: int):
        super().__init__()
        self.convblk = ConvBNReLU(in_chan, out_chan, ks=1, padding=0)
        self.conv1 = nn.Conv2d(out_chan, out_chan // 4, 1, bias=False)
        self.conv2 = nn.Conv2d(out_chan // 4, out_chan, 1, bias=False)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], 1))
        atten = feat.mean(dim=(2, 3), keepdim=True)
        atten = torch.sigmoid(self.conv2(F.relu(self.conv1(atten))))
        return feat * atten + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, in_chan: int, mid_chan: int, num_class: int):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, mid_chan)
        self.conv_out = nn.Conv2d(mid_chan, num_class, 1, bias=False)

    def forward(self, x):
        feat = self.conv(x)
        return self.conv_out(feat), feat


@ARCH_REGISTRY.register()
class BiSeNet(nn.Module):
    """x: (B, 3, H, W) -> (out, out16, out32) logits of `num_class`
    classes at (H, W); with return_feat also the three heads' features
    at (H, W)."""

    def __init__(self, num_class: int = 19):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusionModule(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, num_class)
        self.conv_out16 = BiSeNetOutput(128, 64, num_class)
        self.conv_out32 = BiSeNetOutput(128, 64, num_class)

    def forward(self, x, return_feat: bool = False):
        hw = x.shape[2:]
        feat_res8, feat_cp8, feat_cp16 = self.cp(x)
        out, feat = self.conv_out(self.ffm(feat_res8, feat_cp8))
        out16, feat16 = self.conv_out16(feat_cp8)
        out32, feat32 = self.conv_out32(feat_cp16)
        outs = [_up_bilinear_ac(o, hw) for o in (out, out16, out32)]
        if return_feat:
            outs += [_up_bilinear_ac(f, hw) for f in (feat, feat16, feat32)]
        return tuple(outs)
