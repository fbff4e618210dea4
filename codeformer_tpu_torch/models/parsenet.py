"""ParseNet face parser, counterpart of codeformer_tpu/models/parsenet.py
(the reference's facelib/parsing/parsenet.py): reflect-pad convs, an
encoder down to 32x32 (for a 512 input), a 10-block residual body, a
decoder back up, and two output convs giving (19-class mask logits,
image). The paste-back blends only where the parse says face.

NCHW; module names are the reference `.pth` names (`encoder.0.conv2d`,
`body.3.conv1.norm.norm`, ...). BatchNorm runs from its running
statistics.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY


class NormLayer(nn.Module):
    """BatchNorm or identity, nested as `norm.norm` like the reference
    (parsenet.py:8-39)."""

    def __init__(self, channels: int, norm_type: str = 'bn'):
        super().__init__()
        if norm_type == 'bn':
            self.norm = nn.BatchNorm2d(channels)
        elif norm_type == 'none':
            self.norm = None
        else:
            raise NotImplementedError(norm_type)

    def forward(self, x):
        return x if self.norm is None else self.norm(x)


class ConvLayer(nn.Module):
    """Reflect-pad conv with an optional x2 nearest upsample before it or
    stride 2, then norm and ReLU / LeakyReLU(0.2) (parsenet.py:74-110)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 scale: str = 'none', norm_type: str = 'none',
                 relu_type: str = 'none'):
        super().__init__()
        self.scale = scale
        self.relu_type = relu_type
        self.pad = -(-(kernel - 1) // 2)  # ceil((k-1)/2)
        self.conv2d = nn.Conv2d(cin, cout, kernel,
                                2 if scale == 'down' else 1,
                                bias=norm_type != 'bn')
        self.norm = NormLayer(cout, norm_type)

    def forward(self, x):
        if self.scale == 'up':
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        p = self.pad
        x = self.norm(self.conv2d(F.pad(x, (p, p, p, p), mode='reflect')))
        if self.relu_type == 'relu':
            x = F.relu(x)
        elif self.relu_type == 'leakyrelu':
            x = F.leaky_relu(x, 0.2)
        return x


class ResidualBlock(nn.Module):
    """Residual block with optional up/down scaling (parsenet.py:113-137)."""

    def __init__(self, cin: int, cout: int, scale: str = 'none',
                 relu_type: str = 'leakyrelu', norm_type: str = 'bn',
                 identity_shortcut: bool = False):
        super().__init__()
        self.shortcut_func = None if identity_shortcut else \
            ConvLayer(cin, cout, 3, scale)
        first, second = {'down': ('none', 'down'), 'up': ('up', 'none'),
                         'none': ('none', 'none')}[scale]
        self.conv1 = ConvLayer(cin, cout, 3, first, norm_type, relu_type)
        self.conv2 = ConvLayer(cout, cout, 3, second, norm_type, 'none')

    def forward(self, x):
        identity = x if self.shortcut_func is None else self.shortcut_func(x)
        return identity + self.conv2(self.conv1(x))


@ARCH_REGISTRY.register()
class ParseNet(nn.Module):
    """Encoder (to min_feat_size) -> residual body -> decoder -> (mask,
    img). The defaults are init_parsing_model's ParseNet(in_size=512,
    out_size=512, parsing_ch=19) (facelib/parsing/__init__.py:13-14); the
    network is fully convolutional, so a 256 input gives 256 outputs."""

    def __init__(self, in_size: int = 512, out_size: int = 512,
                 min_feat_size: int = 32, base_ch: int = 64,
                 parsing_ch: int = 19, res_depth: int = 10,
                 relu_type: str = 'leakyrelu', norm_type: str = 'bn',
                 ch_range: Tuple[int, int] = (32, 256)):
        super().__init__()
        min_ch, max_ch = ch_range

        def clip(c):
            return max(min_ch, min(c, max_ch))

        mfs = min(in_size, min_feat_size)
        down_steps = int(math.log2(in_size // mfs))
        up_steps = int(math.log2(out_size // mfs))
        act = dict(norm_type=norm_type, relu_type=relu_type)
        encoder = [ConvLayer(3, base_ch, 3, 'none')]
        head = base_ch
        for _ in range(down_steps):
            encoder.append(ResidualBlock(clip(head), clip(head * 2), 'down',
                                         **act))
            head *= 2
        self.encoder = nn.Sequential(*encoder)
        self.body = nn.Sequential(*[
            ResidualBlock(clip(head), clip(head), 'none',
                          identity_shortcut=True, **act)
            for _ in range(res_depth)])
        decoder = []
        for _ in range(up_steps):
            decoder.append(ResidualBlock(clip(head), clip(head // 2), 'up',
                                         **act))
            head //= 2
        self.decoder = nn.Sequential(*decoder)
        self.out_img_conv = ConvLayer(clip(head), 3)
        self.out_mask_conv = ConvLayer(clip(head), parsing_ch)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        feat = self.encoder(x)
        x = self.decoder(feat + self.body(feat))
        return self.out_mask_conv(x), self.out_img_conv(x)
