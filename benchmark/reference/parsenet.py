"""Plain ParseNet in PyTorch, float32: the benchmark's reference for the
face parser of the paste-back.

A frozen copy of the released network (sczhou/CodeFormer
facelib/parsing/parsenet.py, as `init_parsing_model` builds it:
in_size 512, out_size 512, 19 classes): reflect-padded convs, residual
blocks down to 32 x 32 (for 512 in), ten residual blocks, back up, and
two output convs (mask logits, image). Fully convolutional, so a 256
input gives 256 outputs. BatchNorm from its running statistics.
Parameter names are the released `.pth` names.
"""
from __future__ import annotations

import math

import torch.nn as nn
import torch.nn.functional as F


class NormLayer(nn.Module):
    def __init__(self, c, norm_type):
        super().__init__()
        self.norm = nn.BatchNorm2d(c) if norm_type == 'bn' else None

    def forward(self, x):
        return x if self.norm is None else self.norm(x)


class ConvLayer(nn.Module):
    def __init__(self, cin, cout, k=3, scale='none', norm_type='none',
                 relu_type='none'):
        super().__init__()
        self.scale, self.relu_type = scale, relu_type
        self.pad = -(-(k - 1) // 2)
        self.conv2d = nn.Conv2d(cin, cout, k, 2 if scale == 'down' else 1,
                                bias=norm_type != 'bn')
        self.norm = NormLayer(cout, norm_type)

    def forward(self, x):
        if self.scale == 'up':
            x = F.interpolate(x, scale_factor=2.0, mode='nearest')
        p = self.pad
        x = self.norm(self.conv2d(F.pad(x, (p, p, p, p), mode='reflect')))
        if self.relu_type == 'relu':
            return F.relu(x)
        if self.relu_type == 'leakyrelu':
            return F.leaky_relu(x, 0.2)
        return x


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout, scale='none', identity=False):
        super().__init__()
        self.shortcut_func = None if identity else ConvLayer(cin, cout, 3,
                                                             scale)
        first, second = {'down': ('none', 'down'), 'up': ('up', 'none'),
                         'none': ('none', 'none')}[scale]
        self.conv1 = ConvLayer(cin, cout, 3, first, 'bn', 'leakyrelu')
        self.conv2 = ConvLayer(cout, cout, 3, second, 'bn', 'none')

    def forward(self, x):
        skip = x if self.shortcut_func is None else self.shortcut_func(x)
        return skip + self.conv2(self.conv1(x))


class ParseNet(nn.Module):
    """forward(x in [-1, 1], (B, 3, S, S)) -> (mask logits (B, 19, S, S),
    image)."""

    def __init__(self, in_size=512, out_size=512, min_feat_size=32,
                 base_ch=64, parsing_ch=19, res_depth=10,
                 ch_range=(32, 256)):
        super().__init__()

        def clip(c):
            return max(ch_range[0], min(c, ch_range[1]))
        mfs = min(in_size, min_feat_size)
        head = base_ch
        enc = [ConvLayer(3, base_ch, 3)]
        for _ in range(int(math.log2(in_size // mfs))):
            enc.append(ResidualBlock(clip(head), clip(head * 2), 'down'))
            head *= 2
        self.encoder = nn.Sequential(*enc)
        self.body = nn.Sequential(*[
            ResidualBlock(clip(head), clip(head), identity=True)
            for _ in range(res_depth)])
        dec = []
        for _ in range(int(math.log2(out_size // mfs))):
            dec.append(ResidualBlock(clip(head), clip(head // 2), 'up'))
            head //= 2
        self.decoder = nn.Sequential(*dec)
        self.out_img_conv = ConvLayer(clip(head), 3)
        self.out_mask_conv = ConvLayer(clip(head), parsing_ch)

    def forward(self, x):
        feat = self.encoder(x)
        x = self.decoder(feat + self.body(feat))
        return self.out_mask_conv(x), self.out_img_conv(x)
