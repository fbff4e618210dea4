"""Plain RRDBNet (the Real-ESRGAN generator) and its tile walk in
float32 PyTorch: the benchmark's reference for the fused pipeline's
background upsampler.

The network is xinntao/Real-ESRGAN's RealESRGAN_x2plus as
basicsr/archs/rrdbnet_arch.py writes it: for scale 2 the input is
pixel-unshuffled (`F.pixel_unshuffle`, 12 channels at half size), then
`conv_first`, `num_block` RRDBs of three dense blocks each (five 3x3
convs on a concatenation that grows by `num_grow_ch` a conv; a dense
block adds 0.2 of its output to its input, an RRDB 0.2 of its three
blocks' output to its own input), `conv_body` with the long skip, two
nearest x2 upsamplings each followed by a 3x3 conv, `conv_hr` and
`conv_last`. Parameter names are the released `.pth`'s.

The tile walk is the program's, which departs from the reference's
basicsr/utils/realesrgan_utils.py `tile_process`: the image is
edge-replicated so that every tile of `tile` x `tile` pixels has its
`tile_pad` margin inside the padded image, every window runs at the full
(tile + 2 * tile_pad)^2, and the core of each upscaled window (rounded
to uint8 on its own) is written back. realesrgan_utils.py instead cuts
each window at the image's edge, so its border windows are smaller and
see no replicated pixels: at 512 x 683 in tiles of 400 with pad 40 it
runs 452 k window pixels against this walk's 922 k, and its output
differs near the image's edge. (The program runs an image no larger
than one tile whole; the benchmark's frames never are, and this
reference leaves that case out.)

`walk_cost` counts the operations of the walk at a frame size from the
network walked on the meta device (benchmark/roofline.py `flops`).
Nothing of the program is imported; run it inside
benchmark/reference/codeformer.py `fp32_math` (TF32 off).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class ResidualDenseBlock(nn.Module):
    """rrdbnet_arch.py ResidualDenseBlock."""

    def __init__(self, num_feat: int, num_grow_ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(num_feat, num_grow_ch, 3, 1, 1)
        self.conv2 = nn.Conv2d(num_feat + num_grow_ch, num_grow_ch, 3, 1, 1)
        self.conv3 = nn.Conv2d(num_feat + 2 * num_grow_ch, num_grow_ch, 3,
                               1, 1)
        self.conv4 = nn.Conv2d(num_feat + 3 * num_grow_ch, num_grow_ch, 3,
                               1, 1)
        self.conv5 = nn.Conv2d(num_feat + 4 * num_grow_ch, num_feat, 3, 1, 1)
        self.lrelu = nn.LeakyReLU(negative_slope=0.2)

    def forward(self, x):
        x1 = self.lrelu(self.conv1(x))
        x2 = self.lrelu(self.conv2(torch.cat((x, x1), 1)))
        x3 = self.lrelu(self.conv3(torch.cat((x, x1, x2), 1)))
        x4 = self.lrelu(self.conv4(torch.cat((x, x1, x2, x3), 1)))
        x5 = self.conv5(torch.cat((x, x1, x2, x3, x4), 1))
        return x5 * 0.2 + x


class RRDB(nn.Module):
    """rrdbnet_arch.py RRDB."""

    def __init__(self, num_feat: int, num_grow_ch: int):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """rrdbnet_arch.py RRDBNet: (B, num_in_ch, H, W) in [0, 1] ->
    (B, num_out_ch, H*scale, W*scale)."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 scale: int = 4, num_feat: int = 64, num_block: int = 23,
                 num_grow_ch: int = 32):
        super().__init__()
        self.scale = scale
        if scale == 2:
            num_in_ch = num_in_ch * 4
        elif scale == 1:
            num_in_ch = num_in_ch * 16
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = nn.Sequential(*[RRDB(num_feat, num_grow_ch)
                                    for _ in range(num_block)])
        self.conv_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)
        self.lrelu = nn.LeakyReLU(negative_slope=0.2)

    def forward(self, x):
        if self.scale == 2:
            x = F.pixel_unshuffle(x, 2)
        elif self.scale == 1:
            x = F.pixel_unshuffle(x, 4)
        feat = self.conv_first(x)
        feat = feat + self.conv_body(self.body(feat))
        feat = self.lrelu(self.conv_up1(
            F.interpolate(feat, scale_factor=2, mode='nearest')))
        feat = self.lrelu(self.conv_up2(
            F.interpolate(feat, scale_factor=2, mode='nearest')))
        return self.conv_last(self.lrelu(self.conv_hr(feat)))


def _to_u8(y: torch.Tensor) -> torch.Tensor:
    return torch.round(y.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def windows(h: int, w: int, tile: int, pad: int) -> Tuple[int, int, int]:
    """(tiles down, tiles across, window side) of the walk at h x w, a
    frame larger than one tile."""
    if tile <= 0 or max(h, w) <= tile:
        raise ValueError(f'{h}x{w} fits one tile of {tile}: the program '
                         f'runs it whole, which this reference leaves out')
    return math.ceil(h / tile), math.ceil(w / tile), tile + 2 * pad


@torch.no_grad()
def upscale(model: RRDBNet, frames_bgr_u8: torch.Tensor, tile: int,
            pad: int) -> torch.Tensor:
    """(C, H, W, 3) uint8 BGR, larger than one tile -> (C, H*s, W*s, 3)
    uint8 BGR through the walk of the module docstring, four windows a
    forward; each window's output is clipped to [0, 1] and rounded to
    uint8 on its own."""
    s, batch = model.scale, 4
    x = frames_bgr_u8.flip(-1).permute(0, 3, 1, 2).float() / 255.0
    n, c, h, w = x.shape
    ty, tx, tin = windows(h, w, tile, pad)
    padded = F.pad(x, (pad, tile * tx - w + pad, pad, tile * ty - h + pad),
                   mode='replicate')
    out = torch.zeros((n, c, ty * tile * s, tx * tile * s),
                      dtype=torch.uint8, device=x.device)
    spots = [(f, i, j) for f in range(n) for i in range(ty)
             for j in range(tx)]
    for k in range(0, len(spots), batch):
        part = spots[k:k + batch]
        win = torch.stack([padded[f, :, i * tile:i * tile + tin,
                                  j * tile:j * tile + tin]
                           for f, i, j in part])
        up = _to_u8(model(win))
        for (f, i, j), u in zip(part, up):
            out[f, :, i * tile * s:(i + 1) * tile * s,
                j * tile * s:(j + 1) * tile * s] = \
                u[:, pad * s:(pad + tile) * s, pad * s:(pad + tile) * s]
    return out[..., :h * s, :w * s].permute(0, 2, 3, 1).flip(-1)


def walk_cost(arch: Dict, h: int, w: int, tile: int, pad: int) -> Dict:
    """Work of the walk on one h x w frame: `flops` (multiply-adds x 2 of
    the network on every window, counted on the meta device), `bytes`
    (the uint8 frame read once, its uint8 upscale written once and the
    weights read once in bf16: the stage's own traffic, as
    benchmark/roofline.py counts a kernel's), `windows` and the window
    side."""
    from benchmark.roofline import flops
    with torch.device('meta'):
        model = RRDBNet(**arch)
    s = model.scale
    ty, tx, tin = windows(h, w, tile, pad)
    per_window = flops(lambda: model(torch.empty(1, 3, tin, tin,
                                                 device='meta')))
    n_params = sum(p.numel() for p in model.parameters())
    return {'flops': ty * tx * per_window,
            'bytes': 3 * h * w + 3 * h * w * s * s + 2 * n_params,
            'windows': ty * tx, 'window': tin}
