"""Shared architecture utilities (counterpart of
codeformer_tpu/nn/arch_util.py; reference basicsr/archs/arch_util.py):
initializers, flow warping, pixel unshuffle, and the DCNv2 pack module of
EDVR-style alignment. Images and flows are NHWC, as in the JAX copy."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from codeformer_tpu_torch.ops.deform_conv import modulated_deform_conv2d

__all__ = ['default_init_weights', 'trunc_normal_', 'flow_warp',
           'pixel_unshuffle', 'DCNv2Pack', 'resize_flow', 'make_layer']


def make_layer(block_cls, num_blocks: int, **kwargs) -> nn.Sequential:
    """`num_blocks` instances of block_cls(**kwargs) in a Sequential
    (arch_util.py:48-60)."""
    return nn.Sequential(*[block_cls(**kwargs) for _ in range(num_blocks)])


@torch.no_grad()
def default_init_weights(module_list, scale: float = 1.0,
                         bias_fill: float = 0.0, **kwargs) -> None:
    """Kaiming-normal (fan_in) weights scaled by `scale` for every Conv2d
    and Linear, biases filled with `bias_fill`; BatchNorm weights 1
    (arch_util.py:18-45)."""
    if not isinstance(module_list, (list, tuple)):
        module_list = [module_list]
    for module in module_list:
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_normal_(m.weight, **kwargs)
                m.weight.mul_(scale)
                if m.bias is not None:
                    m.bias.fill_(bias_fill)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                nn.init.constant_(m.weight, 1)
                if m.bias is not None:
                    m.bias.fill_(bias_fill)


def trunc_normal_(tensor: torch.Tensor, mean: float = 0.0, std: float = 1.0,
                  a: float = -2.0, b: float = 2.0) -> torch.Tensor:
    """Fill `tensor` in place from N(mean, std) truncated to [a, b]
    (arch_util.py:277-317)."""
    return nn.init.trunc_normal_(tensor, mean, std, a, b)


def pixel_unshuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """NHWC pixel-unshuffle in torch's channel order
    (arch_util.py:190-207): out channel = c*s*s + sh*s + sw."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // scale, scale, w // scale, scale, c)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // scale, w // scale, c * scale * scale)


def flow_warp(x: torch.Tensor, flow: torch.Tensor,
              interp_mode: str = 'bilinear', padding_mode: str = 'zeros',
              align_corners: bool = True) -> torch.Tensor:
    """Warp an NHWC map with optical flow (arch_util.py:117-149):
    output(p) = x(p + flow(p)), bilinear, flow (B, H, W, 2) holding
    (dx, dy) in pixels: grid_sample with align_corners=True. 'zeros'
    reads 0 at a corner outside the map, 'border' the nearest edge
    pixel."""
    if interp_mode != 'bilinear' or not align_corners:
        raise NotImplementedError('only bilinear with align_corners=True '
                                  '(as the JAX copy)')
    if padding_mode not in ('zeros', 'border'):
        raise ValueError(f'padding_mode must be zeros or border, got '
                         f'{padding_mode!r}')
    b, h, w, c = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=x.device),
                            torch.arange(w, dtype=torch.float32,
                                         device=x.device), indexing='ij')
    sx = gx[None] + flow[..., 0].float()
    sy = gy[None] + flow[..., 1].float()
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[..., None]
    wy = (sy - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    flat = x.float().reshape(b, h * w, c)

    def corner(yy, xx):
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(b, -1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c)) \
            .reshape(b, h, w, c)
        if padding_mode == 'zeros':
            vals = vals * ((xx >= 0) & (xx < w) & (yy >= 0)
                           & (yy < h))[..., None]
        return vals

    top = corner(y0, x0) * (1 - wx) + corner(y0, x0 + 1) * wx
    bot = corner(y0 + 1, x0) * (1 - wx) + corner(y0 + 1, x0 + 1) * wx
    return (top * (1 - wy) + bot * wy).to(x.dtype)


def resize_flow(flow: torch.Tensor, size_type: str, sizes,
                interp_mode: str = 'bilinear') -> torch.Tensor:
    """Resize an NHWC flow (B, H, W, 2) and rescale its magnitudes
    (arch_util.py:152-187): bilinear with half-pixel centres, antialiased
    when it shrinks (as jax.image.resize)."""
    b, h, w, _ = flow.shape
    if size_type == 'ratio':
        out_h, out_w = int(h * sizes[0]), int(w * sizes[1])
    elif size_type == 'shape':
        out_h, out_w = sizes[0], sizes[1]
    else:
        raise ValueError(f'size_type {size_type}')
    if interp_mode != 'bilinear':
        raise NotImplementedError('only bilinear (as the JAX copy)')
    resized = F.interpolate(flow.float().permute(0, 3, 1, 2),
                            size=(out_h, out_w), mode='bilinear',
                            align_corners=False,
                            antialias=out_h < h or out_w < w)
    ratio = torch.tensor([out_w / w, out_h / h], device=flow.device)
    return (resized.permute(0, 2, 3, 1) * ratio).to(flow.dtype)


class DCNv2Pack(nn.Module):
    """Modulated deformable conv whose offsets and mask are predicted from
    a guide feature (arch_util.py:209-237): conv_offset(feat) -> (o1, o2,
    mask logits) by channel thirds, per tap (dy, dx) = (o1, o2), mask =
    sigmoid, then modulated_deform_conv2d(x) with `weight`, `bias`.
    x and feat (B, H, W, in_channels) NHWC, as the JAX copy; weight
    (out, in, k, k) as the reference's .pth. Only one deformable group,
    as the JAX copy."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 deformable_groups: int = 1):
        super().__init__()
        if deformable_groups != 1:
            raise NotImplementedError('deformable_groups > 1 (the JAX copy '
                                      'reshapes its offsets for one group)')
        self.stride, self.padding = stride, padding
        k = kernel_size
        self.conv_offset = nn.Conv2d(in_channels, 3 * k * k, k, stride,
                                     padding)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.kaiming_normal_(self.weight, nonlinearity='relu')
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def forward(self, x: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        out = self.conv_offset(feat.permute(0, 3, 1, 2).to(
            self.conv_offset.weight.dtype)).permute(0, 2, 3, 1)
        o1, o2, mask = torch.chunk(out, 3, dim=-1)
        b, h, w, taps = o1.shape
        offset = torch.stack([o1, o2], dim=-1).reshape(b, h, w, 2 * taps)
        return modulated_deform_conv2d(x, offset, torch.sigmoid(mask),
                                       self.weight, self.bias, self.stride,
                                       self.padding)
