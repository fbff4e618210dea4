"""Modulated deformable convolution (DCNv2), NHWC; counterpart of
codeformer_tpu/ops/deform_conv.py (reference basicsr/ops/dcn: im2col with
bilinearly sampled offsets and a mask, then a matrix product).

Plain PyTorch: the bilinear sampling is a gather over the flattened
image (there is no torchvision here), the contraction one einsum, and
autograd gives the backward. The JAX copy has no Pallas kernel here, so
neither has the port. Used by nn/arch_util.py DCNv2Pack, not on the
CodeFormer path.

Weights are in PyTorch's layout, (Cout, Cin / groups, kh, kw), as the
reference's ModulatedDeformConv: output channel o of group
o // (Cout / groups) reads the input channels of that group.
"""
from __future__ import annotations

from typing import Optional

import torch


def _sample(x: torch.Tensor, py: torch.Tensor,
            px: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of x (B, H, W, C) at (py, px), each
    (B, Ho, Wo, T) in pixels: (B, Ho, Wo, T, C). A corner outside the
    image reads 0."""
    b, h, w, c = x.shape
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    wy = (py - y0)[..., None]
    wx = (px - x0)[..., None]
    y0 = y0.long()
    x0 = x0.long()
    flat = x.reshape(b, h * w, c)

    def corner(yi, xi):
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return vals.reshape(*yi.shape, c) * valid

    v00, v01 = corner(y0, x0), corner(y0, x0 + 1)
    v10, v11 = corner(y0 + 1, x0), corner(y0 + 1, x0 + 1)
    return ((v00 * (1 - wx) + v01 * wx) * (1 - wy)
            + (v10 * (1 - wx) + v11 * wx) * wy)


def modulated_deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                            mask: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            stride: int = 1, padding: int = 1,
                            dilation: int = 1,
                            groups: int = 1) -> torch.Tensor:
    """x: (B, H, W, Cin); offset: (B, Ho, Wo, 2 * kh * kw), per tap a
    (dy, dx) pair, tap-major (tap = ky * kw + kx), as torchvision; mask:
    (B, Ho, Wo, kh * kw); weight: (Cout, Cin / groups, kh, kw); bias:
    (Cout,). Computes in fp32, returns x.dtype: (B, Ho, Wo, Cout)."""
    b, h, w, cin = x.shape
    cout, cin_g, kh, kw = weight.shape
    if cin_g * groups != cin or cout % groups:
        raise ValueError(f'weight {tuple(weight.shape)} does not fit Cin='
                         f'{cin} in {groups} groups')
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    taps = kh * kw
    dev = x.device

    ys = torch.arange(ho, device=dev) * stride - padding
    xs = torch.arange(wo, device=dev) * stride - padding
    ky = torch.arange(kh, device=dev) * dilation
    kx = torch.arange(kw, device=dev) * dilation
    base_y = (ys[:, None, None, None] + ky[None, None, :, None]) \
        .expand(ho, wo, kh, kw).reshape(ho, wo, taps).float()
    base_x = (xs[None, :, None, None] + kx[None, None, None, :]) \
        .expand(ho, wo, kh, kw).reshape(ho, wo, taps).float()
    off = offset.float().reshape(b, ho, wo, taps, 2)
    cols = _sample(x.float(), base_y + off[..., 0], base_x + off[..., 1])
    cols = cols * mask.float().reshape(b, ho, wo, taps, 1)

    # (Cout, Cin_g, kh, kw) -> (taps, groups, Cin_g, Cout_g)
    wmat = weight.float().reshape(groups, cout // groups, cin_g, taps) \
        .permute(3, 0, 2, 1)
    out = torch.einsum('bhwtgc,tgco->bhwgo',
                       cols.reshape(b, ho, wo, taps, groups, cin_g), wmat)
    out = out.reshape(b, ho, wo, cout)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=1,
                  dilation=1, groups=1):
    """Unmodulated DCNv1: a mask of ones."""
    b, h, w, _ = x.shape
    kh, kw = weight.shape[2:]
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    mask = torch.ones((b, ho, wo, kh * kw), dtype=torch.float32,
                      device=x.device)
    return modulated_deform_conv2d(x, offset, mask, weight, bias, stride,
                                   padding, dilation, groups)
