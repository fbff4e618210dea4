"""VQGAN building blocks in PyTorch (counterpart of codeformer_tpu/nn/blocks.py).

Tensors are NCHW in torch.channels_last memory, so `x.permute(0, 2, 3, 1)`
is a free contiguous NHWC view for the kernels of ops/conv3x3.py.
Precision policy as in the JAX package: parameters fp32, activations in
the input's dtype (bf16 when serving), fp32 statistics in GroupNorm and
AdaIN. Parameter names are the reference `.pth` names.

With `use_kernels` on (the default, and the restorer's setting) every
ResBlock conv runs through K1 (`conv3x3_dots`, GroupNorm-apply and SiLU
folded in) and every Downsample through K2 (`downsample_dots`); the
decoder tail GroupNorm -> conv_out is one K1 call without activation.
In eval mode each of those modules keeps its kernel-layout operands
between calls (`kept_operands`). The kernels are forward-only, so
training switches a model to the textbook form with
`set_kernels(model, False)`: plain GroupNorm, SiLU and
convs that autograd records (the JAX package trains through plain XLA
convs the same way, train/train.py `set_colpack_mode('off')`).
Attention, Upsample, the SFT convs and the encoder's edges are plain
PyTorch, as they were plain XLA in JAX.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from codeformer_tpu_torch.ops import conv3x3 as cv

CL = torch.channels_last


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> contiguous NHWC view (a copy only if x is not
    channels_last already)."""
    return x.contiguous(memory_format=CL).permute(0, 2, 3, 1)


def nchw(y: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC -> NCHW view in channels_last memory."""
    return y.permute(0, 3, 1, 2)


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in the input's dtype (fp32 parameters are
    cast on use, as flax's `dtype=`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32, eps=1e-6) (reference vqgan_arch.py:14-15) with fp32
    statistics, output in the input's dtype."""

    def __init__(self, num_channels: int):
        super().__init__(32, num_channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                         self.eps)
        return y.to(x.dtype)


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5):
    """Per-sample, per-channel spatial mean and std of an NCHW tensor,
    with the unbiased variance (codeformer_arch.py:12-26). fp32,
    shapes (B, C, 1, 1)."""
    f = feat.float()
    mean = f.mean((2, 3), keepdim=True)
    var = f.var((2, 3), keepdim=True, unbiased=True)
    return mean, (var + eps).sqrt()


def adaptive_instance_normalization(content_feat: torch.Tensor,
                                    style_feat: torch.Tensor) -> torch.Tensor:
    """AdaIN (codeformer_arch.py:29-43): content re-coloured with the
    style's channel statistics; fp32 inside, content dtype out."""
    style_mean, style_std = calc_mean_std(style_feat)
    content_mean, content_std = calc_mean_std(content_feat)
    out = (content_feat.float() - content_mean) / content_std
    return (out * style_std + style_mean).to(content_feat.dtype)


def set_kernels(model: nn.Module, on: bool) -> nn.Module:
    """Set `use_kernels` on every module of `model` that has the switch
    (ResBlock, Downsample, Generator's tail): True runs K1/K2 (forward
    only), False the textbook form autograd can record. Returns model."""
    for mod in model.modules():
        if hasattr(mod, 'use_kernels'):
            mod.use_kernels = bool(on)
    return model


def on_card(x: torch.Tensor) -> bool:
    """Whether x runs the kernels (a CUDA tensor): there the modules hand
    them their kept operands."""
    return x.is_cuda


def kept_operands(mod: nn.Module, params, make):
    """`make()` kept on `mod._operands` between calls in eval mode, made
    again when a tensor of `params` is updated in place (`_version`),
    replaced, moved or cast; None in training mode, where nothing is
    kept."""
    if mod.training:
        mod._operands = None
        return None
    key = tuple((t._version, t.data_ptr(), t.device, t.dtype)
                for t in params)
    if mod._operands is None or mod._operands[0] != key:
        with torch.no_grad():
            mod._operands = (key, make())
    return mod._operands[1]


class ResBlock(nn.Module):
    """GroupNorm -> SiLU -> 3x3 conv, twice, plus the (projected) skip
    (vqgan_arch.py:141-164). With `use_kernels`, two K1 calls:

      1. entry stats (fp32 sums) -> gn_affine -> K1(silu) = y1 + its stats
      2. gn_affine(y1 stats) -> K1(silu, skip = x_in or x_in @ conv_out)

    The projected skip multiplies the RAW block input; conv_out's bias is
    folded into conv2's. In eval mode the block keeps both calls'
    operands (`kernel_operands`). Without, the textbook form of JAX
    ResBlock._forward (codeformer_tpu/nn/blocks.py:127-137).
    """

    def __init__(self, in_channels: int, out_channels: int | None = None):
        super().__init__()
        self.use_kernels = True
        out_ch = out_channels or in_channels
        self.in_channels, self.out_channels = in_channels, out_ch
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = Conv2d(in_channels, out_ch, 3, padding=1)
        self.norm2 = GroupNorm32(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        if in_channels != out_ch:
            self.conv_out = Conv2d(in_channels, out_ch, 1)
        self._operands = None    # (key, (ops1, ops2, bias2))

    def _conv2_bias(self) -> torch.Tensor:
        """conv2's bias, with conv_out's folded in where the skip is
        projected."""
        if self.in_channels == self.out_channels:
            return self.conv2.bias
        return self.conv2.bias + self.conv_out.bias

    def kernel_operands(self):
        """(dots_operands of conv1, of conv2 with the folded bias and
        conv_out's 1x1 weight, the folded bias) kept in eval mode
        (`kept_operands`); None in training mode."""
        proj = self.in_channels != self.out_channels
        params = [self.conv1.weight, self.conv1.bias, self.conv2.weight,
                  self.conv2.bias]
        if proj:
            params += [self.conv_out.weight, self.conv_out.bias]

        def make():
            bias2 = self._conv2_bias().detach()
            return (cv.dots_operands(self.conv1.weight, self.conv1.bias),
                    cv.dots_operands(self.conv2.weight, bias2,
                                     self.conv_out.weight if proj else None),
                    bias2)
        return kept_operands(self, params, make)

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        if not self.use_kernels:
            h = self.conv1(F.silu(self.norm1(x_in)))
            h = self.conv2(F.silu(self.norm2(h)))
            if self.in_channels != self.out_channels:
                x_in = self.conv_out(x_in)
            return h + x_in
        x = nhwc(x_in)
        hw = x.shape[1] * x.shape[2]
        kept = self.kernel_operands() if on_card(x) else None
        ops1, ops2, bias2 = kept or (None, None, self._conv2_bias())
        a1, b1 = cv.gn_affine(cv.channel_stats(x), self.norm1.weight,
                              self.norm1.bias, hw)
        y1, st1 = cv.conv3x3_dots(x, a1, b1, 'silu', self.conv1.weight,
                                  self.conv1.bias, prepared=ops1)
        a2, b2 = cv.gn_affine(st1, self.norm2.weight, self.norm2.bias, hw)
        w1x1 = self.conv_out.weight \
            if self.in_channels != self.out_channels else None
        y, _ = cv.conv3x3_dots(y1, a2, b2, 'silu', self.conv2.weight, bias2,
                               skip=x, w1x1=w1x1, prepared=ops2)
        return nchw(y)


def decoder_tail(norm: GroupNorm32, conv: Conv2d, x: torch.Tensor,
                 use_kernels: bool = True, prepared=None) -> torch.Tensor:
    """Generator tail GroupNorm -> conv_out (reference
    vqgan_arch.py:313-314: no swish before conv_out), as ONE K1 call with
    no activation, or plainly without `use_kernels`. `prepared`: the
    conv's cv.dots_operands kept by the caller (the Generator)."""
    if not use_kernels:
        return conv(norm(x))
    xh = nhwc(x)
    a, b = cv.gn_affine(cv.channel_stats(xh), norm.weight, norm.bias,
                        xh.shape[1] * xh.shape[2])
    y, _ = cv.conv3x3_dots(xh, a, b, 'none', conv.weight, conv.bias,
                           prepared=prepared)
    return nchw(y)


class AttnBlock(nn.Module):
    """Single-head spatial self-attention (vqgan_arch.py:167-226):
    GroupNorm, 1x1 q/k/v, softmax(q k^T / sqrt(C)) v, proj_out, residual.
    q k^T and the softmax in fp32; plain matmuls."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = in_channels
        self.norm = GroupNorm32(c)
        self.q = Conv2d(c, c, 1)
        self.k = Conv2d(c, c, 1)
        self.v = Conv2d(c, c, 1)
        self.proj_out = Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        h_ = self.norm(x)
        q = self.q(h_).flatten(2).transpose(1, 2)        # (B, HW, C)
        k = self.k(h_).flatten(2)                        # (B, C, HW)
        v = self.v(h_).flatten(2).transpose(1, 2)
        attn = torch.matmul(q.float(), k.float()) * c ** -0.5
        attn = attn.softmax(-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out.contiguous(memory_format=CL))


class Downsample(nn.Module):
    """Stride-2 3x3 conv with the reference's (0,1,0,1) padding
    (vqgan_arch.py:117-126), as K2 or, without `use_kernels`, a plain pad
    and conv. In eval mode it keeps K2's kernel-layout weight and bias
    between calls (`kernel_operands`)."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.use_kernels = True
        self.conv = Conv2d(in_channels, in_channels, 3, stride=2, padding=0)
        self._operands = None    # (key, cv.ConvOperands)

    def kernel_operands(self):
        """cv.conv_operands of the conv's weight and bias, kept in eval
        mode (`kept_operands`); None in training mode."""
        w, b = self.conv.weight, self.conv.bias
        return kept_operands(self, (w, b), lambda: cv.conv_operands(w, b))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.use_kernels:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        ops = self.kernel_operands() if on_card(x) else None
        return nchw(cv.downsample_dots(nhwc(x), self.conv.weight,
                                       self.conv.bias, prepared=ops))


class Upsample(nn.Module):
    """Nearest x2 upsample, then a 3x3 conv (vqgan_arch.py:129-138). The
    JAX package evaluates the same function phase-collapsed."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode='nearest'))


class FuseSftBlock(nn.Module):
    """Controllable feature transformation (codeformer_arch.py:136-157):
    out = dec + w * (dec * scale(enc') + shift(enc')),
    enc' = ResBlock(cat(enc, dec))."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        c = out_channels
        self.encode_enc = ResBlock(2 * in_channels, c)
        self.scale = nn.Sequential(Conv2d(c, c, 3, padding=1),
                                   nn.LeakyReLU(0.2),
                                   Conv2d(c, c, 3, padding=1))
        self.shift = nn.Sequential(Conv2d(c, c, 3, padding=1),
                                   nn.LeakyReLU(0.2),
                                   Conv2d(c, c, 3, padding=1))

    def forward(self, enc_feat: torch.Tensor, dec_feat: torch.Tensor,
                w=1.0) -> torch.Tensor:
        enc = self.encode_enc(torch.cat([enc_feat, dec_feat], dim=1))
        scale = self.scale(enc)
        shift = self.shift(enc)
        w = torch.as_tensor(w, dtype=dec_feat.dtype, device=dec_feat.device)
        return dec_feat + w * (dec_feat * scale + shift)
