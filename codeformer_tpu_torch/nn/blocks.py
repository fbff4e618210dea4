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

`set_quant(model, 'int8')` switches a model to JAX's int8 serving path
(nn/quant.py) on exactly the convs the JAX package quantizes: both 3x3
convs of every ResBlock (the SFT blocks' too), the Downsample conv, the
encoder's conv_in and the generator's conv_out (`QConv2d`), and the
Upsample as four phase-collapsed 2x2 convs on one quantized input. It
turns the kernels off on those modules: they run GroupNorm -> SiLU ->
int8 conv -> bias (+ skip). Attention, the transformer, every 1x1 conv,
the encoder's last and the generator's first 3x3 conv and the SFT
scale/shift convs stay in the compute dtype.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from codeformer_tpu_torch.nn import quant
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
        xf = x.float()
        if (not xf.is_cuda and torch.is_grad_enabled()
                and self.weight.requires_grad and not xf.requires_grad):
            # torch's CPU group_norm backward crashes (SIGSEGV, torch
            # 2.13) on a channels_last input that takes no gradient while
            # the affine parameters do: the SFT blocks' first GroupNorm
            # in stage III, whose input is the frozen generator's map
            xf = xf.contiguous()
        y = F.group_norm(xf, self.num_groups, self.weight, self.bias,
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


def records(module: nn.Module, *inputs: torch.Tensor) -> bool:
    """Whether autograd records a call of `module` on `inputs`: grad mode
    on, and an input or a parameter that requires a gradient."""
    return torch.is_grad_enabled() and (
        any(x.requires_grad for x in inputs)
        or any(p.requires_grad for p in module.parameters()))


def on_card(x: torch.Tensor) -> bool:
    """Whether x runs the kernels (a CUDA tensor): there the modules hand
    them their kept operands."""
    return x.is_cuda


def kept_operands(mod: nn.Module, params, make, extra=()):
    """`make()` kept on `mod._operands` between calls in eval mode, made
    again when a tensor of `params` is updated in place (`_version`),
    replaced, moved or cast, or when `extra` (e.g. the compute dtype)
    changes; None in training mode, where nothing is kept."""
    if mod.training:
        mod._operands = None
        return None
    key = tuple(cv.operand_key(t) for t in params) + tuple(extra)
    if mod._operands is None or mod._operands[0] != key:
        with torch.no_grad():
            mod._operands = (key, make())
    return mod._operands[1]


def refuse_int8_autograd(module: nn.Module, x: torch.Tensor) -> None:
    """The int8 round has no gradient: a quantized module refuses to run
    where autograd records (JAX's training entry point forces the mode
    off the same way)."""
    if records(module, x):
        raise RuntimeError(
            f'{type(module).__name__} is set to int8 serving: it has no '
            f'gradient (set_quant(model, "off") before training)')


class QConv2d(Conv2d):
    """Conv2d with JAX's int8 serving path (FastConv3x3, _QuantizableConv):
    with `quant == 'int8'` the weight, cast to the input's dtype, and the
    input are quantized (nn/quant.py), their exact int32 product is
    dequantized to the input's dtype and the bias added in it. The int8
    weight and its scales are kept between calls in eval mode. Its
    parameters are Conv2d's (the reference `.pth` names)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = 'off'
        self._operands = None    # (key, quant.Int8Weight)

    def int8_weight(self, dtype: torch.dtype) -> quant.Int8Weight:
        w = self.weight

        def make():
            return quant.prepare_weight(w.detach().to(dtype))
        return kept_operands(self, (w,), make, (dtype,)) or make()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant != 'int8':
            return super().forward(x)
        refuse_int8_autograd(self, x)
        xq, sx = quant.quantize_act(nhwc(x))
        wt = self.int8_weight(x.dtype)
        (ph, pw), (s, _) = self.padding, self.stride
        y = quant.dequantize(quant.int8_conv(xq, wt, s, (ph, ph, pw, pw)),
                             sx, wt.scale, x.dtype)
        return nchw(y + self.bias.to(x.dtype))


class ResBlock(nn.Module):
    """GroupNorm -> SiLU -> 3x3 conv, twice, plus the (projected) skip
    (vqgan_arch.py:141-164). With `use_kernels`, two K1 calls:

      1. entry stats (fp32 sums) -> gn_affine -> K1(silu) = y1 + its stats
      2. gn_affine(y1 stats) -> K1(silu, skip = x_in or x_in @ conv_out)

    The projected skip multiplies the RAW block input; conv_out's bias is
    folded into conv2's. In eval mode the block keeps both calls'
    operands (`kernel_operands`). Without, the textbook form of JAX
    ResBlock._forward (codeformer_tpu/nn/blocks.py:127-137). With `remat`
    (training: `train: remat: true`), the textbook form saves only the
    block's input for the backward and recomputes its interior there
    (torch.utils.checkpoint, JAX's nn.remat of the same function), where
    autograd records; elsewhere, and on the kernels' path, it changes
    nothing.
    """

    def __init__(self, in_channels: int, out_channels: int | None = None,
                 remat: bool = False):
        super().__init__()
        self.use_kernels = True
        self.remat = remat
        out_ch = out_channels or in_channels
        self.in_channels, self.out_channels = in_channels, out_ch
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = QConv2d(in_channels, out_ch, 3, padding=1)
        self.norm2 = GroupNorm32(out_ch)
        self.conv2 = QConv2d(out_ch, out_ch, 3, padding=1)
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

    def _textbook(self, x_in: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x_in)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.in_channels != self.out_channels:
            x_in = self.conv_out(x_in)
        return h + x_in

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        if not self.use_kernels:
            if self.remat and records(self, x_in):
                return checkpoint(self._textbook, x_in, use_reentrant=False)
            return self._textbook(x_in)
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
        self.conv = QConv2d(in_channels, in_channels, 3, stride=2,
                            padding=0)
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


# tap index -> slot of the 2-tap window of each output phase under
# nearest x2 (phase 0: window {-1, 0}; phase 1: {0, +1}); JAX's
# _PhaseCollapsedUpConv._MAP
PHASE_MAP = {0: (0, 1, 1), 1: (0, 0, 1)}


def phase_kernels(w: torch.Tensor) -> list:
    """The four 2x2 kernels (p, q order) that a 3x3 OIHW weight collapses
    to under nearest x2: the nine taps of phase (p, q) fall on at most
    2x2 source pixels, and the taps on one pixel sum, tap by tap in w's
    dtype in the loop order of codeformer_tpu/nn/blocks.py:500-507 (every
    sum rounded to that dtype, as JAX's). Autograd records through it
    (RRDBNet's `PhaseCollapsedUpConv` trains on it)."""
    out = []
    for p in (0, 1):
        for q in (0, 1):
            k2 = w.new_zeros(w.shape[0], w.shape[1], 2, 2)
            for u in range(3):
                for v in range(3):
                    k2[:, :, PHASE_MAP[p][u], PHASE_MAP[q][v]] += w[:, :, u, v]
            out.append(k2)
    return out


class Upsample(nn.Module):
    """Nearest x2 upsample, then a 3x3 conv (vqgan_arch.py:129-138). The
    JAX package evaluates the same function phase-collapsed; the int8
    path does too (`quant == 'int8'`): the input is quantized once and
    each output phase (p, q) is an int8 2x2 conv with its own per-channel
    weight scales and pads ((1-p, p), (1-q, q)), the four interleaved
    and the bias added in the input's dtype. The phases' int8 weights
    are kept between calls in eval mode."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, padding=1)
        self.quant = 'off'
        self._operands = None    # (key, [quant.Int8Weight] * 4)

    def int8_weights(self, dtype: torch.dtype):
        w = self.conv.weight

        def make():
            return [quant.prepare_weight(k)
                    for k in phase_kernels(w.detach().to(dtype))]
        return kept_operands(self, (w,), make, (dtype,)) or make()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant != 'int8':
            return self.conv(F.interpolate(x, scale_factor=2.0,
                                           mode='nearest'))
        refuse_int8_autograd(self, x)
        b, _, h, w = x.shape
        c = self.conv.out_channels
        xq, sx = quant.quantize_act(nhwc(x))
        wts = self.int8_weights(x.dtype)
        ys = [quant.dequantize(quant.int8_conv(
                  xq, wts[2 * p + q], 1, (1 - p, p, 1 - q, q)),
                  sx, wts[2 * p + q].scale, x.dtype)
              for p in (0, 1) for q in (0, 1)]
        y = torch.stack(ys, dim=3).reshape(b, h, w, 2, 2, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c)
        return nchw(y + self.conv.bias.to(x.dtype))


def set_quant(model: nn.Module, mode: str) -> nn.Module:
    """Set the int8 serving mode ('int8' or 'off') on every quantizable
    module of `model` (QConv2d, Upsample). 'int8' also turns the kernels
    off (`set_kernels(model, False)`): the quantized blocks run their
    textbook form. 'off' leaves the kernel switch as it is. Returns
    model."""
    if mode not in quant.MODES:
        raise ValueError(f'quant mode must be one of {quant.MODES}, got '
                         f'{mode!r}')
    for mod in model.modules():
        if isinstance(mod, (QConv2d, Upsample)):
            mod.quant = mode
    if mode == 'int8':
        set_kernels(model, False)
    return model


class FuseSftBlock(nn.Module):
    """Controllable feature transformation (codeformer_arch.py:136-157):
    out = dec + w * (dec * scale(enc') + shift(enc')),
    enc' = ResBlock(cat(enc, dec))."""

    def __init__(self, in_channels: int, out_channels: int,
                 remat: bool = False):
        super().__init__()
        c = out_channels
        self.encode_enc = ResBlock(2 * in_channels, c, remat)
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
        # w rounded to the map's dtype, as a Python scalar: the product
        # rounds as with a tensor of w, without a copy to the device
        w = float(torch.tensor(w, dtype=dec_feat.dtype))
        return dec_feat + w * (dec_feat * scale + shift)
