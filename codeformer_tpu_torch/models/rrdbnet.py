"""RRDBNet, the Real-ESRGAN generator, counterpart of
codeformer_tpu/models/rrdbnet.py (the reference's
basicsr/archs/rrdbnet_arch.py): a pixel-unshuffled input for scale 1 and
2, `num_block` RRDBs (three dense blocks each, residuals scaled by 0.2),
and two nearest-x2 upsampling convs.

NCHW; module names are the reference `.pth` names (`conv_first`,
`body.{i}.rdb{1,2,3}.conv{1..5}`, `conv_body`, `conv_up1/2`, `conv_hr`,
`conv_last`), so `RealESRGAN_x2plus.pth` and `flax_to_state_dict` of the
JAX variables load strictly. The convs are cuDNN's, as JAX runs them on
XLA's convs and not in a Pallas kernel, except the trunk's in inference:
for a CUDA bf16 input with autograd off, the 23 RRDBs and `conv_body`'s
residual run on the Hopper conv core (`ops/conv3x3.py conv3x3_dense`)
over three 192-channel workspaces, with no concatenation (`_dense_trunk`);
everything else (the CPU, fp32, training) runs the modules below.
`conv_up1/2` compute the JAX package's fused nearest-x2 + 3x3 conv
(`PhaseCollapsedUpConv`); its plain version, `up_conv_ref`, stays for the
tests.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from codeformer_tpu_torch.ops import conv3x3 as cv
from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY


def pixel_unshuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C*s*s, H/s, W/s), out channel c*s*s + sh*s +
    sw (basicsr/archs/arch_util.py:190-207)."""
    return F.pixel_unshuffle(x, scale)


# tap index -> 2-tap window slot, per output phase (0: window {-1, 0},
# 1: window {0, +1}) under nearest x2
_MAP = {0: (0, 1, 1), 1: (0, 0, 1)}


def phase_kernels(weight: torch.Tensor) -> list:
    """A 3x3 conv weight (O, I, 3, 3) -> the four 2x2 kernels of the
    output phases (p, q) in (0,0), (0,1), (1,0), (1,1) order: under
    nearest x2 the nine taps of phase (p, q) fall on at most 2x2 source
    pixels, and the taps on one pixel sum."""
    out = []
    for p in (0, 1):
        for q in (0, 1):
            k2 = weight.new_zeros(weight.shape[:2] + (2, 2))
            for u in range(3):
                for v in range(3):
                    k2[:, :, _MAP[p][u], _MAP[q][v]] += weight[:, :, u, v]
            out.append(k2)
    return out


class PhaseCollapsedUpConv(nn.Conv2d):
    """Nearest x2 upsample then a 3x3 SAME conv, computed as the JAX
    package's `_PhaseCollapsedUpConv` (nn/blocks.py:477-523): four 2x2
    convs on the low-resolution map, phase (p, q) padded
    ((1-p, p), (1-q, q)), interleaved into the 2x map. 4/9 of the plain
    version's products, and the 4x upsampled map never exists. The
    parameters are those of nn.Conv2d(C, C, 3, padding=1)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for (p, q), k2 in zip(((0, 0), (0, 1), (1, 0), (1, 1)),
                              phase_kernels(self.weight)):
            outs.append(F.conv2d(F.pad(x, (1 - q, q, 1 - p, p)), k2))
        y = torch.stack(outs, dim=2)          # (B, C, 4, h, w), (p, q)
        y = F.pixel_shuffle(y.flatten(1, 2), 2)
        return y + self.bias.view(1, -1, 1, 1)


def up_conv_ref(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """The plain version: nearest x2, then the 3x3 conv (the reference's
    F.interpolate(scale_factor=2) + conv_up, rrdbnet_arch.py:114-115)."""
    return F.conv2d(F.interpolate(x, scale_factor=2, mode='nearest'),
                    weight, bias, padding=1)


class ResidualDenseBlock(nn.Module):
    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        for i in range(4):
            setattr(self, f'conv{i + 1}',
                    nn.Conv2d(num_feat + i * num_grow_ch, num_grow_ch, 3,
                              padding=1))
        self.conv5 = nn.Conv2d(num_feat + 4 * num_grow_ch, num_feat, 3,
                               padding=1)

    def forward(self, x):
        feats = [x]
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            feats.append(F.leaky_relu(conv(torch.cat(feats, 1)), 0.2))
        return self.conv5(torch.cat(feats, 1)) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, num_feat: int, num_grow_ch: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


@ARCH_REGISTRY.register()
class RRDBNet(nn.Module):
    """x: (B, num_in_ch, H, W) in [0, 1] (H, W even for scale 2, multiples
    of 4 for scale 1) -> (B, num_out_ch, H*scale, W*scale)."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 scale: int = 4, num_feat: int = 64, num_block: int = 23,
                 num_grow_ch: int = 32):
        super().__init__()
        self.scale = scale
        cin = num_in_ch * {1: 16, 2: 4}.get(scale, 1)
        self.conv_first = nn.Conv2d(cin, num_feat, 3, padding=1)
        self.body = nn.Sequential(*[RRDB(num_feat, num_grow_ch)
                                    for _ in range(num_block)])
        self.conv_body = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv_up1 = PhaseCollapsedUpConv(num_feat, num_feat)
        self.conv_up2 = PhaseCollapsedUpConv(num_feat, num_feat)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, padding=1)
        self.num_feat, self.num_grow_ch = num_feat, num_grow_ch
        self.dense_calls = 0      # forwards whose trunk ran _dense_trunk
        self._dense_ops = None    # (key, the trunk's kept ConvOperands)

    def uses_dense_trunk(self, feat) -> bool:
        """Whether the trunk runs on the Hopper conv core for `feat`, by
        what it can observe: a CUDA bf16 map with autograd off
        (inference_mode or no_grad), and widths the kernel takes."""
        return (feat.device.type == 'cuda' and feat.dtype == torch.bfloat16
                and not torch.is_grad_enabled()
                and self.num_feat % cv.CHUNK == 0
                and self.num_grow_ch % cv.CHUNK == 0)

    def _trunk_convs(self) -> list:
        """The trunk's convs in launch order: conv1-5 of each dense
        block, then conv_body."""
        return [getattr(rdb, f'conv{k}') for rrdb in self.body
                for rdb in (rrdb.rdb1, rrdb.rdb2, rrdb.rdb3)
                for k in range(1, 6)] + [self.conv_body]

    def dense_operands(self) -> list:
        """The trunk's convs in the core's layout (conv_operands), made
        once and kept until a weight or bias is updated in place,
        replaced, moved or cast."""
        convs = self._trunk_convs()
        key = tuple((t._version, t.data_ptr(), t.device, t.dtype)
                    for c in convs for t in (c.weight, c.bias))
        if self._dense_ops is None or self._dense_ops[0] != key:
            self._dense_ops = (key, [cv.conv_operands(c.weight, c.bias)
                                     for c in convs])
        return self._dense_ops[1]

    def _dense_trunk(self, feat: torch.Tensor) -> torch.Tensor:
        """feat + conv_body(body(feat)) with conv3x3_dense over three
        NHWC workspaces of num_feat + 4 * num_grow_ch channels, a, b and c.
        An RRDB's input sits in a[..., :nf]; a dense block's conv_k reads
        its buffer's first nf + g(k-1) channels and writes the next g
        (LeakyReLU in its epilogue); its conv5 writes 0.2 y + x into the
        first nf channels of the next buffer: rdb1's into b, rdb2's into
        c, and rdb3's, which adds the RRDB's residual too, into a[..., :nf]
        over the RRDB's input, each element after reading it. No conv
        reads a channel it writes. feat (B, nf, H, W) -> the same shape,
        channels-last."""
        nf, g = self.num_feat, self.num_grow_ch
        f = feat.permute(0, 2, 3, 1)
        if not f.is_contiguous():
            f = f.contiguous()
        bsz, h, w, _ = f.shape
        a, b, c = (f.new_empty((bsz, h, w, nf + 4 * g)) for _ in range(3))
        a[..., :nf].copy_(f)
        ops = iter(self.dense_operands())
        convs = iter(self._trunk_convs())

        def conv(src, cin, out, epi, s1=None, s2=None):
            m = next(convs)
            cv.conv3x3_dense(src[..., :cin], m.weight, m.bias, out, epi, s1,
                             s2, prepared=next(ops))

        for _ in self.body:
            for src, dst, last in ((a, b, False), (b, c, False),
                                   (c, a, True)):
                for k in range(4):
                    cin = nf + k * g
                    conv(src, cin, src[..., cin:cin + g], 'lrelu')
                if last:
                    conv(src, nf + 4 * g, a[..., :nf], 'rrdb', src[..., :nf],
                         a[..., :nf])
                else:
                    conv(src, nf + 4 * g, dst[..., :nf], 'res', src[..., :nf])
        out = torch.empty_like(f)
        conv(a, nf, out, 'add', f)
        self.dense_calls += 1
        return out.permute(0, 3, 1, 2)

    def forward(self, x):
        if self.scale == 2:
            x = pixel_unshuffle(x, 2)
        elif self.scale == 1:
            x = pixel_unshuffle(x, 4)
        feat = self.conv_first(x)
        if self.uses_dense_trunk(feat):
            feat = self._dense_trunk(feat)
        else:
            feat = feat + self.conv_body(self.body(feat))
        feat = F.leaky_relu(self.conv_up1(feat), 0.2)
        feat = F.leaky_relu(self.conv_up2(feat), 0.2)
        return self.conv_last(F.leaky_relu(self.conv_hr(feat), 0.2))
