"""Plain CodeFormer in PyTorch, float32: the benchmark's reference.

A frozen copy of the released network (sczhou/CodeFormer
basicsr/archs/codeformer_arch.py and vqgan_arch.py) in textbook form:
GroupNorm -> SiLU -> 3x3 conv, nearest x2 upsampling, single-head
spatial attention, pre-LN transformer with exact GELU, SFT fusion, AdaIN.
No kernels, no kept operands, no batching logic, no int8; every parameter
and every activation float32. Parameter names are the reference `.pth`
names, so one state dict loads into this module and into the program.

`forward(x, w, adain, codes=None)` returns (image, logits, lq_feat);
given `codes` (B, tokens) the generator looks those codebook rows up in
place of the logits' argmax, so the comparison can follow the program's
own code choice and judge that choice apart (benchmark/compare.py).

Run it with TF32 off (`fp32_math`): on an H100 float32 convolutions and
matmuls otherwise run in TF32.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


@contextlib.contextmanager
def fp32_math():
    """IEEE float32 convolutions and matmuls inside; the flags restored
    after."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=1e-6)


class ResBlock(nn.Module):
    """vqgan_arch.py:141-164."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.cin, self.cout = cin, cout
        self.norm1 = norm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = norm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_out = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return h + (self.conv_out(x) if self.cin != self.cout else x)


class AttnBlock(nn.Module):
    """vqgan_arch.py:167-226."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = norm(c)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)
        q = self.q(hn).reshape(b, c, h * w).permute(0, 2, 1)
        k = self.k(hn).reshape(b, c, h * w)
        v = self.v(hn).reshape(b, c, h * w)
        attn = torch.softmax(torch.bmm(q, k) * c ** -0.5, dim=2)
        out = torch.bmm(v, attn.permute(0, 2, 1)).reshape(b, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """vqgan_arch.py:117-126: pad (0, 1, 0, 1), stride-2 3x3 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """vqgan_arch.py:129-138: nearest x2, then a 3x3 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode='nearest'))


def encoder_blocks(nf, emb_dim, ch_mult, res_blocks, resolution, attn_res):
    """Encoder blocks and {feature size: index of the last ResBlock at that
    size} (vqgan_arch.py:229-273)."""
    blocks = [nn.Conv2d(3, nf, 3, padding=1)]
    taps: Dict[str, int] = {}
    res = resolution
    in_mult = (1,) + tuple(ch_mult)
    cin = nf
    for i, mult in enumerate(ch_mult):
        cin = nf * in_mult[i]
        cout = nf * mult
        for _ in range(res_blocks):
            blocks.append(ResBlock(cin, cout))
            cin = cout
            taps[str(res)] = len(blocks) - 1
            if res in attn_res:
                blocks.append(AttnBlock(cin))
        if i != len(ch_mult) - 1:
            blocks.append(Downsample(cin))
            res //= 2
    blocks += [ResBlock(cin, cin), AttnBlock(cin), ResBlock(cin, cin),
               norm(cin), nn.Conv2d(cin, emb_dim, 3, padding=1)]
    return blocks, taps


def generator_blocks(nf, emb_dim, ch_mult, res_blocks, resolution,
                     attn_res):
    """Generator blocks and the fuse taps: the first ResBlock of each
    stage, or the last at attention resolutions (vqgan_arch.py:276-323,
    codeformer_arch.py:206)."""
    cin = nf * ch_mult[-1]
    res = resolution // 2 ** (len(ch_mult) - 1)
    blocks = [nn.Conv2d(emb_dim, cin, 3, padding=1), ResBlock(cin, cin),
              AttnBlock(cin), ResBlock(cin, cin)]
    taps: Dict[str, int] = {}
    for i in reversed(range(len(ch_mult))):
        cout = nf * ch_mult[i]
        first = True
        for _ in range(res_blocks):
            blocks.append(ResBlock(cin, cout))
            cin = cout
            if first or res in attn_res:
                taps[str(res)] = len(blocks) - 1
                first = False
            if res in attn_res:
                blocks.append(AttnBlock(cin))
        if i != 0:
            blocks.append(Upsample(cin))
            res *= 2
    blocks += [norm(cin), nn.Conv2d(cin, 3, 3, padding=1)]
    return blocks, taps


class Coder(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class Quantize(nn.Module):
    def __init__(self, k: int, d: int):
        super().__init__()
        self.embedding = nn.Embedding(k, d)


class SelfAttention(nn.Module):
    """torch.nn.MultiheadAttention's math, q and k from one input, v from
    another (codeformer_arch.py:99-134 adds the position to q, k only)."""

    def __init__(self, e: int, heads: int):
        super().__init__()
        self.e, self.heads = e, heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * e, e))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * e))
        self.out_proj = nn.Linear(e, e)

    def forward(self, qk_in, v_in):
        b, s, e = qk_in.shape
        h, d = self.heads, e // self.heads
        wq, wk, wv = self.in_proj_weight.split(e)
        bq, bk, bv = self.in_proj_bias.split(e)

        def heads(t):
            return t.reshape(b, s, h, d).transpose(1, 2)
        q = heads(F.linear(qk_in, wq, bq)) * d ** -0.5
        k = heads(F.linear(qk_in, wk, bk))
        v = heads(F.linear(v_in, wv, bv))
        attn = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(b, s, e))


class TransformerLayer(nn.Module):
    """Pre-LN: x + MHA(LN x), then x + MLP(LN x), exact GELU."""

    def __init__(self, e: int, heads: int, mlp: int):
        super().__init__()
        self.self_attn = SelfAttention(e, heads)
        self.linear1 = nn.Linear(e, mlp)
        self.linear2 = nn.Linear(mlp, e)
        self.norm1 = nn.LayerNorm(e, eps=1e-5)
        self.norm2 = nn.LayerNorm(e, eps=1e-5)

    def forward(self, x, pos):
        h = self.norm1(x)
        x = x + self.self_attn(h + pos, h)
        return x + self.linear2(F.gelu(self.linear1(self.norm2(x))))


class FuseSft(nn.Module):
    """codeformer_arch.py:136-157: dec + w * (dec * scale + shift) of
    ResBlock(cat(enc, dec))."""

    def __init__(self, c: int):
        super().__init__()
        self.encode_enc = ResBlock(2 * c, c)

        def branch():
            return nn.Sequential(nn.Conv2d(c, c, 3, padding=1),
                                 nn.LeakyReLU(0.2),
                                 nn.Conv2d(c, c, 3, padding=1))
        self.scale = branch()
        self.shift = branch()

    def forward(self, enc, dec, w):
        e = self.encode_enc(torch.cat([enc, dec], dim=1))
        return dec + w * (dec * self.scale(e) + self.shift(e))


def mean_std(f, eps=1e-5):
    """Per-sample, per-channel mean and std, unbiased variance
    (codeformer_arch.py:12-26)."""
    b, c = f.shape[:2]
    flat = f.reshape(b, c, -1)
    var = flat.var(dim=2) + eps
    return flat.mean(2).reshape(b, c, 1, 1), var.sqrt().reshape(b, c, 1, 1)


def adain(content, style):
    """codeformer_arch.py:29-43."""
    s_mean, s_std = mean_std(style)
    c_mean, c_std = mean_std(content)
    return (content - c_mean) / c_std * s_std + s_mean


class CodeFormer(nn.Module):
    """codeformer_arch.py:160-280 with the VQGAN backbone's fixed
    arguments as parameters (the released net: img_size 512, nf 64,
    ch_mult 1,2,2,4,4,8, 2 res blocks, attention at 16, emb_dim 256)."""

    def __init__(self, dim_embd=512, n_head=8, n_layers=9,
                 codebook_size=1024, latent_size=256,
                 connect_list: Sequence[str] = ('32', '64', '128', '256'),
                 img_size=512, nf=64, ch_mult=(1, 2, 2, 4, 4, 8),
                 res_blocks=2, attn_resolutions=(16,), emb_dim=256):
        super().__init__()
        ch_mult, attn = tuple(ch_mult), tuple(attn_resolutions)
        self.emb_dim = emb_dim
        self.connect_list = tuple(str(c) for c in connect_list)
        enc, self.enc_taps = encoder_blocks(nf, emb_dim, ch_mult, res_blocks,
                                            img_size, attn)
        gen, self.gen_taps = generator_blocks(nf, emb_dim, ch_mult,
                                              res_blocks, img_size, attn)
        self.encoder = Coder(enc)
        self.generator = Coder(gen)
        self.quantize = Quantize(codebook_size, emb_dim)
        self.position_emb = nn.Parameter(torch.empty(latent_size, dim_embd))
        self.feat_emb = nn.Linear(emb_dim, dim_embd)
        self.ft_layers = nn.ModuleList(
            TransformerLayer(dim_embd, n_head, 2 * dim_embd)
            for _ in range(n_layers))
        self.idx_pred_layer = nn.Sequential(
            nn.LayerNorm(dim_embd, eps=1e-5),
            nn.Linear(dim_embd, codebook_size, bias=False))
        chans = {str(img_size // 2 ** s): nf * ch_mult[min(s, len(ch_mult) - 1)]
                 for s in range(len(ch_mult))}
        self.fuse_convs_dict = nn.ModuleDict(
            {f: FuseSft(chans[f]) for f in self.connect_list})

    def encode(self, x):
        """x (B, 3, H, W) in [-1, 1] -> (logits (B, S, K), lq_feat,
        encoder taps by size)."""
        feats = {}
        tap_at = {self.enc_taps[s]: s for s in self.connect_list}
        for i, blk in enumerate(self.encoder.blocks):
            x = blk(x)
            if i in tap_at:
                feats[tap_at[i]] = x
        lq_feat = x
        q = self.feat_emb(lq_feat.flatten(2).transpose(1, 2))
        for layer in self.ft_layers:
            q = layer(q, self.position_emb[None])
        return self.idx_pred_layer(q), lq_feat, feats

    def decode(self, codes, lq_feat, feats, w, use_adain=True):
        """codes (B, S) -> image (B, 3, H, W): codebook rows, AdaIN to the
        encoder's statistics, the generator with SFT fusion at w > 0."""
        b, _, h, wd = lq_feat.shape
        z = self.quantize.embedding.weight[codes.reshape(-1)]
        z = z.reshape(b, h, wd, self.emb_dim).permute(0, 3, 1, 2)
        if use_adain:
            z = adain(z, lq_feat)
        fuse_at = {self.gen_taps[s]: s for s in self.connect_list} \
            if w > 0 else {}
        x = z
        for i, blk in enumerate(self.generator.blocks):
            x = blk(x)
            if i in fuse_at:
                s = fuse_at[i]
                x = self.fuse_convs_dict[s](feats[s], x, w)
        return x

    def forward(self, x, w=0.5, use_adain=True, codes=None):
        logits, lq_feat, feats = self.encode(x)
        if codes is None:
            codes = logits.argmax(-1)
        return self.decode(codes, lq_feat, feats, w, use_adain), logits, \
            lq_feat


def to_unit(faces_rgb_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (B, H, W, 3) -> float32 (B, 3, H, W) in [-1, 1]."""
    return faces_rgb_u8.permute(0, 3, 1, 2).float() / 127.5 - 1.0


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) in [-1, 1] -> uint8 RGB (B, H, W, 3): clip, then round
    half to even (the released CLI's tensor2img rounds the same way)."""
    y = torch.round((img.clamp(-1.0, 1.0) + 1.0) * 127.5)
    return y.to(torch.uint8).permute(0, 2, 3, 1)
