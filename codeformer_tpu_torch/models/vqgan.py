"""VQGAN backbone in PyTorch (counterpart of codeformer_tpu/models/vqgan.py).

The block order, and so every state-dict key, is the reference's
(vqgan_arch.py:229-323), so released checkpoints load unchanged. Tap
indices are computed at construction with the JAX package's rules.
VectorQuantizer's forward runs the nearest-code search K3
(ops/vq.py). Waiting for a later slice: GumbelQuantizer and
VQGANDiscriminator (stage I).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from codeformer_tpu_torch.nn import blocks as nb
from codeformer_tpu_torch.nn.blocks import (AttnBlock, Conv2d, Downsample,
                                            GroupNorm32, ResBlock, Upsample,
                                            decoder_tail)
from codeformer_tpu_torch.ops import conv3x3 as cv
from codeformer_tpu_torch.ops import vq
from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY


class VectorQuantizer(nn.Module):
    """Nearest-neighbour codebook (vqgan_arch.py:24-84):
    `embedding.weight` (K, D), commitment loss, straight-through."""

    def __init__(self, codebook_size: int, emb_dim: int, beta: float = 0.25):
        super().__init__()
        self.codebook_size, self.emb_dim, self.beta = (codebook_size,
                                                       emb_dim, beta)
        self.embedding = nn.Embedding(codebook_size, emb_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / codebook_size,
                         1.0 / codebook_size)

    def forward(self, z: torch.Tensor):
        """z: (B, D, h, w) latents. Returns (z_q, loss, stats) as the JAX
        VectorQuantizer (codeformer_tpu/models/vqgan.py:46-79): distances,
        loss and statistics in fp32; z_q straight-through (its gradient
        w.r.t. z is the identity), in z's dtype; loss = mse(sg[z_q], z) +
        beta * mse(z_q, sg[z]); stats perplexity, min_encoding_indices
        (B*h*w,) in row-major (h, w) order, mean_distance (the mean of the
        full (tokens, codes) squared-distance matrix, vqgan_arch.py:42)."""
        b, d, h, w = z.shape
        z32 = z.float()
        z_flat = z32.permute(0, 2, 3, 1).reshape(-1, d)
        codebook = self.embedding.weight
        # the parameter itself, so K3 finds its kept operands again
        indices = vq.nearest_code_indices(z_flat.detach().contiguous(),
                                          codebook)
        z_q = vq.codebook_lookup(indices, codebook, torch.float32)
        z_q = z_q.reshape(b, h, w, d).permute(0, 3, 1, 2)
        loss = (torch.mean((z_q.detach() - z32) ** 2)
                + self.beta * torch.mean((z_q - z32.detach()) ** 2))
        z_q = z32 + (z_q - z32).detach()
        e_mean = torch.bincount(indices, minlength=self.codebook_size) \
            .float() / indices.numel()
        perplexity = torch.exp(-torch.sum(e_mean * torch.log(e_mean + 1e-10)))
        # mean_j,t (z_t . e_j) = (sum_t z_t) . (sum_j e_j) / (T K): the
        # mean of the matrix without forming it
        e32 = codebook.float()
        mean_distance = (z_flat.square().sum(1).mean()
                         + e32.square().sum(1).mean()
                         - 2.0 * (z_flat.sum(0) @ e32.sum(0))
                         / (z_flat.shape[0] * e32.shape[0]))
        stats = {'perplexity': perplexity, 'min_encoding_indices': indices,
                 'mean_distance': mean_distance}
        return z_q.to(z.dtype), loss, stats

    def get_codebook_feat(self, indices: torch.Tensor,
                          shape: Optional[Sequence[int]] = None,
                          dtype=None) -> torch.Tensor:
        """indices (B*T,) or (B, T) -> codebook rows; with an NHWC `shape`
        (B, h, w, D), an NCHW map in channels_last memory (as
        vqgan_arch.py:72-84)."""
        z_q = vq.codebook_lookup(indices.reshape(-1), self.embedding.weight,
                                 dtype)
        if shape is not None:
            z_q = z_q.reshape(shape).permute(0, 3, 1, 2)
        return z_q


def _build_encoder_blocks(nf, emb_dim, ch_mult, num_res_blocks, resolution,
                          attn_resolutions):
    """Encoder blocks + {feature size: last-ResBlock index} taps, in the
    reference order (vqgan_arch.py:241-266)."""
    blocks = [Conv2d(3, nf, 3, padding=1)]
    taps: Dict[str, int] = {}
    curr_res = resolution
    in_ch_mult = (1,) + tuple(ch_mult)
    block_in = nf
    for i in range(len(ch_mult)):
        block_in = nf * in_ch_mult[i]
        block_out = nf * ch_mult[i]
        for _ in range(num_res_blocks):
            blocks.append(ResBlock(block_in, block_out))
            block_in = block_out
            taps[str(curr_res)] = len(blocks) - 1
            if curr_res in attn_resolutions:
                blocks.append(AttnBlock(block_in))
        if i != len(ch_mult) - 1:
            blocks.append(Downsample(block_in))
            curr_res //= 2
    blocks.append(ResBlock(block_in, block_in))
    blocks.append(AttnBlock(block_in))
    blocks.append(ResBlock(block_in, block_in))
    blocks.append(GroupNorm32(block_in))
    blocks.append(Conv2d(block_in, emb_dim, 3, padding=1))
    return blocks, taps


def _build_generator_blocks(nf, emb_dim, ch_mult, num_res_blocks, resolution,
                            attn_resolutions, out_channels):
    """Generator blocks + fuse taps (vqgan_arch.py:290-316): the first
    ResBlock of each stage, or the last one at attention resolutions
    (the reference's fuse table, codeformer_arch.py:206)."""
    num_resolutions = len(ch_mult)
    block_in = nf * ch_mult[-1]
    curr_res = resolution // 2 ** (num_resolutions - 1)
    blocks = [Conv2d(emb_dim, block_in, 3, padding=1),
              ResBlock(block_in, block_in), AttnBlock(block_in),
              ResBlock(block_in, block_in)]
    taps: Dict[str, int] = {}
    for i in reversed(range(num_resolutions)):
        block_out = nf * ch_mult[i]
        first_in_stage = True
        for _ in range(num_res_blocks):
            blocks.append(ResBlock(block_in, block_out))
            block_in = block_out
            if first_in_stage or curr_res in attn_resolutions:
                taps[str(curr_res)] = len(blocks) - 1
                first_in_stage = False
            if curr_res in attn_resolutions:
                blocks.append(AttnBlock(block_in))
        if i != 0:
            blocks.append(Upsample(block_in))
            curr_res *= 2
    blocks.append(GroupNorm32(block_in))
    blocks.append(Conv2d(block_in, out_channels, 3, padding=1))
    return blocks, taps


class Encoder(nn.Module):
    """Image (B, 3, H, W) -> latents (B, emb_dim, h, w), plus the outputs
    of the tapped blocks by feature size (vqgan_arch.py:229-273)."""

    def __init__(self, nf=64, emb_dim=256, ch_mult=(1, 2, 2, 4, 4, 8),
                 num_res_blocks=2, resolution=512, attn_resolutions=(16,)):
        super().__init__()
        blocks, self.tap_by_size = _build_encoder_blocks(
            nf, emb_dim, tuple(ch_mult), num_res_blocks, resolution,
            tuple(attn_resolutions))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, tap_indices: Sequence[int] = ()
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        feats = {}
        taps = set(tap_indices)
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in taps:
                feats[str(x.shape[2])] = x
        return x, feats


class Generator(nn.Module):
    """Latents -> image (vqgan_arch.py:276-323). `fuse_fns` maps a block
    index to a callable applied to that block's output (CodeFormer's
    SFT fusion). With `use_kernels` the final GroupNorm + conv_out run as
    one K1 call, whose operands it keeps in eval mode
    (`kernel_operands`)."""

    def __init__(self, nf=64, emb_dim=256, ch_mult=(1, 2, 2, 4, 4, 8),
                 num_res_blocks=2, resolution=512, attn_resolutions=(16,),
                 out_channels=3):
        super().__init__()
        self.use_kernels = True
        blocks, self.tap_by_size = _build_generator_blocks(
            nf, emb_dim, tuple(ch_mult), num_res_blocks, resolution,
            tuple(attn_resolutions), out_channels)
        self.blocks = nn.ModuleList(blocks)
        self._operands = None    # (key, the tail's cv.DotsOperands)

    def kernel_operands(self):
        """The tail conv's cv.dots_operands, kept in eval mode
        (`kept_operands`); None in training mode."""
        conv = self.blocks[-1]
        return nb.kept_operands(
            self, (conv.weight, conv.bias),
            lambda: cv.dots_operands(conv.weight, conv.bias))

    def forward(self, x: torch.Tensor,
                fuse_fns: Optional[Dict[int, Callable]] = None
                ) -> torch.Tensor:
        fuse_fns = fuse_fns or {}
        n = len(self.blocks)
        for i in range(n - 2):
            x = self.blocks[i](x)
            if i in fuse_fns:
                x = fuse_fns[i](x)
        kept = self.kernel_operands() \
            if self.use_kernels and nb.on_card(x) else None
        return decoder_tail(self.blocks[n - 2], self.blocks[n - 1], x,
                            self.use_kernels, prepared=kept)


@ARCH_REGISTRY.register()
class VQAutoEncoder(nn.Module):
    """The VQGAN backbone: encoder, codebook, generator
    (vqgan_arch.py:326-389), with the 'nearest' quantizer. The Gumbel
    quantizer waits for stage I (ROADMAP.md Queue 1 item 4.1)."""

    def __init__(self, img_size=512, nf=64, ch_mult=(1, 2, 2, 4, 4, 8),
                 res_blocks=2, attn_resolutions=(16,), codebook_size=1024,
                 emb_dim=256, quantizer: str = 'nearest'):
        super().__init__()
        if quantizer != 'nearest':
            raise NotImplementedError(
                f'quantizer {quantizer!r} is not ported yet (GumbelQuantizer, '
                f'ROADMAP.md Queue 1 item 4.1)')
        self.ch_mult, self.emb_dim = tuple(ch_mult), emb_dim
        self.encoder = Encoder(nf, emb_dim, ch_mult, res_blocks, img_size,
                               attn_resolutions)
        self.quantize = VectorQuantizer(codebook_size, emb_dim)
        self.generator = Generator(nf, emb_dim, ch_mult, res_blocks,
                                   img_size, attn_resolutions)

    def forward(self, x: torch.Tensor):
        """Encode -> quantize -> decode (codeformer_tpu/models/vqgan.py:
        359-363): (reconstruction, codebook_loss, quantizer stats)."""
        x, _ = self.encoder(x)
        quant, codebook_loss, quant_stats = self.quantize(x)
        return self.generator(quant), codebook_loss, quant_stats
